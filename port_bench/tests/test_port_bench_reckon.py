"""The yardstick's arithmetic against hand-counted shapes, and the
end-to-end metrics over a synthetic record and a scripted engine: the
window's edges, the tokens in flight at each edge, the percentiles."""

import pytest

from port_bench import profiling, reckon, spec, stats
from port_bench.harness import Record, e2e
from port_bench.loop import Admission, ClosedLoop, Completion, Dispatch
from port_bench.traffic import Traffic

MISTRAL = spec.model_shape(spec.read_json(spec.PKG / "configs" / "mistral-7b-v0.3-int8.json"))
MIXTRAL = spec.model_shape(spec.read_json(spec.PKG / "configs" / "mixtral-8x7b-v0.1-int8.json"))


def test_weights_a_token_touches():
    attn = 4096 * 4096 * 2 + 1024 * 4096 * 2
    ffn = 3 * 4096 * 14336
    assert reckon.layer_params_touched(MISTRAL) == attn + ffn == 218_103_808
    assert reckon.layer_params_touched(MIXTRAL) == attn + 2 * ffn + 8 * 4096 == 394_297_344


def test_model_flops():
    per_token = 2 * (32 * 218_103_808 + 32768 * 4096)
    assert reckon.decode_flops(MISTRAL, 10, 0) == pytest.approx(10 * per_token)
    # 3 tokens behind 5 cached: keys 6 + 7 + 8 = 21 pairs, 4 H hd L flops each
    att = 4 * 32 * 128 * 32 * 21
    assert reckon.prefill_flops(MISTRAL, 3, 5) == pytest.approx(
        2 * 32 * 218_103_808 * 3 + 2 * 32768 * 4096 + att)


def test_int8_matmul_calls_follow_the_row_rule():
    # decode at 256 rows: 7 products x 32 layers + the lm_head, all on the kernel
    calls = reckon.decode_matmul_calls(MISTRAL, 256, 0.0)
    assert len(calls) == 225 and all(m == 256 for m, _, _ in calls)
    # a 512-row prefill: every product dequantized; only the lm_head's last row
    assert reckon.prefill_matmul_calls(MISTRAL, 512, 0.0) == [(1, 32768, 4096)]
    # Mixtral decode at 64 slots: 4 x 32 attention, 3 x 8 x 32 experts of 64 rows, lm_head
    calls = reckon.decode_matmul_calls(MIXTRAL, 64, 4.0)
    assert len(calls) == 128 + 768 + 1
    # a 128-row Mixtral prefill: capacity int(4 * 128 * 2 / 8) = 128 rows an expert
    calls = reckon.prefill_matmul_calls(MIXTRAL, 128, 4.0)
    assert len(calls) == 897 and calls.count((128, 14336, 4096)) == 2 * 8 * 32
    assert len(reckon.prefill_matmul_calls(MIXTRAL, 512, 4.0)) == 1


def test_kernel_least_times():
    # 256 x 14336 x 4096: 3.006e10 flops at 989e12 beat 68.2 MB at 3.35e12
    t = reckon.int8_matmul_seconds(256, 14336, 4096)
    assert t == pytest.approx(2 * 256 * 14336 * 4096 / 989e12)
    # one row: bytes bound (the int8 weight, its scales, x and out)
    t = reckon.int8_matmul_seconds(1, 14336, 4096)
    assert t == pytest.approx((14336 * 4096 + 4 * 14336 + 2 * 4096 + 2 * 14336) / 3.35e12)
    # paged decode: 8 kv heads x 2 x (128 + 4) bytes a cached token and layer
    assert reckon.kv_row_bytes(MISTRAL) == 2112
    assert reckon.paged_attention_seconds(MISTRAL, 4, 1000) == pytest.approx(
        (1000 * 2112 + 2 * 4 * 32 * 128 * 2) / 3.35e12)
    # flash over 2048 rows is compute bound
    assert reckon.flash_seconds(MISTRAL, 2048) == pytest.approx(
        4 * 32 * 128 * 2048 * 2049 / 2 / 989e12)


def test_admission_routes():
    assert reckon.admission(600, 0, 16, 2560) == ("one-shot", 1024)
    assert reckon.admission(20, 0, 16, 2560) == ("one-shot", 32)
    assert reckon.admission(1536 + 100, 1536, 16, 2560) == ("suffix", 128)
    assert reckon.warm_lengths([32, 40, 600, 2048], 16, 2560) == [32, 40, 600, 2048]
    assert reckon.warm_lengths([16, 17, 100, 128, 500, 512], 16, 2560) == [16, 17, 128, 512]


def test_e2e_over_a_synthetic_window():
    adm = [Admission(t0=1.0, t1=1.2, sent=0.9, plen=10, hit=0, max_new=5, window=True,
                     sliced=False),
           Admission(t0=2.0, t1=2.5, sent=1.5, plen=10, hit=0, max_new=5, window=True,
                     sliced=False)]
    disp = [Dispatch(1.3, 1.4, 4, 3, 0, True, False), Dispatch(2.6, 2.7, 2, 2, 0, True, False)]
    comp = [Completion(t=3.0, first=1.2, max_new=5, ok=True, window=True)]
    rec = Record(MISTRAL, 4, 16, 128, 0.0, 1.0, 5.0, adm, disp, comp)
    out = e2e(rec)
    assert out["output_tok_s"] == pytest.approx((2 + 4 * 3 + 2 * 2) / 4.0)
    assert out["ttft_p90_ms"] == pytest.approx(stats.percentile([300.0, 1000.0], 0.9))
    assert out["tpot_p90_ms"] == pytest.approx((3.0 - 1.2) / 4 * 1e3)


class ScriptedEngine:
    """The paged engine's behaviour on the host alone: n clamped to the
    fewest steps any live request has left, results once all are made."""

    def __init__(self):
        self.ids, self.live, self.done, self.produced = 0, {}, {}, 0

    def submit(self, prompt, max_new):
        self.ids += 1
        self.live[self.ids] = [max_new, 1]
        self.produced += 1
        return self.ids

    def step_n(self, n):
        n = min([n] + [m - k for m, k in self.live.values()])
        for rid, (m, k) in list(self.live.items()):
            self.live[rid][1] += n
            self.produced += n
            if self.live[rid][1] >= m:
                self.done[rid] = [1] * m
                del self.live[rid]
        return n

    def result(self, rid):
        return self.done.get(rid)

    def hit_tokens(self):
        return 0


def test_the_loop_counts_every_token_produced_in_the_window():
    mix = spec.read_json(spec.PKG / "traffic" / "chat.json")
    eng = ScriptedEngine()
    ticks = iter(range(10**6))
    loop = ClosedLoop(eng, Traffic(mix, 100, 4, 3), 32, 100, clock=lambda: float(next(ticks)))
    for c in range(4):
        loop.send(c)
    for _ in range(5):
        loop.iterate()
    before = eng.produced
    loop.window = True
    for _ in range(40):
        loop.iterate()
    loop.window = False
    during = eng.produced - before
    counted = sum(1 for a in loop.admissions if a.window) + sum(
        d.n * d.active for d in loop.dispatches if d.window)
    assert counted == during > 0
    assert all(c.ok for c in loop.completions)


class FakeEvent:
    def __init__(self, name, start, dur, device=True, annotation=False):
        self._n, self._s, self._d, self._dev, self._a = name, start, dur, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a


class FakeProfile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def test_a_slice_reduces_to_busy_time_shares_and_gaps():
    evs = [FakeEvent("int8_matmul_tc(x)", 1000, 400), FakeEvent("int8_matmul_wg(x)", 1500, 500),
           FakeEvent("nccl:all_reduce", 1000, 900, annotation=True),
           FakeEvent("cudaLaunchKernel", 1450, 20, device=False)]
    sl = profiling.reduce(FakeProfile(evs), 1000, 2000, [("step_n", 1000, 2000)])
    assert sl.clock_ok and len(sl.ops) == 2  # the annotation is not an operation
    assert sl.busy_seconds() == pytest.approx(900e-9)
    assert reckon.roofline_share(sl, r"int8_matmul_(tc|wg)", [300e-9, 150e-9]) == \
        pytest.approx(50.0)
    assert reckon.roofline_share(sl, r"int8_matmul_(tc|wg)", [100e-9]) is None  # count differs
    gaps = dict(profiling.breakdown(sl)["idle_gaps"])
    assert gaps == {"step_n > cudaLaunchKernel": pytest.approx(100e-9)}


def test_a_trace_clock_off_by_half_reads_no_device_metric():
    evs = [FakeEvent("k", 0, 100), FakeEvent("k", 400, 100)]  # 500 ns span for a 1000 ns slice
    sl = profiling.reduce(FakeProfile(evs), 10_000, 11_000, [("step_n", 10_000, 11_000)])
    assert not sl.clock_ok and sl.span_seconds == pytest.approx(500e-9)
    assert sl.ops == [("k", 0, 100), ("k", 400, 500)]  # kept as traced, never mapped
    assert sl.kernels("k") == [] and reckon.roofline_share(sl, "k", [50e-9, 50e-9]) is None
    rec = Record(MISTRAL, 4, 16, 128, 0.0, 0.0, 1.0, [], [], [])
    rec.slice = sl
    assert spec.load_metric("device_idle_pct").read(rec) is None
    assert profiling.breakdown(sl)["idle_gaps"] == []
    # idle time at the slice's edges alone keeps the clocks in agreement
    sl = profiling.reduce(FakeProfile([FakeEvent("k", 10_100, 800)]), 10_000, 11_000, [])
    assert sl.clock_ok and len(sl.kernels("k")) == 1
