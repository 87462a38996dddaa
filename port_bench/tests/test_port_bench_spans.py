"""The program-span readers (port_bench/spans.py and the six metrics that
read it) over a synthetic record: hand-made program span records, as the
port's tracer keeps them, and a synthetic profiled slice whose device
operations and runtime calls are laid out by hand. Times are whole
microseconds on one clock (the perf_counter offset is 0)."""

import pytest

from port_bench import spans, spec
from port_bench.harness import Record
from port_bench.profiling import Slice

MISTRAL = spec.model_shape(spec.read_json(spec.PKG / "configs" / "mistral-7b-v0.3-int8.json"))
NEW = ("decode_launch_ms", "decode_device_ms", "ring_blocked_pct", "admit_host_ms_p50",
       "idle_in_program_pct", "moe_launch_pct")
US = 1_000  # ns


class Spans:
    """Span records as the port's tracer keeps them, in the order they finish."""

    def __init__(self):
        self.records, self.n = [], 0

    def add(self, name, a, b, parent=None, **attrs):
        self.n += 1
        sid = f"{self.n:016x}"
        self.records.append({"name": name, "trace_id": "t", "span_id": sid,
                             "parent_id": parent, "start_unix": round(a, 6),
                             "duration_s": round(b - a, 6), "status": "ok", "attrs": attrs})
        return sid


def window(moe=True, first_token=True, launch=True):
    """Spans of a window opening at 1 s, its slice at [3.000, 3.012] s."""
    s = Spans()
    s.add("serve.admission", 0.5, 0.6, admitted=True)  # set-up, before the window
    d = s.add("serve.decode_dispatch", 1.1, 1.2, host_blocked_s=0.01)
    moe_attrs = {"moe_route_s": 0.01, "moe_experts_s": 0.02, "moe_route_n": 64} if moe else {}
    if launch:
        s.add("serve.decode_launch", 1.1, 1.18, d, steps=4, attn_s=0.03, **moe_attrs)
    s.add("serve.decode_consume", 1.185, 1.195, d, device_wait_s=0.005, host_blocked_s=0.002)
    d = s.add("serve.decode_dispatch", 1.3, 1.4)
    if launch:
        s.add("serve.decode_launch", 1.3, 1.34, d, steps=2)
    a = s.add("serve.admission", 1.5, 1.7, admitted=True)
    if first_token:
        s.add("serve.prefix_walk", 1.5, 1.51, a, hit_blocks=0, blocks=63)
    s.add("serve.prefill", 1.51, 1.6, a, attn_s=0.04, dequant_s=0.01, dequant_n=7,
          dequant_bytes=1000)
    if first_token:
        s.add("serve.insert", 1.6, 1.62, a)
        s.add("serve.first_token", 1.62, 1.69, a, device_wait_s=0.07)
    a = s.add("serve.admission", 2.0, 2.1, admitted=True)
    if first_token:
        s.add("serve.first_token", 2.05, 2.08, a, device_wait_s=0.03)
    s.add("serve.admission", 2.2, 2.21, admitted=False)  # refused
    f = s.add("serve.decode_flush", 2.3, 2.31, cause="result")
    s.add("serve.decode_consume", 2.3, 2.31, f, device_wait_s=0.009)
    # the slice
    d = s.add("serve.decode_dispatch", 3.0001, 3.004)
    if launch:
        s.add("serve.decode_launch", 3.0002, 3.003, d, steps=2)
    a = s.add("serve.admission", 3.005, 3.009, admitted=True)
    s.add("serve.prefill", 3.005, 3.007, a)
    if first_token:
        s.add("serve.first_token", 3.007, 3.0085, a, device_wait_s=0.0015)
    return s.records


def ns(t):
    return int(round(t * 1e6)) * US


def the_slice(clock_ok=True, late=False, extra_op=False):
    ops = [("k1", ns(3.0006), ns(3.0016)), ("k2", ns(3.0016), ns(3.0026)),
           ("k3", ns(3.0052), ns(3.0062)), ("Memcpy DtoH", ns(3.00715), ns(3.00716)),
           ("Memcpy DtoH", ns(3.01005), ns(3.01006))]
    if late:  # the first operation starts 100 us before its call
        ops[0] = ("k1", ns(3.0002), ns(3.0016))
    if extra_op:
        ops.append(("k4", ns(3.0110), ns(3.0111)))
    host = [("cudaLaunchKernel", ns(3.0003), ns(3.00031)),
            ("cuLaunchKernel", ns(3.000302), ns(3.000305)),  # inside the runtime call
            ("cudaLaunchKernel", ns(3.0005), ns(3.00051)),
            ("cudaLaunchKernel", ns(3.0052) + 80, ns(3.00521)),  # k3 stamped 80 ns before it
            ("cudaMemcpyAsync", ns(3.0071), ns(3.0084)),
            ("cudaStreamSynchronize", ns(3.0084), ns(3.00845)),
            ("cudaMemcpyAsync", ns(3.0100), ns(3.0101))]
    phases = [("step_n", ns(3.00005), ns(3.00405)), ("admit", ns(3.0049), ns(3.0091)),
              ("poll", ns(3.0092), ns(3.0110))]
    return Slice(ns(3.0), ns(3.012), 0.0114, clock_ok, ops, host, phases)


def record(sl):
    rec = Record(MISTRAL, 4, 16, 128, 0.0, 1.0, 3.02, [], [], [], (2.99, 3.02))
    rec.slice = sl
    return rec


@pytest.fixture
def program(monkeypatch):
    """Read `records` as the running program's ring; returns the readings."""
    def run(records, sl=None):
        monkeypatch.setattr(spans, "tracer_records", lambda: records)
        monkeypatch.setattr(spans, "unix_offset", lambda: 0.0)
        rec = record(sl or the_slice())
        return rec, {name: spec.load_metric(name).read(rec) for name in NEW}
    return run


def test_the_six_readings(program):
    rec, got = program(window())
    assert got["decode_launch_ms"] == pytest.approx((0.08 + 0.04) / 6 * 1e3)
    assert got["ring_blocked_pct"] == pytest.approx(100 * (0.01 + 0.002) / 2.0)
    assert got["admit_host_ms_p50"] == pytest.approx(((0.2 - 0.07) + (0.1 - 0.03)) / 2 * 1e3)
    assert got["moe_launch_pct"] == pytest.approx(100 * 0.03 / 0.12)
    assert got["decode_device_ms"] == pytest.approx(2.0 / 2)  # k1 and k2 over 2 steps
    # Gaps on the host's clock: the device's stamps moved by 80 ns, the
    # most an operation (k3) leads its call (us).
    inside = 600.08 + 2600 + 950 + 2890  # gaps whose middles lie in a program span
    assert got["idle_in_program_pct"] == pytest.approx(100 * inside / 8980)
    prog = spans.program(rec)
    assert prog.cover == (ns(1.0), ns(3.0)) and prog.pairing == (
        "3 kernels paired (the most an operation leads its call: 80 ns); 2 copies paired")


def test_the_checks_and_the_table(program):
    rec, _ = program(window())
    prog, sl = spans.program(rec), rec.slice
    assert spans.clock_check(prog, sl) == (5, 4)  # the poll phase's copy is the harness's
    waited, in_calls = spans.ring_wait_check(prog, sl)
    assert waited == pytest.approx(0.0015) and in_calls == pytest.approx(0.00135)
    rows = {r[0]: r[1:] for r in spans.span_table(prog, sl)}
    assert list(rows) == ["serve.decode_dispatch", "serve.decode_launch", "serve.admission",
                          "serve.prefill", "serve.first_token", "outside the program"]
    ms = 1e-3
    expect = {"serve.decode_dispatch": (1, 1.1 * ms, 0.0, 2.6 * ms),
              "serve.decode_launch": (1, 2.8 * ms, 2.0 * ms, 0.60008 * ms),
              "serve.admission": (1, 0.5 * ms, 0.0, 2.89 * ms),
              "serve.prefill": (1, 2.0 * ms, 1.0 * ms, 0.95 * ms),
              "serve.first_token": (1, 1.5 * ms, 0.01 * ms, 0.0),
              "outside the program": (0, 0.0, 0.01 * ms, 1.93992 * ms)}
    for name, want in expect.items():
        assert rows[name] == pytest.approx(want, abs=1e-12), name
    lines = spans.report(rec)
    assert lines[1] == "launching calls in the slice: cudaLaunchKernel 3, cudaMemcpyAsync 2"
    assert "4 of 5 launching calls" in lines[2] and "(80.00 %)" in lines[2]
    assert any(line.lstrip().startswith("outside the program") for line in lines)
    assert "sections per serve.decode_launch (ms): attn 15.0000, moe_route 5.0000, " \
           "moe_experts 10.0000" in lines
    assert "dequant_bytes per admission: 500 (2 admissions)" in lines
    assert "prefix walks: 1, 0 of 63 shareable blocks hit" in lines
    assert lines[-1] == "flushes by cause: result 1"


def test_a_ring_that_lost_the_window_start_reads_what_it_kept(program):
    records = [r for r in window() if r["start_unix"] >= 1.25]  # the first dispatch evicted
    rec, got = program(records)
    prog = spans.program(rec)
    assert prog.cover == (ns(1.34), ns(3.0))  # from the oldest kept span's end
    assert got["decode_launch_ms"] is None  # the kept launch span began before the cover
    assert got["ring_blocked_pct"] is None  # no kept span of the stretch carries the counter
    assert got["admit_host_ms_p50"] == pytest.approx(100.0)


def test_device_readings_need_the_clocks_and_the_pairing(program):
    _, got = program(window(), the_slice(clock_ok=False))
    assert got["decode_device_ms"] is None and got["idle_in_program_pct"] is None
    assert got["decode_launch_ms"] is not None  # host readings stand
    # an operation past the last call: the kernels do not pair, the copies do
    rec, got = program(window(), the_slice(extra_op=True))
    assert got["decode_device_ms"] is None and got["idle_in_program_pct"] is not None
    prog = spans.program(rec)
    assert "kernel" not in prog.paired and "copy" in prog.paired
    assert prog.pairing.startswith("kernels not paired: 3 calls, 4 operations; 2 copies paired")
    rows = {r[0]: r for r in spans.span_table(prog, rec.slice)}
    assert rows["serve.decode_launch"][3] == 0.0  # no device seconds without a pairing


def test_as_many_operations_as_calls_pair_in_order_whatever_the_stamps(program):
    """The trace's device clock set apart from the host's: k1 stamped 100
    us before its call. With no launch missed, call k launched operation k."""
    rec, got = program(window(), the_slice(late=True))
    prog = spans.program(rec)
    assert [o[0] for o, _ in prog.paired["kernel"]] == ["k1", "k2", "k3"]
    assert prog.pairing.startswith("3 kernels paired (the most an operation leads its call: "
                                   "100000 ns)")
    assert got["decode_device_ms"] == pytest.approx((1.4 + 1.0) / 2)


def test_device_stamps_move_onto_the_host_clock(program):
    """Device stamps 250 us early: moved by the most an operation leads its
    call, the gaps land where those of the stamps 80 ns early do."""
    rec, _ = program(window())
    base = spans.program(rec)
    assert spans.device_shift(base) == 80
    early = the_slice()
    early.ops = [(n, a - 250 * US, b - 250 * US) for n, a, b in early.ops]
    rec, _ = program(window(), early)
    prog = spans.program(rec)
    assert spans.device_shift(prog) == 80 + 250 * US
    assert spans.idle_gaps(early, spans.device_shift(prog)) == spans.idle_gaps(the_slice(), 80)
    assert any(line.startswith("device stamps moved by 250.080 us") for line in spans.report(rec))


def test_launches_the_trace_missed_at_the_edges():
    """A launching call the trace missed leaves its kind unpaired: which
    operation lacks its call is not known."""
    sl = the_slice()
    sl.host.pop(0)  # cudaLaunchKernel of k1 (its cuLaunchKernel inside it stays: one launch)
    assert [h[0] for h in spans.launch_calls(sl.host)][:1] == ["cuLaunchKernel"]
    prog = spans.build(record(sl), window(), 0.0)
    assert "kernel" in prog.paired  # cuLaunchKernel stands for the launch
    sl.host.pop(0)
    prog = spans.build(record(sl), window(), 0.0)
    assert "kernel" not in prog.paired
    assert prog.pairing.startswith("kernels not paired: 2 calls, 3 operations")
    assert spans.decode_device_ms(prog, sl) is None


def long_slice(lost=0, decode=200):
    """`decode` kernels launched in the slice's decode launch span (at most
    270) and 50 in its admission, 5 us each; the trace lost the first
    `lost` of them."""
    calls = [("cudaLaunchKernel", ns(3.0003) + 10 * US * i, ns(3.0003) + 10 * US * i + US)
             for i in range(decode)]
    calls += [("cudaLaunchKernel", ns(3.0051) + 10 * US * i, ns(3.0051) + 10 * US * i + US)
              for i in range(50)]
    ops = [(f"k{i}", a + 2 * US, a + 7 * US) for i, (_, a, _) in enumerate(calls)][lost:]
    return Slice(ns(3.0), ns(3.012), 0.0114, True, ops, calls, [])


@pytest.mark.parametrize("lost, read", [(0, True), (1, True), (2, False)])
def test_kernels_the_trace_lost_bound_the_decode_reading(program, lost, read):
    """Calls without their operation: the launch span's device seconds lie
    between the counts' bounds, read at their middle while those lie at
    most 1 % of it apart; the tables keep to paired kinds."""
    rec, got = program(window(), long_slice(lost))
    prog = spans.program(rec)
    lo, hi = spans.launched_in(prog, "serve.decode_launch")
    assert (lo, hi) == pytest.approx(((200 - lost) * 5e-6, 200 * 5e-6))  # 2 lost: 1.005 %
    assert ("kernel" in prog.paired) == (lost == 0)
    if read:
        assert got["decode_device_ms"] == pytest.approx((lo + hi) / 2 / 2 * 1e3)
    else:
        assert got["decode_device_ms"] is None
    bounds = [line for line in spans.report(rec) if line.startswith("device seconds launched")]
    assert len(bounds) == (1 if lost else 0)


def test_operations_without_their_call_bound_the_reading_the_other_way(program):
    sl = long_slice(decode=270)
    sl.host.pop(0)  # the first launch's call lost: its operation sits ahead of the run
    rec, got = program(window(), sl)
    lo, hi = spans.launched_in(spans.program(rec), "serve.decode_launch")
    assert (lo, hi) == pytest.approx((268 * 5e-6, 270 * 5e-6))  # true: 270
    assert got["decode_device_ms"] == pytest.approx(269 * 5e-6 / 2 * 1e3)
    sl = long_slice()
    sl.host.pop(0)
    rec, got = program(window(), sl)
    assert spans.launched_in(spans.program(rec), "serve.decode_launch") == pytest.approx(
        (198 * 5e-6, 200 * 5e-6))
    assert got["decode_device_ms"] is None  # 1.005 % of the middle apart


def test_a_program_without_the_new_spans_reports_nothing_new(program):
    """The parent program: admission, prefill, dispatch and consume spans,
    no launch, first-token or MoE section."""
    _, got = program(window(moe=False, first_token=False, launch=False))
    assert {k for k, v in got.items() if v is None} == {
        "decode_launch_ms", "decode_device_ms", "admit_host_ms_p50", "moe_launch_pct"}
    _, got = program(window(moe=False))
    assert got["moe_launch_pct"] is None and got["decode_launch_ms"] is not None


def test_no_tracer_no_reading(program):
    rec, got = program([])
    assert set(got.values()) == {None} and spans.program(rec) is None
    assert spans.report(rec) == [
        "program spans: none in the window (the program's tracer is off or has none)"]


def test_innermost_labels_nested_spans():
    s = [spans.Span("outer", 0, 100, {}, "a", None), spans.Span("inner", 10, 20, {}, "b", "a"),
         spans.Span("next", 20, 30, {}, "c", "a"), spans.Span("after", 200, 300, {}, "d", None)]
    prog = spans.Program(0, (0, 0), [], s, {x.sid: x for x in s})
    prog._starts, prog._labels = spans.segments(s)
    names = {t: (prog.innermost(t).name if prog.innermost(t) else None)
             for t in (-1, 5, 15, 20, 25, 50, 150, 250, 400)}
    assert names == {-1: None, 5: "outer", 15: "inner", 20: "next", 25: "next", 50: "outer",
                     150: None, 250: "after", 400: None}
    assert prog.within(s[1], "outer") and not prog.within(s[0], "inner")
