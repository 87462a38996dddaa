"""The telemetry of the port's engines (lws_tpu_torch/serving: PagedBatchEngine
plain, prefix, chunked and speculative; Engine; BatchEngine; the
DecodePipeline under them) held to the JAX engines' on the CPU. Each case
runs one workload through the JAX engine (its Pallas paged kernel in
interpret mode) and through the port's on converted f32 weights, each side
reporting into fresh registries, recorders and tracers of its own package.
Metric family names, types and label sets, every counter value but
durations, every histogram's `_count` and every slot, block, ring and
attainment gauge must be equal; durations need only be present and >= 0.
The multiset of span names and of flight-recorder event kinds must be
equal, and the greedy streams too.

Then the port's cases of tests/test_telemetry_plane.py (the decode-ring
stall watchdog end to end, the rollback event, resolvable SLO exemplars),
tests/test_profile_plane.py (block accounting and its gauges across the
prefix lifecycle and a pipeline rollback, the prefix hit/miss/evict
counters, the batch engine's slot gauge), tests/test_decode_pipeline.py
(the in-flight gauge and host-blocked counter) and
tests/test_paged_speculative.py (an injected `pipeline.dispatch` fault
rolls back)."""

import time
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lws_tpu.core import faults as jfaults
from lws_tpu.core import flightrecorder as jfr
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import slo as jslo
from lws_tpu.core import trace as jtrace
from lws_tpu.models import llama as jl
from lws_tpu.obs import device as jdevice
from lws_tpu.serving.batch_engine import BatchEngine as JaxBatchEngine
from lws_tpu.serving.engine import Engine as JaxEngine
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.core import faults, flightrecorder, metrics, slo, trace
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.batch_engine import BatchEngine
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine
from lws_tpu_torch.serving.pipeline import DecodePipeline

# Counters that accumulate seconds: only their presence is compared.
DURATION_COUNTERS = {"serving_host_blocked_seconds"}
UNMET = {"ttft_s": 1e9, "itl_s": 1e9, "queue_wait_s": 1e9}  # every request attains


def build(jcfg):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def model():
    return build(jl.LlamaConfig(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=128, max_seq_len=256, dtype=jnp.float32,
                                param_dtype=jnp.float32, remat=False))


class Side:
    """One package's process-default telemetry, swapped for fresh objects."""

    def __init__(self, monkeypatch, m, s, t, fr):
        self.metrics, self.trace = m, t
        monkeypatch.setattr(m, "REGISTRY", m.MetricsRegistry())
        monkeypatch.setattr(s, "RECORDER", s.SLORecorder(s.SLOTargets(**UNMET),
                                                         class_targets={}, revision=""))
        monkeypatch.setattr(t, "TRACER", t.Tracer(ring=1 << 16, enabled=True, sample_rate=1.0))
        monkeypatch.setattr(fr, "RECORDER", fr.FlightRecorder())
        self.fr = fr

    def reset(self):
        """Fresh registry, recorder and tracer contents for the next run."""
        self.metrics.REGISTRY = self.metrics.MetricsRegistry()
        self.trace.TRACER.clear()
        self.fr.RECORDER.clear()

    def snapshot(self) -> dict:
        return {
            "families": self.metrics.parse_exposition(self.metrics.REGISTRY.render()),
            "spans": Counter(s["name"] for s in self.trace.TRACER.spans()),
            "events": Counter(e["kind"] for e in self.fr.RECORDER.events()),
            "beats": sorted(self.fr.RECORDER.heartbeats()),
        }


@pytest.fixture
def sides(monkeypatch):
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")
    # A compile listener armed by an earlier test of this process would
    # record the JAX side's XLA compiles; the port builds nothing on the CPU.
    monkeypatch.setattr(jdevice.LEDGER, "_enabled", False)
    return (Side(monkeypatch, jmetrics, jslo, jtrace, jfr),
            Side(monkeypatch, metrics, slo, trace, flightrecorder))


def _by_series(fam):
    return {(name, tuple(sorted(labels.items()))): v for name, labels, v, _ in fam["samples"]}


def assert_same_telemetry(jsnap, psnap):
    jf, pf = jsnap["families"], psnap["families"]
    assert sorted(pf) == sorted(jf)
    for name, jfam in jf.items():
        pfam = pf[name]
        assert pfam["type"] == jfam["type"], name
        js, ps = _by_series(jfam), _by_series(pfam)
        assert sorted(ps) == sorted(js), name  # the same series and label sets
        for key, v in js.items():
            got = ps[key]
            timed = (jfam["type"] == "histogram" and not key[0].endswith("_count")) or \
                name in DURATION_COUNTERS
            if timed:
                assert got >= 0, (key, got)
            else:
                assert got == v, (key, got, v)
    assert psnap["spans"] == jsnap["spans"]
    assert psnap["events"] == jsnap["events"]
    assert psnap["beats"] == jsnap["beats"]


def prompts(n, rng=3, vocab=64, lo=4, hi=40):
    r = np.random.RandomState(rng)
    return [r.randint(1, vocab - 1, size=r.randint(lo, hi)).astype(np.int32) for _ in range(n)]


def paged_pair(model, **kw):
    jcfg, jparams, tcfg, tparams = model
    kw.setdefault("pipeline_depth", 2)
    return (JaxPagedBatchEngine(jcfg, jparams, **kw),
            PagedBatchEngine(tcfg, tparams, device="cpu", **kw))


def run_both(sides, engines, drive):
    """`drive(engine)` on the JAX engine reporting into the JAX side, then
    on the port's into the port's; returns both snapshots and outputs."""
    out = []
    for side, eng in zip(sides, engines):
        side.reset()
        got = drive(eng)
        out.append((side.snapshot(), got))
    (jsnap, jout), (psnap, pout) = out
    assert pout == jout
    assert_same_telemetry(jsnap, psnap)
    return jsnap, psnap


def test_paged_plain_telemetry_matches_jax(model, sides):
    ps = prompts(5, rng=11)

    def drive(eng):
        ids = [eng.submit(p, 12, klass="chat") for p in ps[:2]]
        eng.step_n(2)
        ids.append(eng.submit(ps[2], 9))
        ids.append(eng.submit(ps[3], 12, klass="chat"))  # refused: both slots are busy
        eng.run_until_drained()
        ids.append(eng.submit(ps[4], 1))  # finishes at admission
        eng.step_n(1)
        return [ids[3]] + [eng.result(i) for i in ids if i is not None]

    jsnap, psnap = run_both(sides, paged_pair(model, slots=3, max_len=64, block_size=8), drive)
    fam = psnap["families"]
    assert _by_series(fam["serving_requests_total"]) == {
        ("serving_requests_total", (("engine", "paged"),)): 4.0}
    assert ("serving_active_slots", (("engine", "paged"),)) in _by_series(
        fam["serving_active_slots"])
    assert psnap["spans"]["serve.admission"] == 5 and psnap["spans"]["serve.prefill"] == 4


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_paged_prefix_telemetry_matches_jax(model, sides, pipeline_depth):
    shared = np.arange(1, 25, dtype=np.int32)

    def drive(eng):
        out = []
        for p, n in ((shared, 8), (shared, 8), (np.full((24,), 9, np.int32), 40),
                     (np.full((24,), 11, np.int32), 24), (np.concatenate([shared, shared]), 6)):
            rid = eng.submit(p, n)
            out.append(rid)
            if rid is not None and n == 8:
                eng.run_until_drained()
        eng.run_until_drained()
        return out + [eng.result(i) for i in out if i is not None] + [eng.stats_prefix]

    run_both(sides, paged_pair(model, slots=3, max_len=64, block_size=8, num_blocks=12,
                               prefix_cache=True, pipeline_depth=pipeline_depth), drive)


def test_paged_chunked_telemetry_matches_jax(model, sides):
    ps = prompts(2, rng=5, lo=6, hi=10) + prompts(2, rng=6, lo=40, hi=90)

    def drive(eng):
        ids = [eng.submit(p, 16) for p in ps[:2]]
        ids += [eng.submit(p, 10) for p in ps[2:]]  # chunked, decoding the others between chunks
        eng.run_until_drained()
        return [eng.result(i) for i in ids] + [eng.stats["chunked_admissions"]]

    _, psnap = run_both(sides, paged_pair(model, slots=4, max_len=128, block_size=8,
                                          prefill_chunk=16, interleave_steps=2, prefix_cache=True),
                        drive)
    assert psnap["spans"]["serve.prefill"] == 4


@pytest.mark.parametrize("sync", [False, True])
def test_paged_speculative_telemetry_matches_jax(model, sides, sync):
    rng = np.random.RandomState(0)
    pat = rng.randint(1, 60, size=8).astype(np.int32)
    ps = [np.tile(pat, 5), rng.randint(1, 60, size=20).astype(np.int32)]

    def drive(eng):
        ids = [eng.submit(p, 30) for p in ps]
        eng.step_n(1)
        eng.run_until_drained_speculative(gamma=4, ngram=3, sync=sync)
        return [eng.result(i) for i in ids]

    _, psnap = run_both(sides, paged_pair(model, slots=2, max_len=128, block_size=16), drive)
    assert psnap["spans"]["serve.spec_verify"] > 0


def test_dense_engine_telemetry_matches_jax(model, sides):
    jcfg, jparams, tcfg, tparams = model
    engines = (JaxEngine(jcfg, jparams, batch_size=1, max_len=128, pipeline_depth=2),
               Engine(tcfg, tparams, batch_size=1, max_len=128, pipeline_depth=2, device="cpu"))
    rng = np.random.RandomState(2)
    pat = rng.randint(1, 60, size=6).astype(np.int32)
    prompt = np.tile(pat, 4)[None, :]

    def drive(eng):
        out = [np.asarray(eng.generate(prompt, 40, klass="chat").tokens).tolist(),
               np.asarray(eng.generate(prompt[:, :7], 5).tokens).tolist(),
               np.asarray(eng.generate_speculative(prompt, 30, gamma=4, klass="chat")
                          .tokens).tolist()]
        token, cache = eng.prefill_chunked(prompt[:, :20], chunk_size=8)
        _, _, toks = eng.decode_speculative(token, cache, 12, gamma=4, pos=20,
                                            context=prompt[0, :20])
        return out + [np.asarray(toks).tolist()]

    _, psnap = run_both(sides, engines, drive)
    assert psnap["spans"]["serve.request"] == 3


def test_batch_engine_telemetry_matches_jax(model, sides):
    jcfg, jparams, tcfg, tparams = model
    engines = (JaxBatchEngine(jcfg, jparams, slots=2, max_len=64, pipeline_depth=2),
               BatchEngine(tcfg, tparams, slots=2, max_len=64, pipeline_depth=2, device="cpu"))
    ps = prompts(4, rng=8)

    def drive(eng):
        ids = [eng.submit(ps[0], 6, klass="chat"), eng.submit(ps[1], 9)]
        eng.step()
        ids.append(eng.submit(ps[2], 4))  # refused: no free slot
        eng.run_until_drained()
        ids.append(eng.submit(ps[3], 1))
        return [ids[2]] + [eng.result(i) for i in ids if i is not None]

    run_both(sides, engines, drive)


# ---------------------------------------------------------------------------
# The port's cases of the JAX package's telemetry tests.


def small_port_engine(model, **kw):
    return PagedBatchEngine(model[2], model[3], max_len=64, block_size=16, device="cpu", **kw)


def test_pipeline_heartbeat_and_stall_injection_end_to_end(model, monkeypatch):
    """tests/test_telemetry_plane.py:319 on the port: a dispatched chunk
    parks in the ring (depth 1, progress frozen), the watchdog trips, and
    the dump's spans reference the stalled request's trace id."""
    monkeypatch.setattr(trace, "TRACER", trace.Tracer(enabled=True, sample_rate=1.0))
    engine = small_port_engine(model, slots=2, pipeline_depth=2)
    with trace.span("serve.request", engine="paged", request_id="stalled") as sp:
        assert engine.submit(np.arange(1, 9, dtype=np.int32), 16) is not None
        engine.step_n(4)  # the chunk rides the ring, unconsumed
        stalled_trace = sp.trace_id
    assert flightrecorder.RECORDER.heartbeats()["decode_ring:paged"]["depth"] >= 1
    wd = flightrecorder.Watchdog(rules=[flightrecorder.StallRule(
        "decode_ring_stall", "decode_ring:*", stall_after_s=5.0)])
    assert "decode_ring_stall" in wd.check_now(now=time.monotonic() + 30)
    assert any(s.get("trace_id") == stalled_trace for s in wd.last_dump["spans"])
    engine.run_until_drained()
    assert flightrecorder.RECORDER.heartbeats()["decode_ring:paged"]["depth"] == 0


def test_pipeline_discard_records_rollback_event():
    pipe = DecodePipeline(depth=2, engine="paged")
    pipe.push(4, np.zeros((4, 1), np.int32), lambda h: None)
    pipe.discard()
    ev = [e for e in flightrecorder.RECORDER.events() if e["kind"] == "pipeline_discard"]
    assert ev and ev[-1]["chunks"] == 1 and ev[-1]["steps"] == 4
    assert metrics.REGISTRY.gauge_value("serving_inflight_dispatches", {"engine": "paged"}) == 0


def test_paged_engine_emits_slo_metrics_with_resolvable_exemplars(model, monkeypatch):
    """tests/test_telemetry_plane.py:371 on the port, with a fresh
    registry/recorder pair so only this test's exemplars are held to the
    live tracer."""
    monkeypatch.setattr(trace, "TRACER", trace.Tracer(enabled=True, sample_rate=1.0))
    registry = metrics.MetricsRegistry()
    monkeypatch.setattr(slo, "RECORDER", slo.SLORecorder(registry=registry))
    engine = small_port_engine(model, slots=2)
    rid = engine.submit(np.arange(1, 9, dtype=np.int32), 8)
    engine.run_until_drained()
    assert engine.result(rid) is not None
    fams = metrics.parse_exposition(registry.render())
    for name in ("serving_queue_wait_seconds", "serving_ttft_seconds", "serving_itl_seconds"):
        assert any(labels.get("engine") == "paged" and n.endswith("_count") and v > 0
                   for n, labels, v, _ in fams[name]["samples"]), name
    att = [v for _, labels, v, _ in fams["serving_slo_attainment"]["samples"]
           if labels.get("engine") == "paged"]
    assert att and 0.0 <= att[0] <= 1.0
    known = {s["trace_id"] for s in trace.TRACER.spans()}
    exemplar_ids = {line.split('trace_id="')[1].split('"')[0]
                    for line in registry.render().splitlines()
                    if "serving_ttft_seconds_bucket" in line and 'trace_id="' in line}
    assert exemplar_ids and exemplar_ids <= known


def _gauge(state):
    return metrics.REGISTRY.gauge_value("serving_kv_pool_blocks",
                                        {"engine": "paged", "state": state})


def _assert_conserved(engine):
    """free, parked and request-held blocks partition [1, num_blocks), and
    the gauges agree with the accounting."""
    free, parked = set(engine._free_blocks), set(engine._lru)
    live = set()
    for req in engine._active.values():
        live |= set(req.blocks)
    assert not free & parked and not free & live and not parked & live
    assert free | parked | live == set(range(1, engine.num_blocks))
    acct = engine.pool_accounting()
    assert (acct["free"], acct["parked"], acct["live"]) == (len(free), len(parked), len(live))


def test_paged_block_accounting_conserved_across_prefix_lifecycle(model):
    """tests/test_profile_plane.py:261 on the port: free + live + parked ==
    num_blocks - 1 across prefix admission, LRU parking, eviction under
    pressure and backpressure rollback; the gauges end equal to the
    accounting."""
    engine = small_port_engine(model, slots=4, num_blocks=10, prefix_cache=True)
    _assert_conserved(engine)
    prompt = np.arange(1, 25, dtype=np.int32)
    assert engine.submit(prompt, 8) is not None
    engine.run_until_drained()
    _assert_conserved(engine)
    assert engine.pool_accounting()["parked"] == 1
    assert engine.submit(prompt, 8) is not None
    assert engine.stats_prefix["hit_blocks"] == 1
    refused = engine.submit(np.arange(1, 25, dtype=np.int32), 40)
    while refused is not None:
        _assert_conserved(engine)
        refused = engine.submit(np.arange(1, 25, dtype=np.int32), 40)
    _assert_conserved(engine)
    engine.run_until_drained()
    for seed in (3, 5, 7):
        assert engine.submit(np.full((24,), seed, dtype=np.int32), 8) is not None
        engine.run_until_drained()
        _assert_conserved(engine)
    evictions_before = engine.stats_prefix["evictions"]
    while engine.submit(np.arange(30, 54, dtype=np.int32), 40) is not None:
        _assert_conserved(engine)
    assert engine.stats_prefix["evictions"] > evictions_before
    engine.run_until_drained()
    _assert_conserved(engine)
    acct = engine.pool_accounting()
    assert (_gauge("free"), _gauge("live"), _gauge("parked")) == \
        (acct["free"], acct["live"], acct["parked"])
    assert _gauge("free") + _gauge("live") + _gauge("parked") == 9.0


def test_paged_block_accounting_survives_pipeline_rollback(model):
    """tests/test_profile_plane.py:325 on the port."""
    engine = small_port_engine(model, slots=2, pipeline_depth=2)
    assert engine.submit(np.arange(1, 25, dtype=np.int32), 8) is not None
    engine.step_n(2)
    assert len(engine._pipeline) >= 1
    engine._pipeline.discard()
    _assert_conserved(engine)
    engine._rollback_to_host_truth()
    engine.run_until_drained()
    _assert_conserved(engine)
    assert engine.pool_accounting()["live"] == 0 and _gauge("live") == 0


def test_prefix_cache_hit_miss_evict_counters(model):
    """tests/test_profile_plane.py:341 on the port."""
    reg = metrics.REGISTRY
    labels = {"engine": "paged"}
    hbm = {"engine": "paged", "tier": "hbm"}
    h0 = reg.counter_value("serving_prefix_cache_hits_total", hbm)
    m0 = reg.counter_value("serving_prefix_cache_misses_total", labels)
    engine = small_port_engine(model, slots=2, num_blocks=8, prefix_cache=True)
    prompt = np.arange(1, 25, dtype=np.int32)
    engine.submit(prompt, 8)
    engine.run_until_drained()
    assert reg.counter_value("serving_prefix_cache_misses_total", labels) == m0 + 1
    engine.submit(prompt, 8)
    engine.run_until_drained()
    assert reg.counter_value("serving_prefix_cache_hits_total", hbm) == h0 + 1
    e0 = reg.counter_value("serving_prefix_cache_evictions_total", labels)
    assert engine.submit(np.full((24,), 9, dtype=np.int32), 40) is not None
    assert engine.submit(np.full((24,), 11, dtype=np.int32), 24) is not None
    assert reg.counter_value("serving_prefix_cache_evictions_total", labels) == e0 + 1
    assert engine.stats_prefix["evictions"] == 1
    engine.run_until_drained()


def test_batch_engine_reports_slot_occupancy(model):
    """tests/test_profile_plane.py:381 on the port."""
    engine = BatchEngine(model[2], model[3], slots=2, max_len=64, device="cpu")
    engine.submit(np.arange(1, 9, dtype=np.int32), 4)
    assert metrics.REGISTRY.gauge_value("serving_active_slots", {"engine": "batch"}) == 1.0
    engine.run_until_drained()
    assert metrics.REGISTRY.gauge_value("serving_active_slots", {"engine": "batch"}) == 0.0


def test_inflight_metrics_surface(model):
    """tests/test_decode_pipeline.py:328 on the port: the gauge tracks the
    ring and the host-blocked counter accumulates for the engine label."""
    engine = PagedBatchEngine(model[2], model[3], slots=2, max_len=64, block_size=8,
                              pipeline_depth=2, device="cpu")
    before = metrics.REGISTRY.counter_value("serving_host_blocked_seconds", {"engine": "paged"})
    for p in prompts(2, rng=43):
        engine.submit(p, 8)
    engine.step_n(1)
    assert metrics.REGISTRY.gauge_value(
        "serving_inflight_dispatches", {"engine": "paged"}) == len(engine._pipeline) == 1
    engine.run_until_drained()
    assert metrics.REGISTRY.gauge_value("serving_inflight_dispatches", {"engine": "paged"}) == 0
    assert metrics.REGISTRY.counter_value(
        "serving_host_blocked_seconds", {"engine": "paged"}) > before


def test_push_fault_rollback_matches_jax(model, monkeypatch):
    """tests/test_paged_speculative.py:287 on both packages, each arming its
    own injector: the injected `pipeline.dispatch` fault during a
    speculative chunk rolls back (everything in flight discarded, a
    `pipeline_discard` event and a trip recorded), and the drain still
    emits the JAX engine's stream."""
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")
    rng = np.random.RandomState(0)
    p1 = np.tile(rng.randint(1, 60, size=8).astype(np.int32), 6)
    streams = []
    for f, fr, m, eng in ((jfaults, jfr, jmetrics, JaxPagedBatchEngine(
            model[0], model[1], slots=2, max_len=256, block_size=16, pipeline_depth=2)),
            (faults, flightrecorder, metrics, PagedBatchEngine(
                model[2], model[3], slots=2, max_len=256, block_size=16, pipeline_depth=2,
                device="cpu"))):
        trips = {"point": "pipeline.dispatch", "mode": "fail_n_times"}
        t0 = m.REGISTRY.counter_value("lws_fault_trips_total", trips)
        rid = eng.submit(p1, max_new_tokens=24)
        assert eng.step_speculative(gamma=4, ngram=3) is True  # one chunk in flight
        f.INJECTOR.arm("pipeline.dispatch", "fail_n_times:1:RuntimeError")
        try:
            with pytest.raises(RuntimeError):
                eng.step_speculative(gamma=4, ngram=3)
        finally:
            f.INJECTOR.disarm()
        assert len(eng._pipeline) == 0 and eng._pipeline.stats["discarded"] >= 1
        assert fr.RECORDER.events()[-1]["kind"] == "pipeline_discard"
        assert m.REGISTRY.counter_value("lws_fault_trips_total", trips) == t0 + 1
        eng.run_until_drained_speculative(gamma=4, ngram=3)
        streams.append(eng.result(rid))
    assert streams[0] == streams[1]
