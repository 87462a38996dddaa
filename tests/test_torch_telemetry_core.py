"""The port's copies of the jax-free telemetry and loadgen modules
(lws_tpu_torch/core/{metrics,trace,slo,flightrecorder,faults}.py,
utils/common.py, loadgen/{arrivals,workload,scenario}.py) pinned to the JAX
package's: the same call sequence renders byte-identical expositions, the
same stamps give the same attainment and goodput, the same fault schedules
fire the same way, and every built-in scenario with several seeds gives the
same schedule and `schedule_digest`."""

import json

import pytest

from lws_tpu import loadgen as jloadgen
from lws_tpu.core import faults as jfaults
from lws_tpu.core import flightrecorder as jfr
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import slo as jslo
from lws_tpu.core import trace as jtrace
from lws_tpu.utils import common as jcommon
from lws_tpu_torch import loadgen
from lws_tpu_torch.core import faults, flightrecorder, metrics, slo, trace
from lws_tpu_torch.utils import common

T0 = 1000.0


def _metric_calls(m, reg):
    """One call sequence through a metrics module's registry: counters,
    gauges, declared and default bucket ladders, exemplars, a cleared gauge
    and the per-name label-set cap."""
    reg.inc("serving_requests_total", {"engine": "paged"})
    reg.inc("serving_requests_total", {"engine": "paged"}, 2.0)
    reg.inc("serving_requests_total", {"engine": "batch"})
    reg.inc("serving_host_blocked_seconds", {"engine": "paged"}, 0.125)
    reg.set("serving_active_slots", 3, {"engine": "paged"})
    reg.set("serving_kv_pool_blocks", 7, {"engine": "paged", "state": "free"})
    reg.set("serving_kv_pool_blocks", 2, {"engine": "paged", "state": "live"})
    reg.set("serving_slo_attainment", 0.5, {"engine": "paged", "klass": "chat"})
    reg.set("serving_slo_attainment", 1.0, {"engine": "paged"})
    reg.clear_gauge("serving_slo_attainment", {"engine": "paged"}, exact=True)
    for v in (0.0004, 0.003, 0.02, 0.2, 2.0, 90.0):
        reg.observe("serving_ttft_seconds", v, {"engine": "paged"},
                    exemplar={"trace_id": f"{int(v * 1e4):016x}", "span_id": "01"})
        reg.observe("serving_itl_seconds", v / 100, {"engine": "paged", "klass": "chat"})
        reg.observe("serving_decode_dispatch_duration_seconds", v, {"engine": "paged"})
    reg.set_buckets("serving_transfer_seconds", (0.5, 0.1))
    reg.observe("serving_transfer_seconds", 0.3, {"site": "s", "direction": "h2d"})
    for i in range(6):  # past the cap of 4 label sets
        reg.inc("serving_transfer_bytes_total", {"site": f"s{i}", "direction": "h2d"}, 8.0)
    return m.render_exposition(reg)


def test_same_calls_render_byte_identical_expositions():
    text = _metric_calls(metrics, metrics.MetricsRegistry(max_label_sets=4))
    jtext = _metric_calls(jmetrics, jmetrics.MetricsRegistry(max_label_sets=4))
    assert text == jtext
    assert "lws_metric_label_sets_dropped_total" in text and " # {" in text
    assert metrics.parse_exposition(text) == jmetrics.parse_exposition(jtext)


def test_every_described_name_keeps_jax_help_and_buckets():
    # The port declares a subset of the JAX package's names (those it emits),
    # each with the same HELP text and histogram ladder, so a scrape merged
    # across JAX and port workers has one HELP line per family.
    assert metrics._HELP and set(metrics._HELP) <= set(jmetrics._HELP)
    for name, text in metrics._HELP.items():
        assert text == jmetrics._HELP[name], name
    assert metrics._BUCKETS == {n: jmetrics._BUCKETS[n] for n in metrics._BUCKETS}
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


def test_process_registries_are_separate_objects():
    assert metrics.REGISTRY is not jmetrics.REGISTRY
    assert trace.TRACER is not jtrace.TRACER
    assert slo.RECORDER is not jslo.RECORDER
    assert flightrecorder.RECORDER is not jfr.RECORDER
    assert faults.INJECTOR is not jfaults.INJECTOR


def _slo_run(s, m, klass_targets):
    reg = m.MetricsRegistry()
    rec = s.SLORecorder(s.SLOTargets(ttft_s=0.5, itl_s=0.05, queue_wait_s=0.2),
                        registry=reg, window=4, max_age_s=60.0,
                        class_targets=klass_targets(s), revision="")
    stamps = [  # (klass, queue, ttft, [(n, elapsed)])
        ("", 0.01, 0.1, [(4, 0.04), (4, 0.04)]),
        ("", 0.3, 0.1, [(2, 0.02)]),             # queue breach
        ("chat", 0.01, 0.4, [(8, 2.4)]),        # ITL breach, late tokens
        ("chat", 0.01, 0.9, [(1, 0.01)]),       # within chat's 1.0 ttft
        ("premium", 0.0, 0.3, []),              # first token only
        ("", 0.01, 0.2, [(3, 0.03), (0, 0.0), (5, 2.0)]),
    ]
    verdicts = []
    for klass, q, ttft, chunks in stamps:
        tl = rec.request("paged", klass=klass)
        tl.queue_wait(q)
        tl.first_token(ttft)
        for n, dt in chunks:
            tl.tokens(n, dt)
        verdicts.append(tl.finish())
        assert tl.finish() is True  # idempotent
    out = {k: rec.attainment("paged", k) for k in ("", "chat", "premium", "none")}
    text = reg.render()
    for k in ("", "chat", "premium"):
        labels = {"engine": "paged", **({"klass": k} if k else {})}
        out[f"tokens/{k}"] = reg.counter_value("serving_tokens_total", labels)
        out[f"good/{k}"] = reg.counter_value("serving_goodput_tokens_total", labels)
    rec.refresh(now=10 ** 9)  # every window aged out: the gauges retire
    return verdicts, out, text, reg.render()


def test_slo_recorders_give_the_same_attainment_and_goodput():
    def targets(s):
        return {"chat": s.SLOTargets(ttft_s=1.0, itl_s=0.2, queue_wait_s=0.5)}

    verdicts, out, text, aged = _slo_run(slo, metrics, targets)
    jverdicts, jout, jtext, jaged = _slo_run(jslo, jmetrics, targets)
    assert verdicts == jverdicts == [True, False, False, True, True, False]
    assert out == jout
    assert out["tokens/"] > out["good/"] > 0
    # Histograms and gauges byte for byte, but for the exemplar-free,
    # timing-free lines (no trace is open here, so no exemplars ride).
    assert text == jtext
    assert aged == jaged and "serving_slo_attainment{" not in aged


@pytest.mark.parametrize("cum", [0, 1, 2, 7, 100])
def test_token_deadline_matches(cum):
    t = slo.SLOTargets(ttft_s=0.3, itl_s=0.02)
    jt = jslo.SLOTargets(ttft_s=0.3, itl_s=0.02)
    assert slo.token_deadline_s(t, cum) == jslo.token_deadline_s(jt, cum)


def test_slo_targets_env_and_class_overrides(monkeypatch):
    monkeypatch.setenv("LWS_TPU_SLO_TTFT_S", "0.25")
    monkeypatch.setenv("LWS_TPU_SLO_ITL_S", "bad")
    monkeypatch.setenv("LWS_TPU_SLO_CLASS_TARGETS", json.dumps({"premium": {"ttft_s": 0.1}}))
    base, jbase = slo.SLOTargets.from_env(), jslo.SLOTargets.from_env()
    assert (base.ttft_s, base.itl_s, base.queue_wait_s) == \
        (jbase.ttft_s, jbase.itl_s, jbase.queue_wait_s) == (0.25, 0.1, 0.5)
    got = slo.class_targets_from_env(base)["premium"]
    jgot = jslo.class_targets_from_env(jbase)["premium"]
    assert (got.ttft_s, got.itl_s) == (jgot.ttft_s, jgot.itl_s) == (0.1, 0.1)
    with pytest.raises(ValueError):
        base.overridden({"ttft": 1.0})
    assert common.env_float("LWS_TPU_SLO_ITL_S", 3.0) == \
        jcommon.env_float("LWS_TPU_SLO_ITL_S", 3.0) == 3.0


def _tracer_shape(t):
    tr = t.Tracer(ring=8, enabled=True, sample_rate=1.0)
    seen = []
    tr.add_finish_listener(seen.append)
    with tr.span("root", a=1) as root:
        with tr.span("child") as child:
            child.add(host_blocked_s=0.5)
            child.add(host_blocked_s=0.25)
            ctx = tr.current_context()
        with tr.span("remote", parent={"trace_id": "feed", "span_id": "beef"}):
            pass
    with pytest.raises(KeyError):
        with tr.span("boom"):
            raise KeyError("x")
    off = t.Tracer(enabled=False)
    with off.span("x") as disabled:
        noop = disabled is t.NOOP and off.current_span() is t.NOOP
    sampled_out = t.Tracer(enabled=True, sample_rate=0.0)
    with sampled_out.span("r"):
        with sampled_out.span("c"):
            pass
    recs = tr.spans()
    return {
        "names": [r["name"] for r in recs],
        "keys": [sorted(r) for r in recs],
        "links": [(r["trace_id"] == root.trace_id, r["parent_id"] == root.span_id)
                  for r in recs],
        "child_attrs": recs[0]["attrs"],
        "remote": (recs[1]["trace_id"], recs[1]["parent_id"]),
        "error": (recs[-1]["status"], recs[-1]["attrs"]["error"]),
        "ctx": sorted(ctx), "listener": len(seen),
        "noop": noop,
        "sampled_out": sampled_out.spans(), "limit0": tr.spans(0),
    }


def test_tracers_behave_alike():
    assert _tracer_shape(trace) == _tracer_shape(jtrace)


def _watchdog_run(fr):
    rec = fr.FlightRecorder()
    wd = fr.Watchdog(recorder=rec, rules=[
        fr.StallRule("decode_ring_stall", "decode_ring:*", stall_after_s=5.0),
        fr.BacklogRule("hbm_pressure", "hbm_pressure:*", depth_threshold=1.0, sustain_s=0.0),
    ])
    out = []
    rec.beat("decode_ring:paged", progress=1, depth=1, now=T0)
    rec.beat("decode_ring:batch", progress=1, depth=1, now=T0)
    rec.beat("hbm_pressure:gpu:0", progress=0.0, depth=1.2, now=T0)
    out.append(sorted(wd.check_now(now=T0 + 1)))
    rec.beat("decode_ring:batch", progress=2, depth=1, now=T0 + 8)  # progressing: never stalls
    out.append({k: [h["source"] for h in v] for k, v in wd.check_now(now=T0 + 9).items()})
    rec.beat("decode_ring:paged", progress=2, depth=0, now=T0 + 10)
    rec.beat("hbm_pressure:gpu:0", progress=0.0, depth=0.0, now=T0 + 10)
    out.append(sorted(wd.check_now(now=T0 + 11)))
    out.append([e["kind"] for e in rec.events()])
    out.append(wd.last_dump["alert"]["watchdog"])
    return out


def test_watchdogs_fire_alike():
    assert _watchdog_run(flightrecorder) == _watchdog_run(jfr)
    port = [(r.name, r.pattern) for r in flightrecorder.default_rules()]
    jax_rules = [(r.name, r.pattern) for r in jfr.default_rules()]
    assert port and port == jax_rules


def test_flight_recorder_dump_embeds_profile_and_compiles():
    dump = flightrecorder.FlightRecorder().dump(reason="t")
    assert {"profile", "compiles", "spans", "metrics", "events", "heartbeats"} <= set(dump)
    # The JAX dump's planes, the rollout ledger and decision window included.
    jdump = jfr.FlightRecorder().dump(reason="t")
    assert set(dump) == set(jdump)
    json.dumps(dump)


@pytest.mark.parametrize("spec", [
    "fail_n_times:2", "fail_n_times:1:RuntimeError", "every_k:3:ValueError",
    "prob:0.4:7", "exit:1", "delay:0:2",
])
def test_fault_schedules_fire_alike(spec):
    def run(f):
        inj = f.FaultInjector(env="")
        inj.arm("pipeline.dispatch", spec)
        out = []
        for _ in range(8):
            try:
                got = inj.fire("pipeline.dispatch")
                out.append(None if got is None else got.mode)
            except BaseException as e:  # noqa: BLE001 — SystemExit is a schedule outcome too
                out.append(type(e).__name__)
        return out, inj.snapshot()

    assert run(faults) == run(jfaults)


def test_fault_grammar_and_refusals_match():
    """A malformed spec is refused by both injectors at arm time, and
    nothing is armed. A cooperative mode (drop, partial_write, pace) arms
    only at a point whose call site honors it: both refuse it at a bare
    point with the same message, and both arm it at the KV wire's points."""
    for bad in ("nope", "", "unknown:1", "fail_n_times", "every_k:0",
                "delay:x", "prob:0.5", "fail_n_times:1:KeyError", "pace:0"):
        for f in (faults, jfaults):
            inj = f.FaultInjector(env="")
            with pytest.raises(ValueError):
                inj.arm("pipeline.dispatch", bad)
            assert not inj.armed and inj.snapshot()["armed"] == {}
    for point, coop in (("pipeline.dispatch", "drop:1"), ("kv.ack", "partial_write:8:1"),
                        ("kv.server.send_result", "pace:10")):
        msgs = []
        for f in (faults, jfaults):
            with pytest.raises(ValueError) as info:
                f.FaultInjector(env="").arm(point, coop)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1] and "does not honor cooperative mode" in msgs[0]
    for point, modes in jfaults.COOPERATIVE_POINTS.items():
        for mode in modes:
            spec = {"drop": "drop:1", "partial_write": "partial_write:8:1", "pace": "pace:10"}[mode]
            inj = faults.FaultInjector(env="")
            inj.arm(point, spec)
            assert inj.snapshot()["armed"] == {point: spec}


@pytest.mark.parametrize("name", sorted(jloadgen.SCENARIOS))
def test_scenarios_give_the_jax_schedule_digest(name):
    assert loadgen.scenario_names() == jloadgen.scenario_names()
    spec, jspec = loadgen.load_scenario(name), jloadgen.load_scenario(name)
    assert spec == jspec
    for seed in (0, 1, 21, 1234):
        sched = loadgen.build_schedule(spec, seed)
        jsched = jloadgen.build_schedule(jspec, seed)
        assert loadgen.schedule_digest(sched) == jloadgen.schedule_digest(jsched)
        assert [(r.index, r.arrival_s, r.klass, r.max_new_tokens, r.shared_prefix)
                for r in sched] == \
            [(r.index, r.arrival_s, r.klass, r.max_new_tokens, r.shared_prefix) for r in jsched]
    assert loadgen.offered_load_rps(spec, sched) == jloadgen.offered_load_rps(jspec, jsched)
    assert loadgen.describe_scenario(spec, sched) == jloadgen.describe_scenario(jspec, jsched)
    got = {k: (t.ttft_s, t.itl_s, t.queue_wait_s) for k, t in loadgen.class_targets(spec).items()}
    want = {k: (t.ttft_s, t.itl_s, t.queue_wait_s)
            for k, t in jloadgen.class_targets(jspec).items()}
    assert got == want


def test_summaries_grade_the_same_outcomes_alike():
    """The pure summary over one set of client outcomes: quantiles,
    attainment, the goodput ledger and the worst-K rows."""
    spec = loadgen.load_scenario("flash_crowd")

    def outcomes(r):
        return [r.RequestOutcome(index=i, klass=("chat", "premium")[i % 2], arrival_s=0.1 * i,
                                 request_id=f"#{i}", queue_s=0.01 * i, ttft_s=0.3 * i,
                                 itl_s=0.05 * (i % 3), total_s=0.3 * i + 1.0, n_tokens=1 + i % 5,
                                 completed=i != 3, failed=i == 5)
                for i in range(9)]

    from lws_tpu.loadgen import runner as jrunner
    from lws_tpu_torch.loadgen import runner

    rep = runner.summarize(runner.RunResult(outcomes(runner), wall_s=2.0),
                           loadgen.class_targets(spec), spec["horizon_s"], "flash_crowd", 3)
    jrep = jrunner.summarize(jrunner.RunResult(outcomes(jrunner), wall_s=2.0),
                             jloadgen.class_targets(spec), spec["horizon_s"], "flash_crowd", 3)
    assert rep == jrep


def test_stack_samplers_fold_the_same_frames_alike():
    """The profile the flight-recorder dump embeds: both samplers fold one
    injected frame dict (a parked thread inside a span and a phase tag)
    into the same collapsed stacks."""
    import sys
    import threading

    from lws_tpu.core import profile as jprofile
    from lws_tpu_torch.core import profile

    parked, release = threading.Event(), threading.Event()

    def park(t, p):
        with t.span("serve.decode_consume"), p.phase("consume"):
            parked.set()
            release.wait(10)

    def sample(t, p):
        tracer = t.Tracer(enabled=True)
        th = threading.Thread(target=park, args=(tracer, p))
        parked.clear()
        release.clear()
        th.start()
        try:
            assert parked.wait(10)
            sampler = p.StackSampler(tracer=tracer, max_stacks=4)
            sampler.sample_once(frames={th.ident: sys._current_frames()[th.ident]})
            snap = sampler.snapshot(limit=4)
        finally:
            release.set()
            th.join()
        # The frames differ only by the package that defines `park`'s callee.
        return [(k.split(";")[:2], v) for k, v in snap["stacks"]], snap["samples"]

    assert sample(trace, profile) == sample(jtrace, jprofile) == \
        ([(["span:serve.decode_consume", "span:consume"], 1)], 1)
