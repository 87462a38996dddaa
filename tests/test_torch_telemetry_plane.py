"""The port's copies of the worker telemetry plane pinned to the JAX
package's: the journey vault (lws_tpu_torch/obs/journey.py), the history
ring (obs/history.py), the profiler's folds and `start_from_env` (core/profile.py), `apply_control`
(core/faults.py), the Watchdog's full rule set (core/flightrecorder.py),
the compile ledger's journey annotation (obs/device.py) and the telemetry
server (runtime/telemetry.py). The same call sequences, with injected
clocks, give equal JSON or byte-identical expositions; both servers,
started over equal state, give every route the same status and body."""

import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from lws_tpu.core import faults as jfaults
from lws_tpu.core import flightrecorder as jfr
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import profile as jprofile
from lws_tpu.core import resilience as jresilience
from lws_tpu.core import slo as jslo
from lws_tpu.core import trace as jtrace
from lws_tpu.obs import decisions as jdecisions
from lws_tpu.obs import device as jdevice
from lws_tpu.obs import history as jhistory
from lws_tpu.obs import journey as jjourney
from lws_tpu.runtime import telemetry as jtelemetry
from lws_tpu_torch.core import faults, flightrecorder, metrics, profile, resilience, slo, trace
from lws_tpu_torch.obs import device, history, journey
from lws_tpu_torch.runtime import telemetry

T0 = 1000.0
# One module set per package; the helpers below take either.
PORT = dict(journey=journey, metrics=metrics, history=history,
            fr=flightrecorder, faults=faults, profile=profile, trace=trace, slo=slo,
            device=device, resilience=resilience, telemetry=telemetry)
JAX = dict(journey=jjourney, metrics=jmetrics, history=jhistory,
           fr=jfr, faults=jfaults, profile=jprofile, trace=jtrace, slo=jslo,
           device=jdevice, resilience=jresilience, telemetry=jtelemetry)


@pytest.fixture
def frozen_wall(monkeypatch):
    """time.time() frozen (journeys stamp completed_unix, ledgers their
    records with it) so two packages' runs give equal JSON."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)


def both(fn, *args):
    """`fn` over the port's modules and over JAX's; asserts the results
    equal and returns the port's."""
    got, want = fn(PORT, *args), fn(JAX, *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Journey vault


def span_rec(tid: str, sid: str, parent=None, name: str = "serve.prefill", **attrs) -> dict:
    return {"name": name, "trace_id": tid, "span_id": sid, "parent_id": parent,
            "start_unix": 1.0, "duration_s": 0.5, "status": "ok", "attrs": attrs}


def timeline(rid: str, tid: str, sid: str, ttft: float, ok: bool = True, **extra) -> dict:
    return {"engine": "disagg", "klass": extra.pop("klass", "chat"), "revision": "",
            "request_id": rid, "trace": {"trace_id": tid, "span_id": sid},
            "queue_wait_s": 0.01, "ttft_s": ttft, "worst_itl_s": 0.002, "total_s": ttft + 0.1,
            "tokens": 7, "good_tokens": 7 if ok else 3, "ok": ok,
            "targets": {"ttft_s": 0.5, "itl_s": 0.05, "queue_wait_s": 0.2}, **extra}


def _vault_run(pkg, case: str):
    """One call sequence through a private JourneyVault: every feed (spans,
    events, timelines, annotations, direct completions) and the retention
    classes, under caps and budgets chosen by `case`."""
    j, m = pkg["journey"], pkg["metrics"]
    reg = m.MetricsRegistry()
    clock = [T0]
    rolls = iter([0.01, 0.9, 0.01, 0.9, 0.01, 0.9] * 8)
    kw = dict(registry=reg, rng=lambda: next(rolls), clock=lambda: clock[0],
              sample_rate=0.05, retention_s=100.0)
    kw.update({
        "retention": dict(slowest_k=2),
        "caps": dict(slowest_k=2, max_spans_per_journey=3, max_open_traces=2),
        "budget": dict(slowest_k=2, budget_records=12),
        "source": dict(slowest_k=4, source_budget_records=6),
    }[case])
    v = j.JourneyVault(**kw)
    for i in range(8):
        tid, rid = f"t{i:02d}", f"r{i}"
        for k in range(4):
            v.on_span(span_rec(tid, f"s{i}{k}", parent=f"root{i}", name=f"leg{k}"))
        if i == 1:
            v.on_event({"kind": "retry", "site": "kv.pull_bundle",
                        "trace": {"trace_id": tid, "span_id": "x"}})
        if i == 2:
            v.on_event({"kind": "fault_injected", "request_id": rid, "point": "kv.ack"})
        if i == 3:
            v.annotate(rid, chunks=[{"chunk": c, "t_s": 0.1 * c, "bytes": 64} for c in range(3)])
        clock[0] += 1.0
        if i == 4:
            v.complete(rid, trace={"trace_id": tid, "span_id": f"root{i}"}, engine="disagg",
                       outcome="errored", error="RuntimeError('boom')")
        elif i == 5:
            v.complete(rid, trace={"trace_id": tid}, engine="disagg",
                       outcome="deadline_expired")
        else:
            v.on_timeline(timeline(rid, tid, f"root{i}", 0.05 * (i + 1), ok=i != 6,
                                   klass="chat" if i % 2 else "batch"))
        # The root closes after its completion and attaches to the journey.
        v.on_span(span_rec(tid, f"root{i}", name="serve.request"))
    v.annotate("r3", chunks_produced=[{"chunk": 0, "t_s": 0.0}])  # post-retention growth
    v.on_event({"kind": "kv_requeue", "request_id": "r7"})  # upgrades a healthy keep
    out = {
        "index": {o: v.index(outcome=o, limit=64) for o in j.OUTCOMES},
        "chat": v.index(klass="chat"),
        "get": {k: v.get(k) for k in ["r0", "r1", "r2", "r3", "r4", "r5", "r6", "r7", "t03",
                                      "nope"]},
        "worst": v.worst(limit=4),
        "stats": v.stats(),
        "open": v.spans_for_trace("t99"),
        "metrics": reg.render(),
    }
    clock[0] += 500.0  # every kept journey ages out
    out["aged"] = (v.index(), reg.render())
    with pytest.raises(ValueError) as info:
        v.index(outcome="bogus")
    out["refusal"] = str(info.value)
    return out


@pytest.mark.parametrize("case", ["retention", "caps", "budget", "source"])
def test_journey_vaults_keep_and_drop_alike(frozen_wall, case):
    out = both(_vault_run, case)
    assert "serving_journeys_retained_total" in out["metrics"]
    kept = {row["id"]: row["outcome"] for row in out["index"]["all"]}
    if case == "retention":
        # The must-keep classes and the healthy tail, as JAX's vault keeps them.
        assert kept["r4"] == "errored" and kept["r5"] == "deadline_expired"
        assert kept["r6"] == "breached" and kept["r1"] == "retried" and kept["r2"] == "fault"
        assert out["get"]["r3"]["annotations"]["chunks"][2]["bytes"] == 64
    if case == "caps":
        assert all(len(j["spans"]) <= 3 for j in out["get"].values() if j)
        assert 'reason="journey_span_cap"' in out["metrics"]


def _journey_verdicts(pkg):
    j = pkg["journey"]
    base = {"timeline": {"ttft_s": 2.0, "queue_wait_s": 0.1, "worst_itl_s": 0.01,
                         "targets": {"ttft_s": 0.5, "itl_s": 0.05, "queue_wait_s": 0.2}}}
    cases = [
        {"flags": ["errored"], "timeline": {"error": "x"}},
        {"flags": ["deadline_expired"]},
        {"flags": ["breached"], **base},
        {"flags": ["breached"], "timeline": {"ttft_s": 0.1, "targets": {"ttft_s": 0.5}}},
        {"flags": ["retried"], "timeline": {"ttft_s": 0.1}},
        {"flags": [], **base, "annotations": {"compiles": [{"seconds": 1.0, "kind": "first"}]}},
    ]
    return [{k: v for k, v in j.verdict(c).items() if k != "text"} for c in cases]


def test_journey_verdicts_name_the_same_phase():
    assert both(_journey_verdicts)[-1]["phase"] == "compile"


def _local_journeys(pkg, monkeypatch):
    """local_journey over the process VAULT and TRACER: the vault's
    completed journey, an in-flight trace buffer, the span ring's fallback
    for a request the vault never kept, and an unknown id."""
    j, t = pkg["journey"], pkg["trace"]
    j.VAULT.clear()
    t.TRACER.clear()
    monkeypatch.setattr(t.TRACER, "enabled", True)
    monkeypatch.setattr(t.TRACER, "sample_rate", 1.0)
    random.seed(5)  # both tracers draw their ids from `random`
    with t.TRACER.span("serve.request", request_id="ring-only"):
        with t.TRACER.span("kv.gather"):
            pass
    j.VAULT.on_span(span_rec("open1", "a1"))
    j.VAULT.complete("kept", trace={"trace_id": "tk", "span_id": "rk"}, outcome="errored")
    keys = ("kept", "tk", "open1", "ring-only", "nope")
    out = {}
    for key in keys:
        got = j.local_journey(key)
        if got is not None:
            got["spans"] = [{k: v for k, v in s.items() if k not in ("start_unix", "duration_s")}
                            for s in got["spans"]]
        out[key] = got
    j.VAULT.clear()
    t.TRACER.clear()
    return out


def test_local_journeys_fall_back_alike(frozen_wall, monkeypatch):
    out = both(_local_journeys, monkeypatch)
    assert out["kept"]["source"] == "vault" and out["kept"]["completed"]
    assert out["open1"]["outcome"] == "open"
    assert out["ring-only"]["source"] == "ring" and len(out["ring-only"]["spans"]) == 1
    assert out["nope"] is None


def _install_feeds(pkg, monkeypatch):
    """install() wires the process vault onto the process tracer, flight
    recorder and SLO recorder: a request's spans, a retry event and its
    timeline join one journey."""
    j, t, fr, s = pkg["journey"], pkg["trace"], pkg["fr"], pkg["slo"]
    j.VAULT.clear()
    monkeypatch.setattr(t.TRACER, "enabled", True)
    monkeypatch.setattr(t.TRACER, "sample_rate", 1.0)
    monkeypatch.setattr(s.RECORDER, "journey_sinks", [])
    monkeypatch.setattr(t.TRACER, "_finish_listeners", [])
    monkeypatch.setattr(fr.RECORDER, "_observers", [])
    monkeypatch.setattr(j, "_INSTALLED", False)
    assert j.install() is j.VAULT and j.install() is j.VAULT
    random.seed(9)
    with t.TRACER.span("serve.request", request_id="rq"):
        with t.TRACER.span("serve.prefill"):
            pass
        fr.RECORDER.record("retry", site="kv.pull_bundle")
        tl = s.RECORDER.request("disagg", request_id="rq")
        tl.queue_wait(0.0)
        tl.first_token(0.01)
        tl.finish()
    got = j.VAULT.get("rq")
    j.VAULT.clear()
    return {"flags": got["flags"], "outcome": got["outcome"], "completed": got["completed"],
            "spans": [sp["name"] for sp in got["spans"]],
            "events": [e["kind"] for e in got["events"]]}


def test_install_joins_the_process_feeds_alike(frozen_wall, monkeypatch):
    out = both(_install_feeds, monkeypatch)
    assert out == {"flags": ["retried"], "outcome": "retried", "completed": True,
                   "spans": ["serve.prefill", "serve.request"], "events": ["retry"]}


def test_journeys_kill_switch_disables_every_entry_point(monkeypatch):
    monkeypatch.setenv("LWS_TPU_JOURNEYS", "0")
    v = journey.JourneyVault(registry=metrics.MetricsRegistry())
    assert journey.install() is None
    v.annotate("r", chunks=[1])
    assert v.complete("r", outcome="errored") is None and v.stats()["pending"] == 0


# ---------------------------------------------------------------------------
# History ring


def expo(m, requests: float, hbm: float, extra: dict) -> str:
    reg = m.MetricsRegistry()
    reg.inc("serving_requests_total", {"engine": "disagg"}, requests)
    reg.set("serving_hbm_bytes_in_use", hbm, {"device": "gpu:0"})
    reg.observe("serving_ttft_seconds", 0.02 * requests, {"engine": "disagg"})
    for name, labels in extra.items():
        reg.set("serving_slo_attainment", 1.0, dict(labels))
    return reg.render()


def _history_run(pkg, max_series: int, per_source: int):
    h, m = pkg["history"], pkg["metrics"]
    own = m.MetricsRegistry()
    ring = h.HistoryRing(interval_s=5.0, retention_s=60.0, max_series=max_series,
                         metrics_registry=own, max_series_per_source=per_source)
    klasses = {f"k{i}": {"engine": "disagg", "klass": f"k{i}", "instance": "w0"}
               for i in range(4)}
    out = {"appended": []}
    for t, (req, hbm, extra) in enumerate([
        (3, 1e9, klasses), (5, 2e9, klasses), (2, 3e9, {}),  # counter reset, series retired
        (4, 3e9, {}), (9, 1e9, {}),
    ]):
        out["appended"].append(ring.ingest(expo(m, req, hbm, extra), now=T0 + 10 * t))
    out["due"] = [ring.ingest_if_due(expo(m, 10, 1e9, {}), now=T0 + d) for d in (41, 46, 52)]
    out["window"] = ring.window("serving_requests_total", {"engine": "disagg"},
                                window_s=25, now=T0 + 50)
    out["series"] = ring.series("serving_ttft_seconds_count")
    out["age"] = ring.last_ingest_age(now=T0 + 60)
    out["snapshot"] = ring.snapshot(limit=6, max_points=3)
    out["full"] = ring.snapshot()
    seeded = h.HistoryRing(interval_s=5.0, retention_s=60.0)
    out["loaded"] = seeded.load_snapshot(out["full"], now=T0 + 500)
    out["seeded"] = seeded.snapshot()
    out["own"] = own.render()
    ring.ingest(expo(m, 1, 1e9, {}), now=T0 + 200)  # everything else aged out
    out["aged"] = ring.snapshot()
    with pytest.raises(ValueError):
        ring.ingest("not an exposition{", now=T0 + 201)
    return out


@pytest.mark.parametrize("max_series,per_source", [(4096, 256), (8, 256), (4096, 2)],
                         ids=["default", "series-cap", "source-cap"])
def test_history_rings_hold_the_same_points(max_series, per_source):
    out = both(_history_run, max_series, per_source)
    pts = [v for _, v in dict((s["name"], s) for s in out["full"]["series"]
                              if s["name"] == "serving_requests_total")
           ["serving_requests_total"]["points"]]
    assert pts == sorted(pts)  # reset-adjusted: never a negative step
    if max_series == 8 or per_source == 2:
        assert "lws_history_series_dropped_total" in out["own"]


# ---------------------------------------------------------------------------
# Profiler


STACKS = [["span:serve.request;span:kv.gather;worker.py:run;engine.py:prefill", 7],
          ["span:serve.request;worker.py:run;engine.py:decode", 5],
          ["threading.py:run;socket.py:recv", 11],
          ["span:serve.decode_dispatch;pipeline.py:flush", 2]]


def fake_frame(stack: str):
    """The innermost frame of `stack` ("module:qualname;..." outermost
    first) in the shape `sys._current_frames()` gives the sampler."""
    from types import SimpleNamespace

    frame = None
    for part in stack.split(";"):
        module, name = part.split(":")
        frame = SimpleNamespace(f_code=SimpleNamespace(co_qualname=name, co_name=name),
                                f_globals={"__name__": module}, f_back=frame)
    return frame


SAMPLED = [("worker:run;engine:prefill", 3), ("worker:run;engine:decode", 2),
           ("threading:run;socket:recv", 4), ("pipeline:flush", 1)]


def _profile_folds(pkg):
    p = pkg["profile"]
    sampler = p.StackSampler(hz=50.0, max_stacks=3, tracer=pkg["trace"].Tracer())
    for i, (stack, count) in enumerate(SAMPLED):  # the fourth novel stack is dropped
        for _ in range(count):
            sampler.sample_once(frames={10_000 + i: fake_frame(stack)})
    snap = sampler.snapshot()
    return {"fold": p.fold_by_span(STACKS), "top": p.top_frames(STACKS),
            "merge": p.merge_collapsed([({"instance": "w0", "role": "decode"}, {"stacks": STACKS}),
                                        ({}, {"stacks": STACKS[:1]})]),
            "collapsed": sampler.collapsed(), "collapsed2": sampler.collapsed(2),
            "snapshot": snap}


def test_profiler_folds_alike():
    out = both(_profile_folds)
    assert out["fold"] == {"kv.gather": 7, "serve.request": 5, "-": 11,
                           "serve.decode_dispatch": 2}
    assert out["collapsed"].splitlines()[0] == "threading:run;socket:recv 4"
    assert out["snapshot"]["dropped_stacks"] == 1


@pytest.mark.parametrize("raw,hz", [(None, None), ("", None), ("x", None), ("0", None),
                                    ("-3", None), ("41", 41.0)])
def test_profilers_start_from_env_alike(monkeypatch, raw, hz):
    for p in (profile, jprofile):
        if raw is None:
            monkeypatch.delenv("LWS_TPU_PROFILE_HZ", raising=False)
        else:
            monkeypatch.setenv("LWS_TPU_PROFILE_HZ", raw)
        monkeypatch.setattr(p, "PROFILER", p.StackSampler())
        got = p.start_from_env()
        try:
            assert (got is p.PROFILER and got.running and got.hz == hz) if hz else got is None
        finally:
            p.PROFILER.stop()


# ---------------------------------------------------------------------------
# Fault control


CONTROLS = [
    {"arm": {"pipeline.dispatch": "fail_n_times:2", "kv.ack": "drop:1"}},
    {"arm": {"disagg.decode.process": "fail_n_times:1"}, "disarm": ["kv.ack"]},
    {"clear": True, "arm": {"kv.stream.send_chunk": "partial_write:8:1"}},
    {"disarm": ["never.armed"]},
    {},
    {"clear": True},
    [1, 2],
    {"arm": ["kv.ack"]},
    {"arm": {"kv.ack": "nope"}},
    {"arm": {"pipeline.dispatch": "drop:1"}},  # cooperative mode at a point that can't honor it
    {"bogus": 1, "arm": {}},
]


def _controls(pkg):
    f = pkg["faults"]
    f.INJECTOR.disarm()
    out = []
    try:
        for payload in CONTROLS:
            try:
                out.append(("ok", f.apply_control(payload)))
            except ValueError as e:
                out.append(("400", str(e)))
    finally:
        f.INJECTOR.disarm()
    return out


def test_fault_controls_apply_and_refuse_alike():
    out = both(_controls)
    assert [k for k, _ in out] == ["ok"] * 6 + ["400"] * 5
    assert out[1][1]["armed"] == {"pipeline.dispatch": "fail_n_times:2",
                                  "disagg.decode.process": "fail_n_times:1"}


# ---------------------------------------------------------------------------
# Watchdog: the full rule set


KNOBS = {"LWS_TPU_WATCHDOG_STALL_S": "7", "LWS_TPU_WATCHDOG_STREAK": "12",
         "LWS_TPU_WATCHDOG_DEPTH": "3", "LWS_TPU_WATCHDOG_SUSTAIN_S": "2",
         "LWS_TPU_WATCHDOG_TRIP_WINDOW_S": "4"}


def rule_shape(rule) -> tuple:
    return (type(rule).__name__,) + tuple(sorted(vars(rule).items()))


def _watchdog_full(pkg):
    fr = pkg["fr"]
    rec = fr.FlightRecorder()
    wd = fr.Watchdog(recorder=rec, rules=fr.default_rules())
    beats = [  # (t, source, progress, depth)
        (0, "decode_ring:disagg", 1, 1), (0, "reconcile:lws/a", 0, 150),
        (0, "kv_backlog:9000", 1, 10), (0, "breaker:prefill@h:1", 0.0, 1),
        (0, "deadline_trips:decode.admit", 1, 0), (0, "burn_rate:disagg/chat", 0.0, 1),
        (0, "canary:lws/r2", 0.0, 1), (0, "compile_storm:flash", 0.0, 4),
        (0, "hbm_pressure:gpu:0", 0.0, 1.2),
        (3, "kv_backlog:9000", 1, 10), (3, "reconcile:lws/a", 0, 150),
        (9, "kv_backlog:9000", 2, 2), (9, "breaker:prefill@h:1", 0.0, 0),
        (9, "decode_ring:disagg", 1, 1), (9, "deadline_trips:decode.admit", 2, 0),
        (40, "decode_ring:disagg", 2, 0),
    ]
    out = []
    for t in (1, 2.5, 4, 6, 8, 10, 12, 20, 35, 41):
        for bt, src, prog, depth in beats:
            if bt <= t and bt > t - 2.5 or (bt == 0 and t == 1):
                rec.beat(src, progress=prog, depth=depth, now=T0 + bt)
        firing = wd.check_now(now=T0 + t)
        out.append({k: sorted(h["source"] for h in v) for k, v in firing.items()})
    out.append([(e["kind"], e.get("watchdog")) for e in rec.events()])
    return out


@pytest.mark.parametrize("knobs", [{}, KNOBS], ids=["defaults", "env-knobs"])
def test_watchdog_default_rules_equal_jax(monkeypatch, knobs):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    port = [rule_shape(r) for r in flightrecorder.default_rules()]
    assert port == [rule_shape(r) for r in jfr.default_rules()]
    assert len(port) == 9 and ("StallRule", ("name", "decode_ring_stall"),
                               ("pattern", "decode_ring:*"),
                               ("stall_after_s", float(knobs.get("LWS_TPU_WATCHDOG_STALL_S",
                                                                 30)))) in port
    out = both(_watchdog_full)
    fired = {k for step in out[:-1] for k in step}
    assert {"reconcile_hot_loop", "circuit_open", "deadline_tripped", "burn_rate",
            "canary_regression", "compile_storm", "hbm_pressure"} <= fired


def test_a_port_breaker_fires_circuit_open_once(monkeypatch):
    """The port's CircuitBreaker beats `breaker:*` on the process recorder;
    a Watchdog with the default rules alerts once per open episode."""
    rec = flightrecorder.FlightRecorder()
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(flightrecorder, "RECORDER", rec)
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    now = [T0]
    br = resilience.CircuitBreaker("prefill@127.0.0.1:9", failure_threshold=2,
                                   reset_timeout_s=5.0, clock=lambda: now[0])
    wd = flightrecorder.Watchdog(recorder=rec)  # the breaker beats on the real clock
    assert "circuit_open" not in wd.check_now()
    for _ in range(2):
        br.record_failure()
    for _ in range(3):
        time.sleep(0.01)
        assert [h["source"] for h in wd.check_now()["circuit_open"]] == \
            ["breaker:prefill@127.0.0.1:9"]
    now[0] += 6.0
    assert br.allow()  # the half-open probe
    br.record_success()
    assert "circuit_open" not in wd.check_now()
    assert reg.counter_value("lws_watchdog_alerts_total", {"watchdog": "circuit_open"}) == 1
    dumps = [e for e in rec.events() if e["kind"] == "watchdog_alert"]
    assert [e["watchdog"] for e in dumps] == ["circuit_open"]
    assert {"journeys", "history", "decisions", "compiles"} <= set(wd.last_dump)


# ---------------------------------------------------------------------------
# Compile ledger -> journey


def _compile_annotations(pkg):
    d, j = pkg["device"], pkg["journey"]
    j.VAULT.clear()
    led = d.CompileLedger(recorder=pkg["fr"].FlightRecorder(), storm_n=2, storm_window_s=60)
    with d.compile_site("disagg.decode", engine="disagg", shape="steps6/g0", request_id="rq"):
        led.observe(1.25, now=T0, unix=5.0)
        with d.compile_site("inner", engine="disagg"):  # innermost wins: no request here
            led.observe(0.5, now=T0 + 1, unix=6.0)
        led.observe(0.75, executable="disagg.decode", now=T0 + 2, unix=7.0)
    led.observe(0.1, executable="x", request_id="other", now=T0 + 3, unix=8.0)
    out = {"rq": j.VAULT.get("rq")["annotations"], "other": j.VAULT.get("other")["annotations"],
           "records": [{k: v for k, v in r.items() if k != "trace"} for r in led.records()]}
    j.VAULT.clear()
    return out


def test_compiles_annotate_the_request_journey_alike(frozen_wall):
    out = both(_compile_annotations)
    assert [c["seconds"] for c in out["rq"]["compiles"]] == [1.25, 0.75]


STUB_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
printf 'stub library' > "$out"
"""


def test_a_kernel_build_under_a_request_annotates_its_journey(tmp_path, monkeypatch):
    """ops/_ext.py:build records each source it compiles on the calling
    thread, so a first-use build inside a request's compile site lands on
    that request's journey (a stub nvcc here)."""
    import stat

    from lws_tpu_torch.ops import _ext

    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text("// a stub source\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_ext, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(device, "LEDGER", device.CompileLedger(
        recorder=flightrecorder.FlightRecorder()))
    journey.VAULT.clear()
    try:
        with device.compile_site("disagg.decode", engine="disagg", request_id="req-b"):
            assert sorted(_ext.build(["stub"])) == ["stub"]
        rec = device.LEDGER.records()
        assert [(r["executable"], r["request_id"]) for r in rec] == [("stub", "req-b")]
        got = journey.VAULT.get("req-b")["annotations"]["compiles"]
        assert [(c["executable"], c["kind"]) for c in got] == [("stub", "first")]
        assert got[0]["seconds"] == rec[0]["seconds"] > 0
    finally:
        journey.VAULT.clear()


# ---------------------------------------------------------------------------
# The decode role's endings


def test_a_decode_fault_is_redelivered_and_a_poison_bundle_ends_errored():
    """JAX's at-least-once contract: a failure raised at
    `disagg.decode.process` leaves the bundle unacked, prefill re-queues
    it, and the next pull decodes it (no failed result, no journey). A
    bundle past the decode budget is the request's ending: a failed result
    and a journey kept errored."""
    import numpy as np

    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt

    engine = dw.build_engine(batch=1, max_len=16, device="cpu")
    token, cache = engine.prefill(np.array([[5, 9, 2, 11, 7]], dtype=np.int32))
    server = kt.KVServer(port=0, host="127.0.0.1")
    ep = ("127.0.0.1", server.port)
    journey.VAULT.clear()
    try:
        server.offer_bundle({"id": "r"}, kt.cache_to_bundle(cache, token))
        process = dw.decode_processor(engine, server, steps=3)
        faults.INJECTOR.arm("disagg.decode.process", "fail_n_times:1")
        with pytest.raises(OSError):
            kt.pull_bundle(ep, timeout=1.0, process=process)
        assert kt.pull_result(ep, "r") is None and journey.VAULT.get("r") is None
        kt.pull_bundle(ep, timeout=5.0, process=process)  # the redelivery
        meta, payload = kt.pull_result(ep, "r")
        assert "failed" not in meta and kt.bytes_to_arrays(payload)["tokens"].shape == (1, 4)
        assert faults.INJECTOR.snapshot()["trips"] == {"disagg.decode.process": 1}
        process({"id": "p"}, kt.PoisonPayload(ValueError("20 KV rows but decode max_len=16")))
        meta, _ = kt.pull_result(ep, "p")
        assert "max_len" in meta["failed"]
        leg = journey.VAULT.get("p")
        assert leg["outcome"] == "errored" and "errored" in leg["flags"], leg
    finally:
        faults.INJECTOR.disarm()
        journey.VAULT.clear()
        server.close()


# ---------------------------------------------------------------------------
# The telemetry servers


def clear_state(pkg):
    """Empty one package's process globals that the servers read."""
    pkg["trace"].TRACER.clear()
    pkg["fr"].RECORDER.clear()
    pkg["faults"].INJECTOR.disarm()
    pkg["profile"].PROFILER.clear()
    pkg["device"].LEDGER.clear()
    pkg["history"].HISTORY.clear()
    jdecisions.DECISIONS.clear()  # the port's window is always empty
    pkg["journey"].VAULT.clear()


def seed_state(pkg):
    """Equal, deterministic contents in one package's process globals."""
    clear_state(pkg)
    pkg["history"].HISTORY.ingest(expo(pkg["metrics"], 3, 1e9, {}), now=T0)
    pkg["journey"].VAULT.complete("req1", trace={"trace_id": "tq", "span_id": "sq"},
                                  engine="disagg", outcome="errored", error="boom", now=T0)
    pkg["device"].LEDGER.observe(0.5, executable="flash_attention", request_id="req1",
                                 now=T0, unix=9.0)
    pkg["profile"].PROFILER.sample_once(frames={10_000: fake_frame(SAMPLED[0][0])})


def server_for(pkg, token):
    reg = pkg["metrics"].MetricsRegistry()
    reg.inc("serving_requests_total", {"engine": "disagg"}, 3)
    reg.observe("serving_ttft_seconds", 0.03, {"engine": "disagg", "role": "prefill"},
                exemplar={"trace_id": "00ff", "span_id": "01"})
    wd = pkg["fr"].Watchdog(recorder=pkg["fr"].FlightRecorder(), rules=[])
    srv = pkg["telemetry"].TelemetryServer(port=0, host="127.0.0.1", token=token,
                                           registry=reg, watchdog=wd)
    srv.start()
    return srv


GETS = ["/healthz", "/metrics", "/metrics#om", "/debug/traces", "/debug/traces?limit=x",
        "/debug/traces?limit=-1", "/debug/flightrecorder?limit=4", "/debug/flightrecorder?limit=",
        "/debug/profile", "/debug/profile?format=collapsed", "/debug/profile?format=svg",
        "/debug/profile?limit=x", "/debug/history?limit=2", "/debug/history?limit=no",
        "/debug/decisions", "/debug/decisions?limit=-2", "/debug/requests",
        "/debug/requests?outcome=errored", "/debug/requests?outcome=bogus",
        "/debug/requests?limit=z", "/debug/request/req1", "/debug/request/tq",
        "/debug/request/unknown", "/debug/prefixes", "/debug/prefixes?limit=q",
        "/debug/compile?limit=5", "/debug/compile?limit=1.5", "/debug/faults", "/nope"]
POSTS = [("/debug/faults", '{"arm": {"kv.ack": "fail_n_times:1"}}'),
         ("/debug/faults", '{"arm": {"kv.ack": "nope"}}'), ("/debug/faults", "{not json"),
         ("/debug/faults", '{"disarm": ["kv.ack"]}'), ("/debug/faults", ""),
         ("/debug/nope", "{}"), ("/debug/drain", "")]


def fetch(port: int, path: str, token, body=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    if path.endswith("#om"):
        path, headers["Accept"] = path[:-3], "application/openmetrics-text"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers,
                                 data=None if body is None else body.encode())
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def normalized(path: str, body: str):
    """Bodies as JSON where they are JSON, with the per-process wall stamps
    (journey completion, flight-recorder event times) that no injected
    clock reaches dropped."""
    if path.startswith("/metrics") or "collapsed" in path or path == "/healthz":
        return body
    data = json.loads(body)

    def scrub(x):
        if isinstance(x, dict):
            return {k: scrub(v) for k, v in x.items()
                    if k not in ("completed_unix", "t", "unix", "beat_age_s", "advance_age_s")}
        if isinstance(x, list):
            return [scrub(v) for v in x]
        return x

    return scrub(data)


@pytest.fixture
def servers(frozen_wall, monkeypatch):
    for pkg in (PORT, JAX):
        monkeypatch.setattr(pkg["resilience"], "DRAIN", pkg["resilience"].DrainGate())
        seed_state(pkg)
    yield
    for pkg in (PORT, JAX):
        clear_state(pkg)


@pytest.mark.parametrize("token", [None, "s3cret"], ids=["open", "bearer"])
def test_telemetry_servers_answer_every_route_alike(servers, token):
    srv, jsrv = server_for(PORT, token), server_for(JAX, token)
    try:
        for path in GETS:
            for tok in ({token, None} if token else {None}):
                got, want = fetch(srv.port, path, tok), fetch(jsrv.port, path, tok)
                assert got[:2] == want[:2], (path, tok, got, want)
                assert normalized(path, got[2]) == normalized(path, want[2]), (path, tok)
                if token and not tok and path != "/healthz":
                    assert got[0] == 401
        for path, body in POSTS:
            for tok in ({token, None} if token else {None}):
                got, want = fetch(srv.port, path, tok, body), fetch(jsrv.port, path, tok, body)
                assert got == want, (path, body, tok)
        assert resilience.DRAIN.draining and jresilience.DRAIN.draining
    finally:
        srv.stop()
        jsrv.stop()


def test_process_metrics_read_device_memory_and_feed_history(servers, monkeypatch):
    """Without a registry override, /metrics refreshes the device-memory
    gauges (CUDA allocator stats; a stand-in reading here), the SLO windows
    and the history ring, then renders the process registry."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    monkeypatch.setattr(history, "HISTORY", history.HistoryRing(interval_s=0.0))

    def stats():
        labels = {"device": "gpu:0"}
        metrics.set("serving_hbm_bytes_in_use", 3e9, labels)
        metrics.set("serving_hbm_bytes_limit", 8e10, labels)
        return [{"device": "gpu:0", "in_use": 3e9, "limit": 8e10, "peak": 4e9}]

    monkeypatch.setattr(profile, "record_device_memory", stats)
    srv = telemetry.TelemetryServer(port=0, host="127.0.0.1")
    srv.start()
    try:
        code, ctype, body = fetch(srv.port, "/metrics", None)
    finally:
        srv.stop()
    assert code == 200 and ctype == "text/plain"
    fams = metrics.parse_exposition(body)
    assert fams["serving_hbm_peak_bytes"]["samples"][0][2] == 4e9
    assert fams["serving_hbm_bytes_limit"]["samples"][0][1] == {"device": "gpu:0"}
    assert history.HISTORY.series("serving_hbm_bytes_in_use")


def test_start_from_env_starts_the_plane_and_refuses_a_taken_port(monkeypatch):
    monkeypatch.delenv(telemetry.METRICS_PORT_ENV, raising=False)
    assert telemetry.start_from_env() is None
    started = []
    monkeypatch.setattr(journey, "install", lambda: started.append("journeys"))
    monkeypatch.setattr(history, "start_from_env", lambda: started.append("history"))
    monkeypatch.setattr(profile, "start_from_env", lambda: started.append("profile"))
    monkeypatch.setattr(device, "arm_from_env", lambda: started.append("compiles"))
    monkeypatch.setenv(telemetry.METRICS_PORT_ENV, "0")
    monkeypatch.setenv(telemetry.METRICS_TOKEN_ENV, "tok")
    srv = telemetry.start_from_env()
    try:
        assert sorted(started) == ["compiles", "history", "journeys", "profile"]
        assert isinstance(srv.watchdog, flightrecorder.Watchdog)
        assert [r.name for r in srv.watchdog.rules] == \
            [r.name for r in flightrecorder.default_rules()]
        assert fetch(srv.port, "/debug/faults", None)[0] == 401
        assert fetch(srv.port, "/debug/faults", "tok")[0] == 200
        # A declared port that is taken fails the start: no fallback port.
        monkeypatch.setenv(telemetry.METRICS_PORT_ENV, str(srv.port))
        with pytest.raises(OSError):
            telemetry.start_from_env()
    finally:
        srv.stop()


def test_a_scraper_hanging_up_leaves_no_traceback(capsys):
    """A client that closes mid-response is its own failure; the server
    prints nothing for it and keeps serving."""
    import socket

    srv = telemetry.TelemetryServer(port=0, host="127.0.0.1",
                                    registry=metrics.MetricsRegistry())
    srv.start()
    try:
        for _ in range(20):
            with socket.create_connection(("127.0.0.1", srv.port)) as s:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, b"\x01\x00\x00\x00\x00\x00\x00\x00")
                s.sendall(b"GET /debug/traces HTTP/1.1\r\nHost: x\r\n\r\n")
        assert fetch(srv.port, "/healthz", None)[0] == 200
        assert srv._httpd.request_queue_size == 128
    finally:
        srv.stop()
    time.sleep(0.2)
    assert "Traceback" not in capsys.readouterr().err


def test_concurrent_scrapes_all_answer():
    reg = metrics.MetricsRegistry()
    reg.inc("serving_requests_total", {"engine": "disagg"})
    srv = telemetry.TelemetryServer(port=0, host="127.0.0.1", registry=reg)
    srv.start()
    codes = []
    try:
        threads = [threading.Thread(target=lambda: codes.append(
            fetch(srv.port, "/metrics", None)[0])) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        srv.stop()
    assert codes == [200] * 32


def test_telemetry_imports_no_serving_stack():
    """The server loads the serving stack's kv_host_arena only when
    /debug/prefixes is asked for."""
    import subprocess

    code = ("import sys; import lws_tpu_torch.runtime.telemetry; "
            "print('lws_tpu_torch.serving.kv_host_arena' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["False"]


@pytest.fixture
def worker_feeds(monkeypatch):
    """Both packages' journey feeds installed and tracing on, as a worker
    runs (`journey.install()`, `_force_tracing`); each package's feeds, its
    VAULT and its fault INJECTOR put back afterwards. The default SLO
    targets are out of reach, so that no journey is flagged breached by
    how fast this machine decodes. `_INSTALLED` is cleared before each
    `install()`, so the feeds land on the process defaults as they are
    now, even where an earlier test in the process left it set after
    wiring them onto objects it had swapped in (`install()` is idempotent
    per feed); `restore_journey_feeds` puts the flag back."""
    from tests.test_torch_fleet import journey_feeds, restore_journey_feeds

    planes = {id(pkg): (pkg["journey"], pkg["trace"], pkg["fr"], pkg["slo"])
              for pkg in (PORT, JAX)}
    found = {k: journey_feeds(*v) for k, v in planes.items()}
    for pkg in (PORT, JAX):
        monkeypatch.setattr(pkg["trace"].TRACER, "enabled", True)
        monkeypatch.setattr(pkg["trace"].TRACER, "sample_rate", 1.0)
        monkeypatch.setattr(pkg["slo"].RECORDER, "targets", pkg["slo"].SLOTargets(
            ttft_s=1e9, itl_s=1e9, queue_wait_s=1e9))
        pkg["journey"].VAULT.clear()
        pkg["journey"]._INSTALLED = False
        pkg["journey"].install()
    yield
    for pkg in (PORT, JAX):
        restore_journey_feeds(found[id(pkg)], *planes[id(pkg)])
        pkg["faults"].INJECTOR.disarm()


def jax_decode_process(engine, server, steps: int):
    """The decode role's `process(meta, payload)` of JAX's worker
    (lws_tpu/serving/disagg_worker.py:521-598, a closure of
    `run_decode_tcp`), restated over JAX's own module functions for the
    steps this drill reaches: the chaos hook, the replay guard, the decode
    under its `serve.request` span and its result, or the poison guard's
    errored journey and failed result. The closure cannot be imported, so
    each statement restated here is first found in its source: a change
    there fails this test instead of leaving the copy behind."""
    import inspect

    from lws_tpu.serving import disagg_worker as jdw
    from lws_tpu.serving import kv_transport as jkt

    source = " ".join(inspect.getsource(jdw.run_decode_tcp).split())
    at = 0
    for statement in (
            'def process(meta, payload):',
            'faults.fire("disagg.decode.process")',
            'if seen.contains(meta["id"]):',
            'return',
            's_req = trace.span( "serve.request", parent=meta.get("trace"), '
            'role="decode", request_id=meta["id"], )',
            'full, dstats, dspans = _decode_bundle( engine, payload, steps,',
            'klass=str(meta.get("klass") or ""), request_id=meta["id"], )',
            'except Exception as e:',
            'journeymod.VAULT.complete( meta["id"], trace=meta.get("trace"), '
            'engine="disagg", klass=str(meta.get("klass") or ""), '
            'outcome="errored", error=repr(e), )',
            'server.post_result(meta["id"], {"id": meta["id"], "failed": repr(e)[:300]}, b"")',
            'seen.record(meta["id"])',
            'handoff = {**meta.get("handoff", {}), **dstats}',
            'spans_out = list(meta.get("spans", [])) + dspans + [s_req.to_dict()]',
            'server.post_result( meta["id"], {"id": meta["id"], "handoff": handoff, '
            '"spans": spans_out}, kt.arrays_to_bytes(tokens=full), )',
            'seen.record(meta["id"])'):
        found = source.find(statement, at)
        assert found >= 0, f"JAX's decode closure changed at: {statement}"
        at = found + len(statement)
    seen = jresilience.SeenIds(capacity=1024, site="decode")

    def process(meta, payload):
        jfaults.fire("disagg.decode.process")
        if seen.contains(meta["id"]):
            return
        s_req = jtrace.span("serve.request", parent=meta.get("trace"), role="decode",
                            request_id=meta["id"])
        try:
            with s_req:
                full, dstats, dspans = jdw._decode_bundle(
                    engine, payload, steps, klass=str(meta.get("klass") or ""),
                    request_id=meta["id"])
        except Exception as e:  # noqa: BLE001
            jjourney.VAULT.complete(meta["id"], trace=meta.get("trace"), engine="disagg",
                                    klass=str(meta.get("klass") or ""), outcome="errored",
                                    error=repr(e))
            server.post_result(meta["id"], {"id": meta["id"], "failed": repr(e)[:300]}, b"")
            seen.record(meta["id"])
            return
        handoff = {**meta.get("handoff", {}), **dstats}
        spans_out = list(meta.get("spans", [])) + dspans + [s_req.to_dict()]
        server.post_result(meta["id"], {"id": meta["id"], "handoff": handoff,
                                        "spans": spans_out},
                           jkt.arrays_to_bytes(tokens=full))
        seen.record(meta["id"])

    return process


def wait_for_requeue(server, timeout_s: float = 30.0) -> None:
    """Until `server` (either package's KVServer) holds a bundle again."""
    deadline = time.monotonic() + timeout_s
    while server._bundles.qsize() == 0:
        assert time.monotonic() < deadline, "the bundle was not re-queued"
        time.sleep(0.01)


def journey_digest(j):
    """What a journey says about its request, without ids, clocks or the
    packages' own decode spans' timings."""
    if j is None:
        return None
    return {"completed": j["completed"], "outcome": j.get("outcome"),
            "flags": sorted(j.get("flags") or []),
            "spans": sorted(sp["name"] for sp in j.get("spans") or []),
            "events": sorted(e.get("kind", "") for e in j.get("events") or [])}


def test_the_decode_fault_drill_with_worker_feeds_installed_matches_jax(worker_feeds):
    """The decode-fault drill of the test above, with both packages' journey
    feeds installed (as in a worker, or after an ApiServer in the same
    process): the failed pull's spans open a journey for the request in
    each VAULT, and after every step the port's journey says what JAX's
    says."""
    import numpy as np

    from lws_tpu.serving import disagg_worker as jdw
    from lws_tpu.serving import kv_transport as jkt
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt

    prompt = np.array([[5, 9, 2, 11, 7]], dtype=np.int32)
    sides = {}
    for name, pkg, wire, eng in (("port", PORT, kt, dw.build_engine(1, 16, device="cpu")),
                                 ("jax", JAX, jkt, jdw.build_engine(1, 16))):
        token, cache = eng.prefill(prompt)
        server = wire.KVServer(port=0, host="127.0.0.1")
        for rid in ("warm", "r"):
            server.offer_bundle({"id": rid}, wire.cache_to_bundle(cache, token))
        process = (dw.decode_processor(eng, server, steps=3) if name == "port"
                   else jax_decode_process(eng, server, 3))
        sides[name] = (pkg, wire, server, ("127.0.0.1", server.port), process)
    server_of = {id(pkg): server for pkg, _, server, _, _ in sides.values()}
    try:
        def step(fn) -> dict:
            got = {}
            for name, (pkg, wire, server, ep, process) in sides.items():
                out = fn(pkg, wire, ep, process)
                got[name] = (out, journey_digest(pkg["journey"].VAULT.get("r")),
                             journey_digest(pkg["journey"].VAULT.get("p")))
            assert got["port"] == got["jax"]
            return got["port"]

        def warm_up(pkg, wire, ep, process):
            # One decode first (JAX compiles its decode here).
            wire.pull_bundle(ep, timeout=60.0, process=process)
            return "failed" in wire.pull_result(ep, "warm")[0]

        assert step(warm_up) == (False, None, None)

        def failed_pull(pkg, wire, ep, process):
            pkg["faults"].INJECTOR.arm("disagg.decode.process", "fail_n_times:1")
            with pytest.raises(OSError):
                wire.pull_bundle(ep, timeout=1.0, process=process)
            # The server's handler thread records `kv_requeue` (which opens
            # the journey) and then re-queues the bundle once it sees the
            # dropped connection, after the puller has raised: wait for it.
            wait_for_requeue(server_of[id(pkg)])
            return wire.pull_result(ep, "r")

        out, opened, _ = step(failed_pull)
        assert out is None and opened is not None and not opened["completed"]

        def redelivery(pkg, wire, ep, process):
            wire.pull_bundle(ep, timeout=5.0, process=process)
            meta, payload = wire.pull_result(ep, "r")
            return ("failed" in meta, wire.bytes_to_arrays(payload)["tokens"].shape,
                    pkg["faults"].INJECTOR.snapshot()["trips"])

        out, _, _ = step(redelivery)
        assert out == (False, (1, 4), {"disagg.decode.process": 1})

        def poison(pkg, wire, ep, process):
            process({"id": "p"}, wire.PoisonPayload(ValueError("20 KV rows but decode "
                                                               "max_len=16")))
            meta, _ = wire.pull_result(ep, "p")
            return meta["failed"]

        out, _, leg = step(poison)
        assert "max_len" in out and leg["outcome"] == "errored" and "errored" in leg["flags"]
    finally:
        for _, _, server, _, _ in sides.values():
            server.close()
