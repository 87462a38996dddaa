"""The port's decision plane and autoscaler (lws_tpu_torch: obs/decisions.py,
the store halves of obs/rollout.py and obs/recommend.py,
api/autoscaler.py and controllers/autoscaler_controller.py) against the JAX
package's, on the CPU.

A JAX and a port ControlPlane (tests/test_torch_control_plane.Both) are
stepped in lockstep with `run_until_stable`; after every step every kind's
`to_manifest`, the Autoscalers' among them, and the recorded events are
equal. Beside them each package's DecisionLedger, actuators, analyzer and
recommender run on the same inputs with an explicit `now`, as the JAX
package's tests/test_decision_plane.py drives them, and their records,
metrics and drains are equal:
- the ledger: repeats collapse, capacity eviction, actuation metrics,
  flaps, convergence, supersession;
- the ScaleActuator over a DisaggregatedSet, its drains injected
  (`drain_fn`): a drained scale-in that lands on the stock autoscaler's
  second observation, the DS writeback, convergence, a scale-out, and the
  `LWS_TPU_ACTUATION_DISABLE=scale` kill switch (records, moves nothing);
- the RolloutActuator over a two-revision LeaderWorkerSet: a canary
  regression suppressed by the kill switch, then rolled back;
- `evaluate_and_actuate` over equal process history rings;
- the autoscaler scenarios of tests/test_autoscaler_pvc_ckpt.py (scale up
  and down with stabilization, bounds, steady load).

Normalized, and only these: `uid`, `resourceVersion` and
`last_transition_time` (random ids and wall clocks), as in
tests/test_torch_control_plane.py.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

import pytest

from lws_tpu.api import autoscaler as jautoscaler
from lws_tpu.core import flightrecorder as jfr
from lws_tpu.core import metrics as jmetrics
from lws_tpu.obs import decisions as jdecisions
from lws_tpu.obs import history as jhistory
from lws_tpu.obs import recommend as jrecommend
from lws_tpu.obs import rollout as jrollout
from lws_tpu.obs import signals as jsignals
from lws_tpu.utils import revision as jrevision
from lws_tpu_torch.api import autoscaler as pautoscaler
from lws_tpu_torch.core import flightrecorder as pfr
from lws_tpu_torch.core import metrics as pmetrics
from lws_tpu_torch.obs import decisions as pdecisions
from lws_tpu_torch.obs import history as phistory
from lws_tpu_torch.obs import recommend as precommend
from lws_tpu_torch.obs import rollout as prollout
from lws_tpu_torch.obs import signals as psignals
from lws_tpu_torch.utils import revision as prevision
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_control_plane import Both, apply_doc, normalize
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

OBS = {"jax": SimpleNamespace(decisions=jdecisions, rollout=jrollout, recommend=jrecommend,
                              history=jhistory, signals=jsignals, metrics=jmetrics, fr=jfr,
                              revision=jrevision, autoscaler=jautoscaler),
       "port": SimpleNamespace(decisions=pdecisions, rollout=prollout, recommend=precommend,
                               history=phistory, signals=psignals, metrics=pmetrics, fr=pfr,
                               revision=prevision, autoscaler=pautoscaler)}


@pytest.fixture
def planes(jax_planes_restored, port_planes_restored):  # noqa: F811
    yield
    for o in OBS.values():
        o.rollout.LEDGER.clear()


def lws_doc(replicas: int, size: int, image: str = "worker:v1", name: str = "sample") -> dict:
    """LWSBuilder's LeaderWorkerSet (lws_tpu/testing.py) as a manifest."""
    return {"apiVersion": "lws.tpu/v1", "kind": "LeaderWorkerSet", "metadata": {"name": name},
            "spec": {"replicas": replicas, "leaderWorkerTemplate": {"size": size, "workerTemplate": {
                "spec": {"containers": [{"name": "worker", "image": image}]}}}}}


def autoscaler_doc(name: str = "asc", **spec) -> dict:
    return {"apiVersion": "lws.tpu/v1", "kind": "Autoscaler", "metadata": {"name": name},
            "spec": {"target": "sample", **spec}}


def ds_doc(decode_replicas: int = 2) -> dict:
    """A DisaggregatedSet whose roles declare a telemetry port (the scale
    actuator's drain target)."""
    def role(name: str, replicas: int) -> dict:
        return {"name": name, "replicas": replicas, "template": {"spec": {"leaderWorkerTemplate": {
            "size": 1, "workerTemplate": {"spec": {"containers": [{
                "name": "worker", "image": "img:v1",
                "env": [{"name": "LWS_TPU_METRICS_PORT", "value": "9400"}]}]}}}}}}

    return {"apiVersion": "lws.tpu/v1", "kind": "DisaggregatedSet", "metadata": {"name": "llmd"},
            "spec": {"roles": [role("prefill", 1), role("decode", decode_replicas)]}}


def autoscalers(side, cp) -> list:
    return sorted((normalize(side.manifest.to_manifest(a)) for a in cp.store.list("Autoscaler")),
                  key=lambda m: m["metadata"]["name"])


def set_metric(pods, metric: str, value: float):
    """The scenario's set_metric on each of `pods` (a name or a list), all
    before one drive to a fixed point."""
    def fn(side, cp):
        prefix = OBS[side.name].autoscaler.METRIC_ANNOTATION_PREFIX
        for name in [pods] if isinstance(pods, str) else pods:
            pod = cp.store.get("Pod", "default", name)
            pod.meta.annotations[prefix + metric] = str(value)
            cp.store.update(pod)
    return fn


def replicas(name: str = "sample"):
    return lambda side, cp: cp.store.get("LeaderWorkerSet", "default", name).spec.replicas


def step(both: Both, fn) -> None:
    both.do(fn)
    both.read(autoscalers)


# ---------------------------------------------------------------------------
# The autoscaler scenarios of tests/test_autoscaler_pvc_ckpt.py


def scenario_up_and_down(both: Both) -> None:
    step(both, apply_doc(lws_doc(1, 2)))
    step(both, apply_doc(autoscaler_doc(minReplicas=1, maxReplicas=4, metric="inflight",
                                        targetValue=2.0, scaleDownStabilization=2)))
    step(both, set_metric("sample-0", "inflight", 6.0))
    assert both.read(replicas()) == 3
    step(both, set_metric([f"sample-{i}" for i in range(3)], "inflight", 2.0))
    assert both.read(replicas()) == 3
    step(both, set_metric([f"sample-{i}" for i in range(3)], "inflight", 0.1))
    assert both.read(replicas()) == 3
    step(both, set_metric("sample-0", "inflight", 0.05))
    assert both.read(replicas()) == 1


def scenario_bounds(both: Both) -> None:
    step(both, apply_doc(lws_doc(2, 1)))
    step(both, apply_doc(autoscaler_doc(minReplicas=1, maxReplicas=3, targetValue=1.0)))
    step(both, set_metric("sample-0", "inflight", 100.0))
    assert both.read(replicas()) == 3


def scenario_steady_load(both: Both) -> None:
    step(both, apply_doc(lws_doc(1, 1)))
    step(both, apply_doc(autoscaler_doc(minReplicas=1, maxReplicas=9, targetValue=2.0)))
    step(both, set_metric("sample-0", "inflight", 6.0))
    assert both.read(replicas()) == 3
    step(both, set_metric([f"sample-{i}" for i in range(3)], "inflight", 6.0))
    assert both.read(replicas()) == 9


@pytest.mark.parametrize("scenario", [scenario_up_and_down, scenario_bounds,
                                      scenario_steady_load], ids=lambda f: f.__name__)
def test_the_autoscaler_scenarios_step_as_jax_s(scenario, planes):
    both = Both()
    scenario(both)
    assert any(e.reason == "Scaled" for e in both.sides[1][1].recorder.events)


# ---------------------------------------------------------------------------
# The DecisionLedger, each package's on the same calls


def ledger_collapse(o, led) -> None:
    guards = [{"name": "evidence", "passed": True, "detail": "steady"}]
    r1 = led.open("scale", "decode", "hold", guards=guards, now=1.0)
    assert led.open("scale", "decode", "hold", guards=guards, now=2.0) is r1
    r3 = led.open("scale", "decode", "scale_out", guards=guards, now=3.0)
    led.open("scale", "prefill", "hold", guards=guards, now=4.0)
    led.actuate(r3.id, "scale_out", "applied", now=3.5)
    led.open("scale", "decode", "scale_out", guards=guards, now=5.0)


def ledger_capacity(o, led) -> None:
    for i in range(5):
        led.open("scale", f"r{i}", "hold", now=float(i))


def ledger_flaps(o, led) -> None:
    out = led.open("scale", "decode", "scale_out", now=10.0)
    led.actuate(out.id, "scale_out", "applied", now=10.0, generation_before=3, lws="child",
                namespace="default", desired=4)
    led.converge(out.id, now=25.0, generation_after=7)
    back = led.open("scale", "decode", "scale_in", now=40.0)
    led.actuate(back.id, "scale_in", "applied", now=40.0)
    fwd = led.open("scale", "decode", "scale_out", now=200.0)
    led.actuate(fwd.id, "scale_out", "applied", now=200.0)
    sup = led.open("scale", "decode", "scale_in", now=201.0)
    led.actuate(sup.id, "scale_in", "suppressed", now=201.0)
    led.supersede(fwd.id, sup.id)
    rb = led.open("rollout", "default/web", "rollback", now=300.0)
    led.actuate(rb.id, "rollback", "failed", now=300.0, error="boom")


@pytest.mark.parametrize("script", [ledger_collapse, ledger_capacity, ledger_flaps],
                         ids=lambda f: f.__name__)
def test_the_decision_ledger_records_as_jax_s(script, monkeypatch):
    monkeypatch.setenv("LWS_TPU_FLAP_WINDOW_S", "100")
    out = {}
    for name, o in OBS.items():
        reg = o.metrics.MetricsRegistry()
        fr = o.fr.FlightRecorder()
        led = o.decisions.DecisionLedger(capacity=3 if script is ledger_capacity else 512,
                                         registry=reg, recorder=fr)
        script(o, led)
        last = {p: (led.last_actuation(p) or SimpleNamespace(id=None)).id
                for p in o.decisions.PLANES}
        out[name] = (led.snapshot(limit=256), led.snapshot(limit=1), reg.render(),
                     [e["kind"] for e in fr.events()], last,
                     [r.id for r in led.pending("scale")])
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# The ScaleActuator over a DisaggregatedSet


def test_the_scale_actuator_drains_scales_writes_back_and_obeys_the_kill_switch(planes,
                                                                                monkeypatch):
    both = Both()
    step(both, apply_doc(ds_doc(decode_replicas=2)))
    acts, ledgers, drained = {}, {}, {"jax": [], "port": []}
    for side, cp in both.sides:
        o = OBS[side.name]
        ledgers[side.name] = o.decisions.DecisionLedger(registry=o.metrics.MetricsRegistry(),
                                                        recorder=o.fr.FlightRecorder())
        acts[side.name] = o.decisions.ScaleActuator(
            cp.store, ledger=ledgers[side.name], min_replicas=1, max_replicas=4,
            stabilization=2, drain_fn=lambda pod, n=side.name: drained[n].append(pod.meta.name)
            or True)
    got = {}

    def apply(desired: dict, current: dict, now: float):
        def fn(side, cp):
            rec = OBS[side.name].recommend.Recommendation(
                at=now, desired=desired, current=current,
                reasons={r: f"{r}: burn {desired[r]}" for r in desired})
            got[side.name] = [r.to_dict() for r in acts[side.name].apply(rec, now=now)]
        step(both, fn)
        assert got["port"] == got["jax"]
        return got["port"]

    def observe(now: float):
        def fn(side, cp):
            got[side.name] = [r.id for r in acts[side.name].observe(now=now)]
        step(both, fn)
        assert got["port"] == got["jax"]
        return got["port"]

    # Scale-in: drain first, then the stock autoscaler's second observation.
    calm = ({"prefill": 1, "decode": 1}, {"prefill": 1, "decode": 2})
    records = apply(*calm, now=100.0)
    scale_in = next(r for r in records if r["verdict"] == "scale_in")
    assert scale_in["outcome"] == "applied" and scale_in["detail"]["drained"]["ok"] is True
    assert drained["port"] == drained["jax"] and drained["port"][0].endswith("-decode-1")
    apply(*calm, now=115.0)
    assert observe(now=120.0) == [scale_in["id"]]
    ds_decode = both.read(lambda side, cp: cp.store.get(
        "DisaggregatedSet", "default", "llmd").role("decode").replicas)
    assert ds_decode == 1  # the DS writeback kept the role spec in lockstep
    # Scale-out, then converged.
    out = apply({"prefill": 1, "decode": 3}, {"prefill": 1, "decode": 1}, now=200.0)
    assert any(r["verdict"] == "scale_out" and r["outcome"] == "applied" for r in out)
    observe(now=210.0)
    # The kill switch: recorded, suppressed, nothing moves.
    monkeypatch.setenv("LWS_TPU_ACTUATION_DISABLE", "scale")
    out = apply({"prefill": 1, "decode": 1}, {"prefill": 1, "decode": 3}, now=300.0)
    sup = next(r for r in out if r["verdict"] == "scale_in")
    assert sup["outcome"] == "suppressed"
    assert both.read(lambda side, cp: cp.store.get(
        "DisaggregatedSet", "default", "llmd").role("decode").replicas) == 3
    assert ledgers["port"].snapshot(limit=256) == ledgers["jax"].snapshot(limit=256)
    assert (ledgers["port"]._reg().render() == ledgers["jax"]._reg().render())


# ---------------------------------------------------------------------------
# The RolloutActuator over a two-revision LeaderWorkerSet


def revision_ring(o, baseline: str, canary: str):
    """tests/test_decision_plane.py:_revision_ring: the baseline delivers
    every token on time, the canary none."""
    ring = o.history.HistoryRing(interval_s=0.0, retention_s=3600.0)
    acc = 0.0
    for t in (0.0, 90.0, 180.0, 195.0):
        acc += 500.0
        cum = o.metrics.MetricsRegistry()
        cum.inc("serving_tokens_total", {"engine": "paged", "revision": baseline}, acc * 2)
        cum.inc("serving_goodput_tokens_total", {"engine": "paged", "revision": baseline},
                acc * 2)
        cum.inc("serving_tokens_total", {"engine": "paged", "revision": canary}, acc)
        ring.ingest(cum.render(), now=t)
    return ring


def test_the_rollout_actuator_rolls_back_as_jax_s(planes, monkeypatch):
    both = Both()
    step(both, apply_doc(lws_doc(3, 2, image="img:v1")))

    def hold_new_pods(side, cp):
        # The test plays kubelet from here: new pods stay unready, so the
        # update is caught mid-way with both revisions live.
        cp.kubelet.reconcile = lambda key: None

    step(both, hold_new_pods)
    step(both, apply_doc(lws_doc(3, 2, image="img:v2")))
    keys = both.read(lambda side, cp: [
        OBS[side.name].revision.get_revision_key(r) for r in OBS[side.name].revision.list_revisions(
            cp.store, cp.store.get("LeaderWorkerSet", "default", "sample"))])
    assert len(keys) == 2
    old_key, new_key = keys[0], keys[-1]
    acts, reports, got = {}, {}, {}
    for side, cp in both.sides:
        o = OBS[side.name]
        reg = o.metrics.MetricsRegistry()
        windows = tuple(w.scaled(0.05) for w in o.signals.DEFAULT_BURN_WINDOWS)
        an = o.rollout.CanaryAnalyzer(
            revision_ring(o, old_key, new_key), lws="default/sample", attainment_target=0.99,
            windows=windows, min_samples=100.0, min_duration_s=50.0, delta=2.0,
            ledger=o.rollout.RolloutLedger(registry=reg), registry=reg,
            recorder=o.fr.FlightRecorder())
        reports[side.name] = an.evaluate(now=195.0)
        acts[side.name] = o.decisions.RolloutActuator(cp.store, ledger=o.decisions.DecisionLedger(
            registry=reg, recorder=o.fr.FlightRecorder()))
    assert reports["port"].baseline == reports["jax"].baseline == old_key
    assert reports["port"].verdicts[new_key].verdict == "rollback"

    def apply(now: float):
        def fn(side, cp):
            got[side.name] = acts[side.name].apply(reports[side.name], now=now).to_dict()
        step(both, fn)
        assert got["port"] == got["jax"]
        return got["port"]

    monkeypatch.setenv("LWS_TPU_ACTUATION_DISABLE", "scale,rollout")
    assert apply(195.0)["outcome"] == "suppressed"
    monkeypatch.delenv("LWS_TPU_ACTUATION_DISABLE")
    record = apply(196.0)
    assert record["outcome"] == "applied" and record["detail"]["rolled_back_to"] == old_key
    image = both.read(lambda side, cp: cp.store.get("LeaderWorkerSet", "default", "sample")
                      .spec.leader_worker_template.worker_template.spec.containers[0].image)
    assert image == "img:v1"
    step(both, lambda side, cp: acts[side.name].observe(now=210.0))


# ---------------------------------------------------------------------------
# The per-ingest decision step over the process planes


def test_evaluate_and_actuate_records_as_jax_s(planes):
    both = Both()
    step(both, apply_doc(ds_doc(decode_replicas=2)))
    out = {}
    for side, cp in both.sides:
        o = OBS[side.name]
        o.history.HISTORY.clear()
        o.decisions.DECISIONS.clear()
        for name in ("RECOMMENDER", "ANALYZER"):
            for mod in (o.recommend, o.rollout):
                if hasattr(mod, name):
                    setattr(mod, name, None)
        o.decisions.ACTUATOR = o.decisions.ROLLOUT_ACTUATOR = None
        reg = o.metrics.MetricsRegistry()
        steps = []
        for k, t in enumerate((1000.0, 1005.0, 1010.0)):
            reg.inc("serving_tokens_total", {"engine": "disagg", "role": "decode"}, 10.0 * (k + 1))
            o.history.HISTORY.ingest(reg.render(), now=t)
            steps.append(o.decisions.evaluate_and_actuate(cp.store, now=t))
        out[side.name] = (steps, o.decisions.DECISIONS.snapshot(limit=256),
                          dict(o.recommend.RECOMMENDER.current))
        cp.run_until_stable()
    assert out["port"] == out["jax"]
    steps, records, current = out["port"]
    assert current == {"prefill": 1, "decode": 2} and records
    assert {r["subject"] for r in records if r["plane"] == "scale"} == {"prefill", "decode"}
    both.read(autoscalers)


def test_the_ds_writeback_is_installed_on_every_control_plane(planes):
    both = Both()
    step(both, apply_doc(ds_doc(decode_replicas=2)))
    for side, cp in both.sides:
        o = OBS[side.name]
        rec = o.decisions.DECISIONS.open("scale", "decode", "scale_out", now=1.0)
        child = next(lws for lws in cp.store.list("LeaderWorkerSet")
                     if lws.meta.name.endswith("-decode"))
        o.decisions.DECISIONS.actuate(rec.id, "scale_out", "applied", now=1.0,
                                      namespace="default", lws=child.meta.name, desired=3)

    def scale_child(side, cp):
        child = next(lws for lws in cp.store.list("LeaderWorkerSet")
                     if lws.meta.name.endswith("-decode"))
        child.spec.replicas = 3
        cp.store.update(child)

    step(both, scale_child)
    assert both.read(lambda side, cp: cp.store.get(
        "DisaggregatedSet", "default", "llmd").role("decode").replicas) == 3
    for o in OBS.values():
        o.decisions.DECISIONS.clear()


def test_the_autoscaler_kind_round_trips_as_jax_s():
    doc = autoscaler_doc(minReplicas=2, maxReplicas=5, metric="queue", targetValue=3.5,
                         scaleDownStabilization=4)
    from lws_tpu import manifest as jmanifest
    from lws_tpu.core import serialize as jserialize
    from lws_tpu_torch import manifest as pmanifest
    from lws_tpu_torch.core import serialize as pserialize

    j = jmanifest.from_manifest(copy.deepcopy(doc))
    p = pmanifest.from_manifest(copy.deepcopy(doc))
    assert normalize(pmanifest.to_manifest(p)) == normalize(jmanifest.to_manifest(j))
    native = pmanifest.to_manifest(p)
    assert normalize(pmanifest.to_manifest(pmanifest.from_manifest(copy.deepcopy(native)))) == \
        normalize(jmanifest.to_manifest(jmanifest.from_manifest(copy.deepcopy(native))))
    # The store's persistence knows the kind (serve --state-file).
    assert "Autoscaler" in pserialize._registry() and "Autoscaler" in jserialize._registry()
