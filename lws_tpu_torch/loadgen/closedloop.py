"""Deterministic closed-loop flash-crowd sweep: the end-to-end drive of the
scale decision plane under an injected clock.

The sweep compiles the `flash_crowd` scenario (densified so a 15s tick sees
a meaningful arrival count) into arrival times, stretches scenario seconds
onto a simulated wall clock, and replays them against a binary capacity
plant: a tick whose offered rate per decode replica exceeds
`RATE_PER_REPLICA` serves every request over the ITL target, a calm tick
serves on-target. Each tick the plant's cumulative exposition is ingested
into a private `HistoryRing`, a REAL `ScaleRecommender` burns it, and a
REAL `ScaleActuator` closes the loop through the production chain —
AnnotationAdapter → stock Autoscaler (min/max clamps, scale-down
stabilization) → DS replica writeback — against an in-process
`ControlPlane`. Scale-in drains the victim replica through the injectable
`drain_fn` seam before the pod goes away. The sweep stops once the
post-crowd one-step scale-in converges, and returns the full evidence:
per-tick evaluations, the provenance ledger snapshot, the replica trace,
and the stability counters.

Everything is seeded and clock-injected — no wall time, no sleeps.

The port's copy of lws_tpu/loadgen/closedloop.py. `_make_plant_ds` builds
its worker template itself, in the shape of the JAX package's test helper
(`lws_tpu/testing.py:make_worker_template`), which the port does not carry.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

from lws_tpu_torch.core.flightrecorder import FlightRecorder
from lws_tpu_torch.core.metrics import MetricsRegistry
from lws_tpu_torch.core.slo import SLOTargets
from lws_tpu_torch.loadgen.scenario import SCENARIOS, build_schedule
from lws_tpu_torch.obs import signals
from lws_tpu_torch.obs.decisions import (
    DISABLE_ENV,
    FLAP_WINDOW_ENV,
    DecisionLedger,
    ScaleActuator,
)
from lws_tpu_torch.obs.history import HistoryRing
from lws_tpu_torch.obs.recommend import ScaleRecommender, role_replicas_from_store

# One recommender tick of simulated wall clock. Matches the fast burn
# tier's short window under WINDOW_SCALE, so each evaluation burns exactly
# the latest tick's observations.
TICK_S = 15.0
# Scenario seconds -> simulated wall seconds: flash_crowd's 1.5s horizon
# becomes a 150s sweep with the crowd at 50-80s.
TIME_STRETCH = 100.0
# Burn windows scaled to the sim clock: fast tier 15s/180s at 14.4x.
WINDOW_SCALE = 0.05
# The binary capacity knee: a tick is over capacity when offered arrivals
# per second per decode replica exceed this.
RATE_PER_REPLICA = 0.8
GOOD_ITL_S = 0.01   # on-target decode step (SIM_TARGETS.itl_s = 0.1)
BAD_ITL_S = 5.0     # saturated decode step — lands past every SLO bucket
TOKENS_PER_REQUEST = 8.0
# Observations a zero-arrival tick still emits: the recommender treats an
# unevaluable window as "no signal", never calm, so the plant keeps the
# window evaluable the way a live engine's idle probes would.
IDLE_PROBES = 2


def densified_flash_crowd(density: float = 10.0) -> dict:
    """The stock flash_crowd scenario with base/spike rates multiplied by
    `density` (deep-copied; the committed SCENARIOS table is shared)."""
    spec = json.loads(json.dumps(SCENARIOS["flash_crowd"]))
    spec["arrivals"]["base_rps"] = spec["arrivals"]["base_rps"] * density
    spec["arrivals"]["spike_rps"] = spec["arrivals"]["spike_rps"] * density
    return spec


def crowd_arrivals(seed: int, density: float = 10.0) -> list:
    """Simulated-wall-clock arrival times for the densified flash crowd —
    byte-reproducible per (seed, density) through the committed
    `build_schedule` draw order."""
    spec = densified_flash_crowd(density)
    return [r.arrival_s * TIME_STRETCH for r in build_schedule(spec, seed)]


class CapacityPlant:
    """Binary-capacity decode plant: cumulative SLO exposition whose ITL
    histogram goes over-target exactly while offered load per replica
    exceeds the knee. Tokens/goodput counters ride along so the burn-rate
    surface (and the decision's recorded burn evidence) is populated the
    same way a live engine populates it."""

    def __init__(self, arrivals: list, tick_s: float = TICK_S,
                 rate_per_replica: float = RATE_PER_REPLICA) -> None:
        self.arrivals = sorted(arrivals)
        self.tick_s = tick_s
        self.rate_per_replica = rate_per_replica
        self._good = 0
        self._bad = 0
        self._tokens = 0.0
        self._goodput = 0.0

    def tick(self, now: float, replicas: int) -> dict:
        """Serve the arrivals in (now - tick_s, now] at `replicas` and fold
        them into the cumulative ledgers. Returns the tick verdict."""
        lo = now - self.tick_s
        n = sum(1 for t in self.arrivals if lo < t <= now)
        rate = n / self.tick_s
        bad = rate / max(1, int(replicas)) > self.rate_per_replica
        obs = max(IDLE_PROBES, n)
        if bad:
            self._bad += obs
        else:
            self._good += obs
            self._goodput += obs * TOKENS_PER_REQUEST
        self._tokens += obs * TOKENS_PER_REQUEST
        return {"arrivals": n, "rate": rate, "bad": bad}

    def render(self) -> str:
        """The cumulative exposition, rebuilt fresh (scrape semantics: the
        ring diffs consecutive ingests, so only totals matter)."""
        reg = MetricsRegistry()
        for _ in range(self._good):
            reg.observe("serving_itl_seconds", GOOD_ITL_S, {"engine": "paged"})
        for _ in range(self._bad):
            reg.observe("serving_itl_seconds", BAD_ITL_S, {"engine": "paged"})
        labels = {"engine": "paged", "klass": "chat"}
        reg.inc("serving_tokens_total", labels, self._tokens)
        if self._goodput > 0:
            reg.inc("serving_goodput_tokens_total", labels, self._goodput)
        return reg.render()


def _make_plant_ds(name: str = "crowd", replicas: int = 1):
    from lws_tpu_torch.api.disagg import (
        DisaggregatedRoleSpec,
        DisaggregatedSet,
        DisaggregatedSetSpec,
        LeaderWorkerSetTemplateSpec,
    )
    from lws_tpu_torch.api.types import LeaderWorkerSetSpec, LeaderWorkerTemplate
    from lws_tpu_torch.api.pod import Container, PodSpec, PodTemplateSpec, TemplateMeta
    from lws_tpu_torch.core.store import new_meta

    def make_worker_template(image: str) -> PodTemplateSpec:
        return PodTemplateSpec(metadata=TemplateMeta(), spec=PodSpec(
            containers=[Container(name="worker", image=image, resources={})]))

    def _role(role_name: str, n: int):
        return DisaggregatedRoleSpec(
            name=role_name,
            replicas=n,
            template=LeaderWorkerSetTemplateSpec(
                spec=LeaderWorkerSetSpec(
                    leader_worker_template=LeaderWorkerTemplate(
                        worker_template=make_worker_template("img:v1"),
                        size=1,
                    )
                )
            ),
        )

    # The DS admission contract wants a real disagg pair; the sweep's
    # synthetic load only exercises decode (prefill stays "no signal" ->
    # hold, itself a useful negative lane in the provenance record).
    return DisaggregatedSet(
        meta=new_meta(name),
        spec=DisaggregatedSetSpec(
            roles=[_role("prefill", 1), _role("decode", replicas)]),
    )


def run_sweep(
    seed: int = 7,
    *,
    density: float = 10.0,
    max_ticks: int = 20,
    max_replicas: int = 4,
    flap_window_s: float = 20.0,
    disable: Optional[str] = None,
    drain_fn: Optional[Callable] = None,
    chaos: Optional[Callable] = None,
) -> dict:
    """Drive the whole loop to convergence under the simulated clock.

    `flap_window_s` scales the ledger's flap window alongside the burn
    windows (0.05 x the 600s wall default, rounded down — the 30s gap
    between a correct scale-out and the post-crowd scale-in is a recovery,
    not an oscillation). `disable` pins LWS_TPU_ACTUATION_DISABLE for the
    sweep (None clears it: the loop is closed by default). `drain_fn`
    replaces the actuator's victim-drain seam (default: record and accept).
    `chaos(cp, now, tick)` runs before each evaluation — the chaos overlay
    hook (delete a pod, corrupt a status) the acceptance sweeps use.

    Returns a JSON-shaped result: per-tick `evaluations`, the ledger
    `decisions` snapshot, the `replicas` trace, `drains`, the stability
    counters (`flaps`, `actuations`), `max_replicas_seen`, the tick
    indices of the first applied scale-out/scale-in, and whether the
    scale-in `converged`.
    """
    from lws_tpu_torch.runtime import ControlPlane

    saved = {k: os.environ.get(k) for k in (FLAP_WINDOW_ENV, DISABLE_ENV)}
    os.environ[FLAP_WINDOW_ENV] = str(flap_window_s)
    if disable is None:
        os.environ.pop(DISABLE_ENV, None)
    else:
        os.environ[DISABLE_ENV] = disable
    try:
        return _run_sweep(
            seed, density=density, max_ticks=max_ticks,
            max_replicas=max_replicas, drain_fn=drain_fn, chaos=chaos,
            control_plane_cls=ControlPlane,
        )
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_sweep(seed: int, *, density: float, max_ticks: int,
               max_replicas: int, drain_fn: Optional[Callable],
               chaos: Optional[Callable], control_plane_cls) -> dict:
    registry = MetricsRegistry()
    recorder = FlightRecorder()
    ring = HistoryRing(interval_s=0.0, retention_s=3600.0,
                       metrics_registry=registry)
    ledger = DecisionLedger(registry=registry, recorder=recorder)
    windows = signals.burn_windows(WINDOW_SCALE)
    targets = SLOTargets(ttft_s=1.0, itl_s=0.1, queue_wait_s=0.5)

    cp = control_plane_cls(auto_ready=True)
    cp.create(_make_plant_ds())
    cp.run_until_stable()

    drains: list = []

    def _drain(pod) -> bool:
        drains.append(pod.meta.name)
        return bool(drain_fn(pod)) if drain_fn is not None else True

    actuator = ScaleActuator(cp.store, ledger=ledger, min_replicas=1,
                             max_replicas=max_replicas, stabilization=2,
                             drain_fn=_drain)
    plant = CapacityPlant(crowd_arrivals(seed, density))

    evaluations: list = []
    replica_trace: list = []
    scale_out_tick = scale_in_tick = None
    converged = False
    for tick in range(1, max_ticks + 1):
        now = tick * TICK_S
        replicas = role_replicas_from_store(cp.store).get("decode", 1)
        served = plant.tick(now, replicas)
        ring.ingest(plant.render(), now=now)
        if chaos is not None:
            chaos(cp, now, tick)
        rec = ScaleRecommender(
            ring, targets=targets, attainment_target=0.99, windows=windows,
            current=role_replicas_from_store(cp.store),
            min_replicas=1, max_replicas=max_replicas,
            registry=registry, recorder=recorder,
        ).evaluate(now=now)
        records = actuator.apply(rec, now=now)
        cp.run_until_stable()
        settled = actuator.observe(now=now)
        for r in records:
            if r.outcome == "applied":
                if r.verdict == "scale_out" and scale_out_tick is None:
                    scale_out_tick = tick
                if r.verdict == "scale_in" and scale_in_tick is None:
                    scale_in_tick = tick
        after = role_replicas_from_store(cp.store).get("decode", replicas)
        evaluations.append({
            "tick": tick, "t": now, "replicas": replicas,
            "arrivals": served["arrivals"],
            "rate_rps": round(served["rate"], 3), "over_capacity": served["bad"],
            "desired": rec.desired.get("decode"),
            "reason": rec.reasons.get("decode", ""),
        })
        replica_trace.append([now, after])
        if any(r.verdict == "scale_in" for r in settled):
            converged = True
            break

    decisions = ledger.snapshot()
    actuations: dict = {}
    for d in decisions:
        if d["action"]:
            key = f"{d['action']}/{d['outcome']}"
            actuations[key] = actuations.get(key, 0) + 1
    return {
        "seed": seed,
        "density": density,
        "ticks": len(evaluations),
        "evaluations": evaluations,
        "decisions": decisions,
        "replicas": replica_trace,
        "max_replicas_seen": max((r for _, r in replica_trace), default=1),
        "scale_out_tick": scale_out_tick,
        "scale_in_tick": scale_in_tick,
        "scale_in_steps": sum(
            1 for d in decisions
            if d["verdict"] == "scale_in" and d["outcome"] == "applied"),
        "converged": converged,
        "drains": drains,
        "flaps": registry.counter_value("serving_actuation_flaps_total",
                                        {"plane": "scale"}),
        "actuations": actuations,
    }
