"""Fleet-scale simulation harness: hundreds of store-backed instances on
one CPU, each serving a REAL telemetry surface.

The observability plane's scale claims (hierarchical scrape fan-in,
streaming exposition merge, per-source budgets) need a fleet to be proven
against, and a real 1,000-pod deployment is not a test fixture. SimFleet
builds the next best thing from the SAME parts the production path uses:

  * every `SimInstance` owns a private `MetricsRegistry` and a real
    `TelemetryServer(registry=...)` on an ephemeral loopback port — the
    fleet scraper dials genuine HTTP, negotiates OpenMetrics, and parses
    genuine expositions, not canned strings;
  * `tick()` advances schema-faithful synthetic series (the SLO ledger's
    `serving_tokens_total{engine,klass,revision}` twins, TTFT/ITL/queue
    histograms with occasional trace exemplars, attainment gauges) from a
    per-instance `random.Random(f"{seed}:{name}")` — byte-reproducible
    across runs, disjoint across instances;
  * with a `store`, each instance is a READY Pod carrying the same
    role/revision labels and LWS_TPU_METRICS_PORT env the production
    discovery contract reads (runtime/fleet.py `targets()`), so the
    two-tier scrape tree shards the simulated fleet exactly as it would a
    real one;
  * `SimFleetTarget` speaks the loadgen open-loop target protocol
    (submit/step/poll), so `lws_tpu_torch/loadgen/` schedules drive synthetic
    traffic across the fleet;
  * `seed_groups()` mass-creates steady-state group records for the
    reconcile-at-scale benchmarks.

The port's copy of lws_tpu/runtime/simfleet.py. Left out: JAX's
`respond_delay_s` (a sleep before each /metrics answer, standing in for
network delay), which only the fleet-scale benchmark sets; it comes with the
port's benchmark. `seed_groups` makes its
LeaderWorkerSets itself, in the shape the JAX package's test helpers give
them (`lws_tpu/testing.py`), which the port does not carry.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

from lws_tpu_torch.core.metrics import MetricsRegistry
from lws_tpu_torch.runtime.telemetry import METRICS_PORT_ENV, TelemetryServer

DEFAULT_ROLES = ("prefill", "decode")
DEFAULT_CLASSES = ("chat", "batch")
DEFAULT_REVISIONS = ("rev-a",)


class SimInstance:
    """One simulated serving worker: a seeded synthetic series generator
    behind a real telemetry server. The series it advances are the ones
    the SLO plane (core/slo.py) emits for a live engine, with the same
    label composition — the fleet scraper, history ring, and canary folds
    cannot tell it from a worker."""

    def __init__(self, name: str, role: str, revision: str,
                 klass: str = "chat", seed: int = 0) -> None:
        self.name = name
        self.role = role
        self.revision = revision
        self.klass = klass
        self.registry = MetricsRegistry()
        self.rng = random.Random(f"{seed}:{name}")
        self.server = TelemetryServer(
            port=0, host="127.0.0.1", registry=self.registry,
        )
        self.port = self.server.port
        self.requests = 0
        self._compiles_first = 0
        self._labels = {"engine": self.role, "klass": self.klass,
                        "revision": self.revision}

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def tick(self, n_requests: int = 1) -> None:
        """Advance the synthetic series by `n_requests` completed requests.
        Deterministic per (seed, name, call sequence)."""
        reg, rng = self.registry, self.rng
        eng = {"engine": self.role}
        for _ in range(n_requests):
            self.requests += 1
            reg.inc("serving_requests_total", eng)
            exemplar = None
            if rng.random() < 0.125:
                exemplar = {"trace_id": f"{self.name}-{self.requests:06d}"}
            reg.observe("serving_queue_wait_seconds",
                        0.002 + rng.random() * 0.03, eng)
            reg.observe("serving_ttft_seconds", 0.05 + rng.random() * 0.2,
                        self._labels, exemplar=exemplar)
            reg.observe("serving_itl_seconds", 0.004 + rng.random() * 0.02,
                        self._labels)
            tokens = 16 + rng.randrange(48)
            good = tokens if rng.random() < 0.95 else max(0, tokens - 8)
            reg.inc("serving_tokens_total", self._labels, float(tokens))
            if good:
                reg.inc("serving_goodput_tokens_total", self._labels,
                        float(good))
        reg.set("serving_slo_attainment",
                round(0.9 + 0.1 * rng.random(), 4), self._labels)
        reg.set("serving_active_slots", float(rng.randrange(8)), eng)
        # Device-runtime series (lws_tpu_torch/obs/device.py twins): every
        # instance paid one first compile per executable at warm-up; a
        # small minority of ticks recompile (bucket misses) — exercises
        # the CMP column, the fleet compile folds, and top-k bounding.
        if self.requests and self._compiles_first == 0:
            self._compiles_first = 1
            reg.inc("serving_compiles_total", {**eng, "kind": "first"})
            reg.observe("serving_compile_seconds",
                        0.2 + rng.random() * 0.8, eng)
        if rng.random() < 0.05:
            reg.inc("serving_compiles_total", {**eng, "kind": "recompile"})
            reg.observe("serving_compile_seconds",
                        0.2 + rng.random() * 0.8, eng)
        limit = 16 * (1 << 30)
        weights = 4.2 * (1 << 30)
        kv = (2.0 + 1.5 * rng.random()) * (1 << 30)
        reg.set("serving_hbm_pool_bytes", weights, {"pool": "weights"})
        reg.set("serving_hbm_pool_bytes", kv, {"pool": "kv"})
        reg.set("serving_hbm_pool_bytes", 0.2 * (1 << 30),
                {"pool": "arena_restore"})
        reg.set("serving_hbm_pool_bytes", 0.3 * (1 << 30),
                {"pool": "workspace"})
        dev = {"device": "tpu:0"}
        reg.set("serving_hbm_bytes_in_use", weights + kv, dev)
        reg.set("serving_hbm_bytes_limit", float(limit), dev)


class SimFleet:
    """A fleet of SimInstances, optionally registered as READY pods in a
    store so `FleetCollector.targets()` discovers them through the
    production pod contract. Context-manageable: servers are real sockets
    and must be stopped."""

    def __init__(self, store=None, n_instances: int = 8,
                 roles: Sequence[str] = DEFAULT_ROLES,
                 classes: Sequence[str] = DEFAULT_CLASSES,
                 revisions: Sequence[str] = DEFAULT_REVISIONS,
                 seed: int = 0,
                 namespace: str = "default",
                 name_prefix: str = "sim") -> None:
        self.store = store
        self.namespace = namespace
        self.seed = seed
        self.instances: list[SimInstance] = []
        for i in range(n_instances):
            self.instances.append(SimInstance(
                name=f"{name_prefix}-{i:04d}",
                role=roles[i % len(roles)],
                revision=revisions[i % len(revisions)],
                klass=classes[i % len(classes)],
                seed=seed,
            ))
        self._started = False

    def start(self) -> "SimFleet":
        for inst in self.instances:
            inst.start()
        if self.store is not None:
            for inst in self.instances:
                self._register_pod(inst)
        self._started = True
        return self

    def _register_pod(self, inst: SimInstance) -> None:
        from lws_tpu_torch.api import disagg
        from lws_tpu_torch.api.pod import Container, EnvVar, Pod, PodPhase, PodSpec
        from lws_tpu_torch.core.store import new_meta

        pod = Pod(
            meta=new_meta(inst.name, namespace=self.namespace, labels={
                disagg.DS_ROLE_LABEL_KEY: inst.role,
                disagg.DS_REVISION_LABEL_KEY: inst.revision,
            }),
            spec=PodSpec(containers=[Container(
                name="w",
                command=["sleep", "1"],
                env=[EnvVar(METRICS_PORT_ENV, str(inst.port))],
            )]),
        )
        created = self.store.create(pod)
        created.status.phase = PodPhase.RUNNING
        created.status.ready = True
        created.status.address = "127.0.0.1"
        self.store.update_status(created)

    def tick(self, n_requests: int = 1) -> None:
        """Advance every instance's series by `n_requests` requests."""
        for inst in self.instances:
            inst.tick(n_requests)

    def stop(self) -> None:
        # Each server's shutdown() blocks until its serve loop polls; do
        # them concurrently or a 1,000-instance fleet takes minutes to
        # tear down.
        from concurrent.futures import ThreadPoolExecutor

        if self.instances:
            with ThreadPoolExecutor(
                    max_workers=min(64, len(self.instances))) as pool:
                list(pool.map(lambda i: i.stop(), self.instances))
        self._started = False

    def __enter__(self) -> "SimFleet":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.stop()


class SimFleetTarget:
    """Loadgen open-loop target over a SimFleet: each submitted request
    lands on a seeded-random instance as one synthetic completion, so a
    `loadgen.run_schedule` drives fleet-wide series exactly where a router
    would spread real traffic. Results resolve on the next poll — the
    simulation models telemetry load, not decode latency."""

    def __init__(self, fleet: SimFleet, seed: int = 0) -> None:
        self.fleet = fleet
        self._rng = random.Random(f"target:{seed}")
        self._results: dict[int, dict] = {}
        self._next_handle = 0

    def submit(self, req, arrival_wall_t: float) -> Optional[int]:
        inst = self._rng.choice(self.fleet.instances)
        inst.tick(1)
        handle = self._next_handle
        self._next_handle += 1
        self._results[handle] = {
            "n_tokens": int(getattr(req, "max_new_tokens", 0) or 16),
        }
        return handle

    def step(self) -> None:
        pass

    def poll(self, handle: int) -> Optional[dict]:
        return self._results.pop(handle, None)


def seed_groups(store, n_groups: int, namespace: str = "default",
                name_prefix: str = "simlws", group_size: int = 1,
                replicas_per_lws: int = 500) -> list:
    """Mass-create LeaderWorkerSet records sized so the fleet totals
    `n_groups` groups — the reconcile-at-scale fixture
    (benchmarks/fleet_scale_bench.py drives the controller over it).
    Creates spec records only: the reconcile pass materializes the group
    and pod children itself, which is exactly the work being measured."""
    from lws_tpu_torch.api.pod import Container, PodSpec, PodTemplateSpec, TemplateMeta
    from lws_tpu_torch.api.types import (
        LeaderWorkerSet,
        LeaderWorkerSetSpec,
        LeaderWorkerTemplate,
    )
    from lws_tpu_torch.core.store import new_meta

    out = []
    remaining = n_groups
    idx = 0
    while remaining > 0:
        replicas = min(replicas_per_lws, remaining)
        worker = PodTemplateSpec(metadata=TemplateMeta(), spec=PodSpec(
            containers=[Container(name="worker", image="worker:v1", resources={})]))
        out.append(store.create(LeaderWorkerSet(
            meta=new_meta(f"{name_prefix}-{idx}", namespace),
            spec=LeaderWorkerSetSpec(
                replicas=replicas,
                leader_worker_template=LeaderWorkerTemplate(
                    worker_template=worker, size=group_size),
            ),
        )))
        remaining -= replicas
        idx += 1
    return out
