"""Assembled control plane (≈ cmd/main.go:72-250 startup + watch wiring).

Everything is wired into one Manager over one Store; `run_until_stable()`
drains all workqueues to a fixed point (deterministic, no sleeps), `start()`
runs them on background threads for live use.

The port's copy of lws_tpu/runtime/harness.py: the webhooks, the LWS,
GroupSet, pod, DisaggregatedSet and autoscaler reconcilers, the scheduler
and node monitor when enabled, the fleet collector, the Watchdog, and the
rollout and decision planes' store halves, and leader election
(`leader_election=True`: the manager reconciles only while its
`elector` holds the cluster Lease).
"""

from __future__ import annotations

import collections
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.node import Node
from lws_tpu_torch.api.pod import Pod, PodPhase
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Manager, Result
from lws_tpu_torch.core.store import Key, Store
from lws_tpu_torch.controllers.groupset_controller import GroupSetReconciler
from lws_tpu_torch.controllers.lws_controller import LWSReconciler
from lws_tpu_torch.controllers.pod_controller import PodReconciler
from lws_tpu_torch.sched.provider import make_scheduler_provider
from lws_tpu_torch.sched.scheduler import Scheduler
from lws_tpu_torch.webhooks import register_lws_webhooks, register_pod_webhooks
from lws_tpu_torch.webhooks.ds_webhook import register_ds_webhooks


class FakeKubelet:
    """Node-agent stand-in: pods that land on a node start Running+ready.

    With require_binding=False it also runs unbound pods — handy for control
    plane tests that don't model a fleet (the envtest trick, SURVEY §4.2,
    except our tests get it automatically)."""

    name = "kubelet"

    def __init__(self, store: Store, require_binding: bool = False) -> None:
        self.store = store
        self.require_binding = require_binding

    def reconcile(self, key: Key) -> Result | None:
        pod = self.store.try_get("Pod", key[1], key[2])
        if pod is None or not isinstance(pod, Pod):
            return None
        if pod.status.phase != PodPhase.PENDING:
            return None
        if self.require_binding and not pod.spec.node_name:
            return None
        pod.status.phase = PodPhase.RUNNING
        pod.status.ready = True
        pod.status.address = f"{pod.meta.name}.{pod.spec.subdomain}.{pod.meta.namespace}"
        self.store.update_status(pod)
        return None


class ControlPlane:
    def __init__(
        self,
        scheduler_provider: Optional[str] = None,
        enable_scheduler: bool = False,
        auto_ready: bool = False,
        require_binding: bool = False,
        store: Optional[Store] = None,
        leader_election: bool = False,
        identity: Optional[str] = None,
        **election_kw,
    ) -> None:
        from lws_tpu_torch.core.metrics import MetricsRegistry

        # A pre-existing store = controller restart over live state; call
        # resync() after construction.
        self.store = store if store is not None else Store()
        self.recorder = EventRecorder()
        self.metrics = MetricsRegistry()

        provider = make_scheduler_provider(scheduler_provider, self.store)
        register_lws_webhooks(self.store)
        register_pod_webhooks(self.store, provider)
        register_ds_webhooks(self.store)

        self.manager = Manager(self.store, metrics=self.metrics)

        # HA: with leader_election on, this manager reconciles only while it
        # holds the cluster Lease (reference cmd/main.go:95-106 semantics —
        # standbys watch but stay passive until the lease expires).
        self.elector = None
        if leader_election:
            import os
            import uuid

            from lws_tpu_torch.core.election import LeaderElector

            self.elector = LeaderElector(
                self.store,
                identity=identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}",
                **election_kw,
            )
            # Gate ALL dispatch (deterministic and threaded) on holding the
            # lease — a standby that reconciled would be a split brain.
            self.manager.gate = self.elector.is_leader
        store = self.store

        def lws_key_by_label(obj) -> list[Key]:
            name = obj.meta.labels.get(contract.SET_NAME_LABEL_KEY)
            return [("LeaderWorkerSet", obj.meta.namespace, name)] if name else []

        def leader_pods_of_lws(obj) -> list[Key]:
            name = obj.meta.labels.get(contract.SET_NAME_LABEL_KEY)
            if not name:
                return []
            return store.list_keys(
                "Pod",
                obj.meta.namespace,
                labels={contract.SET_NAME_LABEL_KEY: name, contract.WORKER_INDEX_LABEL_KEY: "0"},
            )

        def groupset_owner_of_pod(obj) -> list[Key]:
            owner = obj.meta.controller_owner()
            if owner is not None and owner.kind == "GroupSet":
                return [("GroupSet", obj.meta.namespace, owner.name)]
            return []

        _lws_fanout_gen: "collections.OrderedDict" = collections.OrderedDict()

        def pods_of_lws(obj) -> list[Key]:
            # LWS SPEC changes (size, template) flow through leader pods.
            # Status-only updates keep meta.generation, and during a fleet
            # rollout the LWS status churns once per group — fanning every
            # one of those out to every leader pod was the dominant source
            # of no-op pod reconciles (CONTROL_r04 rollout). Pods requeue
            # themselves through their own direct watch; this mapper only
            # needs to fire on generation edges. Deleted dependents are
            # repaired by the owner_pod_of_deleted / leader_pod_of_groupset
            # DELETED-only mappers below, not by this side channel.
            # Memo keyed by uid: a deleted-and-recreated LWS restarts its
            # generation counter and must not inherit the old memo. Bounded
            # LRU (DS rollouts churn uniquely-named child LWSes forever):
            # move-to-end on hit so long-lived LWSes survive eviction —
            # insertion-order eviction dropped exactly the live fleet
            # entries the gate targets (ADVICE r4).
            memo_key = (obj.key(), obj.meta.uid)
            gen = obj.meta.generation
            prev = _lws_fanout_gen.get(memo_key)
            if prev is not None:
                _lws_fanout_gen.move_to_end(memo_key)
                if prev == gen:
                    return []
            _lws_fanout_gen[memo_key] = gen
            while len(_lws_fanout_gen) > 8192:
                _lws_fanout_gen.popitem(last=False)
            return store.list_keys(
                "Pod",
                obj.meta.namespace,
                labels={contract.SET_NAME_LABEL_KEY: obj.meta.name, contract.WORKER_INDEX_LABEL_KEY: "0"},
            )

        self.lws_controller = LWSReconciler(self.store, self.recorder, metrics=self.metrics)
        self.manager.register(
            self.lws_controller,
            {
                "LeaderWorkerSet": lambda o: [o.key()],
                "GroupSet": lws_key_by_label,
                "Service": lws_key_by_label,
                "Pod": lws_key_by_label,
            },
        )

        from lws_tpu_torch.core.manager import deleted_only

        @deleted_only
        def leader_pod_of_groupset(obj) -> list[Key]:
            # Worker groupsets are named after their leader pod; deleting one
            # must requeue that leader directly so the pod controller
            # recreates it (previously this recovery rode the LWS
            # status-churn side channel, which the generation gate above
            # rightly cuts). DELETED-only: firing on every creation/status
            # write would reintroduce the no-op churn the gate removed.
            if contract.GROUP_INDEX_LABEL_KEY in obj.meta.labels:
                return [("Pod", obj.meta.namespace, obj.meta.name)]
            return []

        @deleted_only
        def owner_pod_of_deleted(obj) -> list[Key]:
            # Per-replica Services and gang PodGroups are owned by their
            # leader pod; deleting one requeues that pod so its reconcile
            # recreates the dependent (same repair edge as above).
            owner = obj.meta.controller_owner()
            if owner is not None and owner.kind == "Pod":
                return [("Pod", obj.meta.namespace, owner.name)]
            return []

        self.pod_controller = PodReconciler(self.store, self.recorder, provider)
        self.manager.register(
            self.pod_controller,
            {
                "Pod": lambda o: [o.key()],
                "ControllerRevision": leader_pods_of_lws,
                "Node": lambda o: [],  # placeholder; exclusive placement keys off pod binding
                "LeaderWorkerSet": pods_of_lws,
                "GroupSet": leader_pod_of_groupset,
                "Service": owner_pod_of_deleted,
                "PodGroup": owner_pod_of_deleted,
            },
        )

        self.groupset_controller = GroupSetReconciler(self.store, self.recorder)
        self.manager.register(
            self.groupset_controller,
            {
                "GroupSet": lambda o: [o.key()],
                "Pod": groupset_owner_of_pod,
            },
        )

        from lws_tpu_torch.api import disagg
        from lws_tpu_torch.controllers.disagg import DSReconciler

        def ds_key_by_label(obj) -> list[Key]:
            name = obj.meta.labels.get(disagg.DS_NAME_LABEL_KEY)
            return [("DisaggregatedSet", obj.meta.namespace, name)] if name else []

        self.ds_controller = DSReconciler(self.store, self.recorder)
        self.manager.register(
            self.ds_controller,
            {
                "DisaggregatedSet": lambda o: [o.key()],
                "LeaderWorkerSet": ds_key_by_label,
            },
        )

        from lws_tpu_torch.controllers.autoscaler_controller import AutoscalerReconciler

        def autoscalers_watching(obj) -> list[Key]:
            # Leader pod metric annotations / LWS changes retrigger autoscalers.
            return [
                asc.key()
                for asc in store.list("Autoscaler", obj.meta.namespace)
                if asc.spec.target == obj.meta.labels.get(contract.SET_NAME_LABEL_KEY, obj.meta.name)
            ]

        self.autoscaler_controller = AutoscalerReconciler(self.store, self.recorder)
        self.manager.register(
            self.autoscaler_controller,
            {
                "Autoscaler": lambda o: [o.key()],
                "Pod": autoscalers_watching,
                "LeaderWorkerSet": autoscalers_watching,
            },
        )

        if enable_scheduler:
            # The scheduler subscribes its own store watch for its incremental
            # pod indexes (binding state, gang membership, pending set).
            self.scheduler = Scheduler(self.store, self.recorder)

            def pending_work(obj) -> list[Key]:
                # Node added/uncordoned or PodGroup created: requeue one
                # representative per waiting gang + waiting solo pods
                # (was: every unbound pod — O(pods) keys per event).
                return self.scheduler.pending_representatives()

            self.manager.register(
                self.scheduler,
                {
                    "Pod": lambda o: [o.key()],
                    "Node": pending_work,
                    "PodGroup": pending_work,
                },
            )
            from lws_tpu_torch.controllers.node_monitor import NodeMonitor

            self.node_monitor = NodeMonitor(self.store, self.recorder)
            self.manager.register(self.node_monitor, {"Node": lambda o: [o.key()]})

        if auto_ready:
            self.kubelet = FakeKubelet(self.store, require_binding=require_binding)
            self.manager.register(self.kubelet, {"Pod": lambda o: [o.key()]})

        # Fleet telemetry plane: the collector merges every ready worker's
        # /metrics into /metrics/fleet (this registry + the process serving
        # registry ride along as instance "control-plane"); the watchdog
        # evaluates stall/hot-loop/backlog rules over the process flight
        # recorder's heartbeats. run_until_stable ticks it deterministically;
        # start() runs it on a thread.
        from lws_tpu_torch.core.flightrecorder import Watchdog
        from lws_tpu_torch.core.metrics import REGISTRY as _process_registry
        from lws_tpu_torch.runtime.fleet import FleetCollector

        control_regs = (
            (self.metrics,) if self.metrics is _process_registry
            else (self.metrics, _process_registry)
        )
        self.fleet = FleetCollector(self.store, control_registries=control_regs)
        self.watchdog = Watchdog(registries=(self.metrics,))

        # Rollout intelligence plane: the process-default ledger observes
        # this store's watch feed plus the process flight recorder, so
        # every revision flip, partition move, DS lockstep step, drain,
        # and pod churn the reconcile path produces lands on the timeline
        # (`GET /debug/rollout`, watchdog dumps, `lws-tpu rollout`).
        from lws_tpu_torch.obs import rollout as rolloutmod

        self.rollout = rolloutmod.LEDGER
        rolloutmod.install(self.store)

        # Decision plane: the provenance ledger (`GET /debug/decisions`,
        # `lws-tpu why`) plus the synchronous DS replica writeback that
        # lets the stock autoscaler move a DS child LWS without the DS
        # reconciler fighting it (obs/decisions.py).
        from lws_tpu_torch.obs import decisions as decisionsmod

        self.decisions = decisionsmod.DECISIONS
        decisionsmod.install(self.store)

    # ------------------------------------------------------------------
    def run_until_stable(self, max_iterations: int = 10000) -> int:
        if self.elector is not None:
            self.elector.tick()
        n = self.manager.run_until_stable(max_iterations)
        # Deterministic watchdog tick: non-threaded control planes (the
        # dominant test shape) still get alert evaluation after each drain.
        self.watchdog.check_now()
        return n

    def start(self) -> None:
        """Threaded mode: election loop (if configured) + controller workers.
        The manager's gate keeps standby workers passive until elected."""
        if self.elector is not None:
            self.elector.start()
        self.manager.start()
        self.watchdog.start()

    def stop(self) -> None:
        self.watchdog.stop()
        self.manager.stop()
        if self.elector is not None:
            self.elector.stop()

    def resync(self) -> None:
        """Cold-start cache resync: enqueue every stored object to every
        watching controller — required when standing up a fresh control plane
        over pre-existing state (level-triggered restart semantics)."""
        if getattr(self, "scheduler", None) is not None:
            self.scheduler.rebuild_from_store()
        self.manager.resync()

    def add_nodes(self, nodes: list[Node]) -> None:
        for node in nodes:
            self.store.create(node)

    def create(self, obj):
        return self.store.create(obj)
