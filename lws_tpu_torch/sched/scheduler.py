"""Slice-aware pod scheduler: binds pods to TPU-host Nodes.

Native replacement for kube-scheduler + Volcano gang admission. Honors:
  * node_selector (exclusive-placement follow-the-leader uses this,
    ref pod_controller.go:297-336),
  * chip capacity (google.com/tpu) with allocation tracking,
  * required pod affinity/anti-affinity over topology-key domains — the
    mechanism behind 1:1 group<->slice exclusive placement
    (ref pod_webhook.go:185-227),
  * gang admission: pods carrying a PodGroup annotation bind all-or-nothing
    once min_member peers exist and a joint feasible assignment is found.

The port's copy of lws_tpu/sched/scheduler.py.
"""

from __future__ import annotations

import threading
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.node import Node
from lws_tpu_torch.api.pod import Pod, PodPhase
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import Key, Store


class Scheduler:
    name = "scheduler"

    def __init__(self, store: Store, recorder: EventRecorder) -> None:
        self.store = store
        self.recorder = recorder
        # Incremental pod indexes, maintained from the store watch (which
        # carries event types, so deletions purge exactly — events are
        # delivered in commit order):
        #   _pending:  key -> gang name (None = solo); consumed by
        #              pending_representatives() so a capacity event requeues
        #              ONE key per waiting gang instead of every unbound pod
        #              (the O(pods) fan-out that collapsed at fleet scale).
        #   _bound:    key -> Pod for node-bound pods; replaces the full
        #              store list that re-ran after every single bind.
        #   _by_gang:  (ns, gang) -> {key: Pod} membership.
        # A scheduler stood up over PRE-EXISTING state (restart/restore) must
        # have rebuild_from_store() called — ControlPlane.resync() does.
        self._pending: dict[Key, Optional[str]] = {}  # guarded-by: _pending_lock
        self._bound: dict[Key, Pod] = {}  # guarded-by: _pending_lock
        self._by_gang: dict[tuple[str, str], dict[Key, Pod]] = {}
        self._gang_of: dict[Key, str] = {}  # reverse map for O(1) moves/purges
        # Placement aggregates: _feasible_node used to rescan every bound pod
        # per placement — O(fleet^2) turnup at 512+ pods (CONTROL_r04 note).
        # Watch-fed counters make the common exclusive-placement terms
        # O(group) instead:
        #   _chips_by_node: node -> TPU chips of bound pods (capacity is
        #                   physical, so this one is cluster-global)
        #   _hash_nodes:    (ns, hash_label, value) -> {node: pod count}
        #   _hash_total:    (ns, hash_label) -> {node: pod count}
        self._chips_by_node: dict[str, int] = {}
        self._bound_state: dict[Key, tuple[str, int, list[tuple[str, str]]]] = {}  # guarded-by: _pending_lock
        self._hash_nodes: dict[tuple[str, str, str], dict[str, int]] = {}
        self._hash_total: dict[tuple[str, str], dict[str, int]] = {}
        self._pending_lock = threading.Lock()
        store.watch(self._observe)

    _TRACKED_HASH_KEYS = (
        contract.GROUP_UNIQUE_HASH_LABEL_KEY,
        contract.SUBGROUP_UNIQUE_HASH_LABEL_KEY,
    )

    def _unindex_bound_locked(self, key: Key) -> None:
        prev = self._bound_state.pop(key, None)
        if prev is None:
            return
        node, chips, hashes = prev
        if chips:
            left = self._chips_by_node.get(node, 0) - chips
            if left > 0:
                self._chips_by_node[node] = left
            else:
                self._chips_by_node.pop(node, None)
        ns = key[1]
        for lk, v in hashes:
            for index, ik in ((self._hash_nodes, (ns, lk, v)),
                              (self._hash_total, (ns, lk))):
                bucket = index.get(ik)
                if bucket is None:
                    continue
                c = bucket.get(node, 0) - 1
                if c > 0:
                    bucket[node] = c
                else:
                    bucket.pop(node, None)
                    if not bucket:
                        index.pop(ik, None)

    def _index_bound_locked(self, key: Key, pod: Pod) -> None:
        self._unindex_bound_locked(key)
        node = pod.spec.node_name
        if not node:
            return
        chips = pod.spec.effective_tpu_chips()
        if chips:
            self._chips_by_node[node] = self._chips_by_node.get(node, 0) + chips
        ns = key[1]
        hashes: list[tuple[str, str]] = []
        for lk in self._TRACKED_HASH_KEYS:
            v = pod.meta.labels.get(lk)
            if v is None:
                continue
            hashes.append((lk, v))
            for index, ik in ((self._hash_nodes, (ns, lk, v)),
                              (self._hash_total, (ns, lk))):
                bucket = index.setdefault(ik, {})
                bucket[node] = bucket.get(node, 0) + 1
        self._bound_state[key] = (node, chips, hashes)

    # ---- incremental pod indexes (fleet-scale event fan-out) ---------------
    def _observe(self, event) -> None:
        # Store-watch observer, running on the committing writer's thread: an
        # index-update bug must not propagate into whichever reconcile/serving
        # thread committed the write. rebuild_from_store() re-seeds a
        # desynced index from store truth.
        if not isinstance(event.obj, Pod):
            return
        try:
            if event.type == "DELETED":
                self._forget_pending(event.obj.key())
            else:
                self.note_pod(event.obj)
        except Exception:  # vet: ignore[hazard-exception-swallow]: a broken index update must not kill the committing writer (purity-observer-raise); rebuild_from_store recovers
            pass

    def rebuild_from_store(self) -> None:
        """Seed the indexes from current store state (cold start over a
        restored store — the watch never saw those objects)."""
        with self._pending_lock:
            self._pending.clear()
            self._bound.clear()
            self._by_gang.clear()
            self._gang_of.clear()
            self._chips_by_node.clear()
            self._bound_state.clear()
            self._hash_nodes.clear()
            self._hash_total.clear()
        for pod in self.store.list("Pod"):
            self.note_pod(pod)

    def note_pod(self, pod) -> None:
        """Track binding state + gang membership for one observed pod."""
        if not isinstance(pod, Pod):
            return
        key = pod.key()
        # `or None`: an empty-string annotation means solo everywhere else
        # (reconcile's truthiness check) — storing "" would fold all such
        # pods into one pseudo-gang with a single requeue representative.
        gang = pod.meta.annotations.get(contract.POD_GROUP_ANNOTATION_KEY) or None
        with self._pending_lock:
            prev_gang = self._gang_of.get(key)
            if prev_gang is not None and prev_gang != gang:
                # Annotation changed/removed: leave the old gang's bucket so
                # its joint assignment never binds an ex-member.
                self._drop_from_gang_locked(key, prev_gang)
            if gang:
                self._by_gang.setdefault((key[1], gang), {})[key] = pod
                self._gang_of[key] = gang
            if pod.spec.node_name:
                self._pending.pop(key, None)
                self._bound[key] = pod
                self._index_bound_locked(key, pod)
            else:
                self._bound.pop(key, None)
                self._unindex_bound_locked(key)
                if pod.status.phase == PodPhase.PENDING:
                    self._pending[key] = gang
                else:
                    self._pending.pop(key, None)

    def pending_representatives(self) -> list[Key]:
        """One key per waiting gang + every waiting solo pod: what a capacity
        event (Node added/uncordoned, PodGroup created) needs to requeue."""
        with self._pending_lock:
            reps: dict[tuple[str, str], Key] = {}
            solos: list[Key] = []
            for key, gang in self._pending.items():
                if gang is None:
                    solos.append(key)
                else:
                    prev = reps.get((key[1], gang))
                    if prev is None or key < prev:
                        reps[(key[1], gang)] = key
            return solos + sorted(reps.values())

    def _drop_from_gang_locked(self, key: Key, gang: str) -> None:
        members = self._by_gang.get((key[1], gang))
        if members is not None:
            members.pop(key, None)
            if not members:
                del self._by_gang[(key[1], gang)]
        self._gang_of.pop(key, None)

    def _forget_pending(self, *keys: Key) -> None:
        """Drop deleted pods from every index."""
        with self._pending_lock:
            for key in keys:
                self._pending.pop(key, None)
                self._bound.pop(key, None)
                self._unindex_bound_locked(key)
                gang = self._gang_of.get(key)
                if gang is not None:
                    self._drop_from_gang_locked(key, gang)

    # ---- reconcile ---------------------------------------------------------
    def reconcile(self, key: Key) -> Result | None:
        pod = self.store.try_get("Pod", key[1], key[2])
        if pod is None or not isinstance(pod, Pod):
            self._forget_pending(key)  # belt-and-braces; _observe purges live
            return None
        if pod.spec.node_name:
            return None  # already bound (note_pod keeps the indexes current)
        if pod.spec.scheduler_name and pod.spec.scheduler_name != self.name:
            # Stamped for an external scheduler (ExternalSchedulerProvider):
            # binding happens via the API; the native scheduler leaves the
            # pod strictly alone even when both are enabled.
            return None

        gang_name = pod.meta.annotations.get(contract.POD_GROUP_ANNOTATION_KEY)
        if gang_name:
            self._schedule_gang(pod.meta.namespace, gang_name)
        else:
            nodes = self._nodes()
            node = self._feasible_node(pod, nodes, extra_assigned={})
            if node is not None:
                self._bind(pod, node)
            else:
                self.recorder.event(pod, "Warning", "FailedScheduling", "no feasible node")
        return None

    # ---- gang --------------------------------------------------------------
    def _schedule_gang(self, namespace: str, gang_name: str) -> None:
        group = self.store.try_get("PodGroup", namespace, gang_name)
        if group is None:
            return  # wait for the PodGroup; its creation event retriggers us
        members = self._gang_members(namespace, gang_name)
        pending = [p for p in members if not p.spec.node_name]
        min_member = group.spec.min_member
        if not pending:
            return
        nodes = self._nodes()
        allowed: Optional[set[str]] = None
        members_chips = sum(p.spec.effective_tpu_chips() for p in members)
        need_chips = group.spec.min_resources.get(contract.TPU_RESOURCE_NAME, 0)
        if len(members) < min_member or members_chips < need_chips:
            # The gang's full demand is not yet represented by live pods (the
            # common LWS shape: the leader exists, workers follow only once it
            # is placed — worker groupsets gate on leader binding under
            # exclusive placement, ref pod_controller.go:162-172; LeaderReady
            # even sets min_member=1). Admit early members only if some
            # topology domain can RESERVE the whole group's min_resources;
            # otherwise a leader binding to a too-small slice deadlocks the
            # group (SURVEY §7 "gang admission on slices").
            allowed = self._reserve_for_group(group, pending[0], nodes)
            if allowed is None:
                self.recorder.event(
                    group, "Warning", "GangNotSchedulable",
                    f"no topology domain can hold min_resources {group.spec.min_resources}",
                )
                return
        # Joint assignment: greedily place every pending member treating
        # earlier in-pass assignments as bound; all-or-nothing on failure.
        assignment: dict[str, str] = {}  # pod name -> node name
        extra: dict[str, Pod] = {}
        usable = nodes if allowed is None else [n for n in nodes if n.meta.name in allowed]
        for p in sorted(pending, key=lambda p: p.meta.name):
            node = self._feasible_node(p, usable, extra_assigned=extra)
            if node is None:
                self.recorder.event(
                    group, "Warning", "GangNotSchedulable",
                    f"no joint assignment for {len(pending)} pending pods",
                )
                return
            assignment[p.meta.name] = node.meta.name
            placed = p.deepcopy()
            placed.spec.node_name = node.meta.name
            extra[p.meta.name] = placed
        for p in pending:
            self._bind(p, node_name=assignment[p.meta.name])
        if len(members) >= min_member and group.status.phase != "Running":
            group.status.phase = "Running"
            self.store.update_status(group)

    def _reserve_for_group(
        self, group, sample_pod: Pod, nodes: list[Node]
    ) -> Optional[set[str]]:
        """Find a topology domain whose free chips fit the whole gang's
        min_resources; returns the node names of that domain (None if no fit).

        The domain key is the sample pod's exclusive-affinity topology key when
        present (one slice per group), else the whole cluster is one domain.
        """
        candidates = [
            n
            for n in nodes
            if all(n.meta.labels.get(k) == v for k, v in sample_pod.spec.node_selector.items())
        ]
        need = group.spec.min_resources.get(contract.TPU_RESOURCE_NAME, 0)
        topology_key = None
        if sample_pod.spec.affinity is not None and sample_pod.spec.affinity.required_affinity:
            topology_key = sample_pod.spec.affinity.required_affinity[0].topology_key
        domains: dict[str, list[Node]] = {}
        for n in candidates:
            domain = n.meta.labels.get(topology_key, "") if topology_key else ""
            if topology_key and domain == "":
                continue
            domains.setdefault(domain, []).append(n)
        with self._pending_lock:
            used_by_node = dict(self._chips_by_node)
        for _, domain_nodes in sorted(domains.items()):
            free = sum(
                n.spec.capacity.get(contract.TPU_RESOURCE_NAME, 0)
                - used_by_node.get(n.meta.name, 0)
                for n in domain_nodes
            )
            if free >= need:
                return {n.meta.name for n in domain_nodes}
        return None

    # ---- feasibility -------------------------------------------------------
    def _nodes(self) -> list[Node]:
        # Nodes are cluster-scoped hardware (api.node.CLUSTER_NAMESPACE);
        # the fleet changes rarely next to pod churn, so the view is cached
        # on the store's Node mutation counter (scheduling is O(pods) calls
        # deep and re-listing per call dominated turnup profiles).
        version = self.store.kind_version("Node")
        cached = getattr(self, "_node_cache", None)
        if cached is not None and cached[0] == version:
            return cached[1]
        nodes = [
            n
            for n in self.store.list("Node")  # vet: ignore[purity-fleet-scan]: cached on the Node mutation counter above — one scan per node-set CHANGE, not per reconcile
            if isinstance(n, Node) and n.status.ready and not n.spec.unschedulable
        ]
        self._node_cache = (version, nodes)
        return nodes

    def _nodes_by_domain(self, topology_key: str) -> dict[str, list[Node]]:
        """domain value -> nodes carrying it, cached on the Node mutation
        counter (same invalidation as _nodes): lets _feasible_node score
        only the nodes inside a group's affinity domains instead of the
        whole fleet (512 slices x 4 hosts = 2048 scored nodes per placement
        before this; 4 after, for every follower pod)."""
        version = self.store.kind_version("Node")
        cache = getattr(self, "_domain_cache", None)
        if cache is None or cache[0] != version:
            cache = (version, {})
            self._domain_cache = cache
        by_key = cache[1].get(topology_key)
        if by_key is None:
            by_key = {}
            for n in self._nodes():
                d = n.meta.labels.get(topology_key)
                if d is not None:
                    by_key.setdefault(d, []).append(n)
            cache[1][topology_key] = by_key
        return by_key

    def _gang_members(self, namespace: str, gang_name: str) -> list[Pod]:
        with self._pending_lock:
            members = self._by_gang.get((namespace, gang_name), {})
            return sorted(members.values(), key=lambda p: p.meta.name)

    def _bound_pods(self, namespace: str) -> list[Pod]:
        with self._pending_lock:
            return [p for k, p in self._bound.items() if k[1] == namespace]

    @staticmethod
    def _term_fast_shape(term) -> Optional[tuple[str, str, str]]:
        """Recognize the exclusive-placement webhook's two affinity-term
        shapes (pod_webhook.set_exclusive_affinities) so they can be
        answered from the watch-fed hash indexes instead of a bound-pod
        scan: ("in", key, v) for [key IN [v]]; ("anti", key, v) for
        [key EXISTS, key NOT_IN [v]]. Anything else -> None (the generic
        fallback scan keeps full selector semantics)."""
        from lws_tpu_torch.api.pod import AffinityOperator as Op

        exprs = term.match_expressions
        if (len(exprs) == 1 and exprs[0].operator == Op.IN
                and len(exprs[0].values) == 1
                and exprs[0].key in Scheduler._TRACKED_HASH_KEYS):
            return ("in", exprs[0].key, exprs[0].values[0])
        if len(exprs) == 2:
            by_op = {e.operator: e for e in exprs}
            if (set(by_op) == {Op.EXISTS, Op.NOT_IN}
                    and by_op[Op.EXISTS].key == by_op[Op.NOT_IN].key
                    and len(by_op[Op.NOT_IN].values) == 1
                    and by_op[Op.EXISTS].key in Scheduler._TRACKED_HASH_KEYS):
                return ("anti", by_op[Op.EXISTS].key, by_op[Op.NOT_IN].values[0])
        return None

    def _feasible_node(
        self,
        pod: Pod,
        nodes: list[Node],
        extra_assigned: dict[str, Pod],
    ) -> Optional[Node]:
        node_by_name = {n.meta.name: n for n in nodes}
        extras = [p for p in extra_assigned.values() if p.meta.name != pod.meta.name]

        def domain_of_node(name: Optional[str], topology_key: str) -> Optional[str]:
            n = node_by_name.get(name)
            return None if n is None else n.meta.labels.get(topology_key)

        def domain_of(p: Pod, topology_key: str) -> Optional[str]:
            return domain_of_node(p.spec.node_name, topology_key)

        # Fast path: chip usage and the exclusive-placement affinity terms
        # are answered from the watch-fed indexes (O(group) per placement);
        # only terms the webhook never emits fall back to scanning the bound
        # pods — built lazily so the common path never pays O(fleet)
        # (CONTROL_r04: the scan made turnup O(fleet^2) at 512+ pods).
        _lazy: list = []

        def all_pods() -> list:
            if not _lazy:
                # The namespace-filtered bound snapshot is itself O(fleet);
                # built ONLY here so webhook-shaped placements never pay it.
                _lazy.append(
                    [p for p in self._bound_pods(pod.meta.namespace)
                     if p.meta.name != pod.meta.name] + extras
                )
            return _lazy[0]

        ns = pod.meta.namespace
        chips_needed = pod.spec.effective_tpu_chips()
        with self._pending_lock:
            used_by_node = dict(self._chips_by_node)
        for p in extras:
            if p.spec.node_name:
                used_by_node[p.spec.node_name] = (
                    used_by_node.get(p.spec.node_name, 0)
                    + p.spec.effective_tpu_chips()
                )

        aff = pod.spec.affinity
        # (topology_key, domains): node must carry the key AND, when domains
        # is non-None, sit in one of them. domains=None = self-affinity
        # bootstrap (first pod of the group may open any labeled domain —
        # kube-scheduler's special case; an UNlabeled node stays ineligible,
        # else peers would inherit an unschedulable None-domain).
        aff_domains: list[tuple[str, Optional[set]]] = []
        anti_domains: list[tuple[str, set]] = []
        if aff is not None:
            for term in aff.required_affinity:
                fast = self._term_fast_shape(term)
                if fast is not None and fast[0] == "in":
                    _, lk, v = fast
                    with self._pending_lock:
                        nodeset = set(self._hash_nodes.get((ns, lk, v), ()))
                    for p in extras:
                        if term.selector_matches(p.meta.labels):
                            nodeset.add(p.spec.node_name)
                    if not nodeset:
                        if term.selector_matches(pod.meta.labels):
                            aff_domains.append((term.topology_key, None))
                            continue
                        return None  # nothing can satisfy this term
                    aff_domains.append((
                        term.topology_key,
                        {domain_of_node(n, term.topology_key) for n in nodeset},
                    ))
                    continue
                matching = [p for p in all_pods() if term.selector_matches(p.meta.labels)]
                if not matching:
                    if term.selector_matches(pod.meta.labels):
                        aff_domains.append((term.topology_key, None))
                        continue
                    return None  # nothing can satisfy this term
                aff_domains.append(
                    (term.topology_key,
                     {domain_of(p, term.topology_key) for p in matching})
                )
            for term in aff.required_anti_affinity:
                fast = self._term_fast_shape(term)
                if fast is not None and fast[0] == "anti":
                    _, lk, v = fast
                    with self._pending_lock:
                        total = self._hash_total.get((ns, lk), {})
                        mine = self._hash_nodes.get((ns, lk, v), {})
                        nodeset = {
                            n for n, c in total.items() if c - mine.get(n, 0) > 0
                        }
                    for p in extras:
                        if term.selector_matches(p.meta.labels):
                            nodeset.add(p.spec.node_name)
                    domains = {
                        domain_of_node(n, term.topology_key) for n in nodeset
                    }
                else:
                    domains = {
                        domain_of(p, term.topology_key)
                        for p in all_pods()
                        if term.selector_matches(p.meta.labels)
                    }
                domains.discard(None)
                if domains:
                    anti_domains.append((term.topology_key, domains))

        group_key = pod.meta.labels.get(contract.GROUP_UNIQUE_HASH_LABEL_KEY)
        peers_by_slice: dict[str, int] = {}
        if group_key:
            with self._pending_lock:
                gbucket = dict(self._hash_nodes.get(
                    (ns, contract.GROUP_UNIQUE_HASH_LABEL_KEY, group_key), ()
                ))
            for n, c in gbucket.items():
                slice_id = domain_of_node(n, contract.NODE_TPU_SLICE_LABEL)
                if slice_id is not None:
                    peers_by_slice[slice_id] = peers_by_slice.get(slice_id, 0) + c
            for p in extras:
                if p.meta.labels.get(contract.GROUP_UNIQUE_HASH_LABEL_KEY) == group_key:
                    slice_id = domain_of(p, contract.NODE_TPU_SLICE_LABEL)
                    if slice_id is not None:
                        peers_by_slice[slice_id] = peers_by_slice.get(slice_id, 0) + 1

        # Candidate restriction: when an affinity term pins the pod to
        # concrete domains, only the nodes INSIDE those domains can pass the
        # per-node domain check below — score just those (the domain index
        # is fleet-wide, so intersect with the caller's `nodes` via the
        # node_by_name map already built). Winner is identical: the score
        # tuple is a strict total order and excluded nodes would have
        # failed the aff_domains check anyway.
        candidates = nodes
        allowed = node_by_name
        for topology_key, domains in aff_domains:
            if domains is None:
                continue
            by_dom = self._nodes_by_domain(topology_key)
            subset = [
                n
                for d in sorted(d for d in domains if d is not None)
                for n in by_dom.get(d, ())
                if n.meta.name in allowed
            ]
            if len(subset) < len(candidates):
                candidates = subset
                # Later terms intersect with THIS narrowing, not the full
                # fleet — otherwise a second term's larger-but-smaller-than-
                # baseline subset would resurrect nodes term 1 excluded.
                allowed = {n.meta.name for n in candidates}

        best = None
        best_score = None
        for node in candidates:
            labels = node.meta.labels
            if any(labels.get(k) != v for k, v in pod.spec.node_selector.items()):
                continue
            if chips_needed > 0:
                free = node.spec.capacity.get(contract.TPU_RESOURCE_NAME, 0) - used_by_node.get(
                    node.meta.name, 0
                )
                if free < chips_needed:
                    continue
            ok = True
            for topology_key, domains in aff_domains:
                node_domain = labels.get(topology_key)
                if node_domain is None or (domains is not None and node_domain not in domains):
                    ok = False
                    break
            if ok:
                for topology_key, domains in anti_domains:
                    node_domain = labels.get(topology_key)
                    if node_domain is not None and node_domain in domains:
                        ok = False
                        break
            if not ok:
                continue
            # Deterministic bin-packing: prefer slices already hosting peers
            # of the same group key, then stable order.
            slice_id = labels.get(contract.NODE_TPU_SLICE_LABEL, "")
            score = (-peers_by_slice.get(slice_id, 0), slice_id, node.meta.name)
            if best_score is None or score < best_score:
                best, best_score = node, score
        return best

    # ---- binding -----------------------------------------------------------
    def _bind(self, pod: Pod, node: Optional[Node] = None, node_name: str = "") -> None:
        fresh = self.store.try_get("Pod", pod.meta.namespace, pod.meta.name)
        if fresh is None or fresh.spec.node_name:
            return
        fresh.spec.node_name = node.meta.name if node is not None else node_name
        self.store.update(fresh)
        self.recorder.event(fresh, "Normal", "Scheduled", f"bound to {fresh.spec.node_name}")
