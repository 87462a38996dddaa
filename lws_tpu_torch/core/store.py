"""Versioned in-memory object store with watches and owner-based cascade GC.

Plays the role Kubernetes' apiserver+etcd play for the reference: the single
source of truth all controllers reconcile against. Objects are deep-copied on
the way in and out (apiserver boundary isolation); writes use optimistic
concurrency on `resource_version`; every mutation fans out a WatchEvent.

Controllers are stateless against this store, so crash/restart resumes any
rollout mid-flight exactly like the reference (SURVEY §5 checkpoint/resume).

The port's copy of lws_tpu/core/store.py. Left out: the JAX package's
native clone (native/fastclone.c, an optional C extension with the same
semantics as `_py_clone`); the port always clones in Python. The journal
hook (`_journal`) and the restore helpers stay for the write-ahead log,
which waits for ROADMAP Queue 1 (c), durability and HA.
"""

from __future__ import annotations

import collections
import copy
import enum
import itertools
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject, to_plain


class NotFoundError(KeyError):
    pass


class ConflictError(RuntimeError):
    pass


class AlreadyExistsError(RuntimeError):
    pass


class AdmissionError(ValueError):
    """Raised when a validating admission hook rejects a write."""


class FieldManagerConflict(RuntimeError):
    """Server-side apply refused: another field manager owns one of the
    applied fields and force=False. Carries [(path, owner), ...]."""

    def __init__(self, conflicts: list):
        self.conflicts = conflicts
        lines = ", ".join(f"{'.'.join(p)} (owned by {o!r})" for p, o in conflicts)
        super().__init__(f"field conflicts: {lines}")


_SCALARS = frozenset((str, int, float, bool, type(None)))


def _py_clone(x):
    """Deep copy specialized for API object trees (dataclasses, dicts, lists,
    scalars, enums — trees by admission-time construction: built from plain
    manifests/dataclasses, so no cycles or shared sub-references; a cyclic
    object raises RecursionError rather than hanging). An order of magnitude
    faster than copy.deepcopy, which dominated control-plane convergence
    profiles; dispatch ordered by node frequency. Recurses via its own fixed
    name so it stays a pure-Python reference implementation even when the
    module-level `_clone` is rebound to the native extension."""
    cls = x.__class__
    if cls in _SCALARS:
        return x
    if cls is dict:
        return {k: _py_clone(v) for k, v in x.items()}
    if cls is list:
        return [_py_clone(v) for v in x]
    if getattr(cls, "__dataclass_fields__", None) is not None:
        d = getattr(x, "__dict__", None)
        if d is None:  # slots=True dataclass: match the native fallback
            return copy.deepcopy(x)
        new = cls.__new__(cls)
        nd = new.__dict__
        for k, v in d.items():
            nd[k] = _py_clone(v)
        return new
    if isinstance(x, enum.Enum):
        return x
    if cls is tuple:
        return tuple(_py_clone(v) for v in x)
    return copy.deepcopy(x)  # anything exotic: full generality


_clone = _py_clone


def clone_object(x):
    """Public fast deep-clone for API object trees (controllers cloning
    templates etc. — same engine as the Store's isolation boundary)."""
    return _clone(x)


@dataclass
class WatchEvent:
    type: str  # "ADDED" | "MODIFIED" | "DELETED"
    obj: TypedObject


Key = tuple[str, str, str]  # (kind, namespace, name)


def _flatten_leaf_paths(tree: dict, prefix: tuple = ()) -> list[tuple]:
    """Leaf field paths of a partial plain tree: dicts recurse, everything
    else (scalars, lists, None, empty dict) is a leaf."""
    out: list[tuple] = []
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.extend(_flatten_leaf_paths(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge (overlay wins; non-dict values replace). An
    EMPTY overlay dict replaces too — _flatten_leaf_paths treats it as a
    leaf claim of the whole subtree, so the merge must honor the same
    atomicity ("I want this map empty"), not silently keep old entries."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and v and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _reject_null_containers(x, path: tuple = ()) -> None:
    """AdmissionError when a decoded apply result carries None where the
    dataclass declares a container default (labels, annotations, containers,
    ...): from_plain materializes {\"labels\": null} as labels=None, which
    would commit and then crash the label indexer MID-WRITE — validate
    before anything becomes visible."""
    import dataclasses as _dc

    if _dc.is_dataclass(x) and not isinstance(x, type):
        for f in _dc.fields(x):
            v = getattr(x, f.name)
            if v is None and f.default_factory is not _dc.MISSING:  # type: ignore[misc]
                raise AdmissionError(
                    f"field {'.'.join(path + (f.name,))} may not be null"
                )
            _reject_null_containers(v, path + (f.name,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _reject_null_containers(v, path + (str(i),))
    elif isinstance(x, dict):
        for k, v in x.items():
            _reject_null_containers(v, path + (str(k),))


def _overlay_matches(base, overlay) -> bool:
    """True when every leaf of `overlay` already equals the value in `base`
    (dicts recurse; anything else compares directly) — the steady-state
    reconcile pre-check that makes a no-op apply cost one tree walk."""
    if isinstance(overlay, dict) and overlay:
        if not isinstance(base, dict):
            return False
        return all(k in base and _overlay_matches(base[k], v)
                   for k, v in overlay.items())
    return base == overlay


def _remove_path(tree: dict, path: tuple) -> None:
    """Delete the leaf at `path` (and any dict nodes it empties)."""
    node = tree
    parents = []
    for k in path[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            return
        parents.append((node, k))
        node = nxt
    node.pop(path[-1], None)
    for parent, k in reversed(parents):
        if parent[k] == {}:
            del parent[k]
        else:
            break


class Store:
    def __init__(self) -> None:
        self._objects: dict[Key, TypedObject] = {}  # guarded-by: _lock
        # Per-kind index: list() is the hottest store op (every reconcile
        # scans peers); iterating only the kind's bucket beats a full scan.
        self._by_kind: dict[str, dict[Key, TypedObject]] = {}  # guarded-by: _lock
        # Label index: (kind, label_key, label_value) -> keys. Controllers
        # list by owner labels constantly (pods of an LWS, role members of a
        # DS); without this every such list is a full scan of the kind.
        self._label_index: dict[tuple[str, str, str], set[Key]] = {}  # guarded-by: _lock
        # Controller-owner index: owner uid -> dependent keys. owned_by() and
        # delete-cascade were full-store scans; at fleet scale (512+ pods)
        # those scans — each cloning every object — dominated convergence.
        self._owner_index: dict[str, set[Key]] = {}  # guarded-by: _lock
        # Node binding index: node name -> keys of objects bound to it
        # (spec.node_name). Node drain/eviction used to scan-and-filter the
        # whole Pod fleet per NotReady node; at slice-preemption scale that
        # is O(fleet) work on the reconcile path for an O(pods-per-node)
        # answer.
        self._node_index: dict[str, set[Key]] = {}  # guarded-by: _lock
        # Per-kind mutation counter: lets read-heavy consumers (scheduler)
        # cache derived views and invalidate them precisely.
        self._kind_version: dict[str, int] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        self._rv = itertools.count(1)
        self._watchers: list[Callable[[WatchEvent], None]] = []
        # Watch delivery: events are enqueued in commit order while the store
        # lock is held and drained outside it under a dispatch lock, so
        # concurrent writers can never deliver events out of commit order
        # (the apiserver/client-go per-object resourceVersion guarantee).
        # Nested writes — from admission hooks (which run under _lock) or from
        # watchers (which run under _dispatch_lock) — only enqueue; the
        # outermost write or drain delivers everything FIFO. This both keeps
        # delivery order equal to commit order for every watcher and avoids
        # lock-order inversion (_lock held while waiting on _dispatch_lock).
        self._pending_events: collections.deque[WatchEvent] = collections.deque()
        self._dispatch_lock = threading.Lock()
        self._tls = threading.local()  # .write_depth, .draining
        # kind -> list of hooks, run inside create/update before storing.
        self._mutators: dict[str, list[Callable[[TypedObject, Optional[TypedObject]], None]]] = {}
        self._validators: dict[str, list[Callable[[TypedObject, Optional[TypedObject]], None]]] = {}
        # Write-ahead journal hook (core.wal.StateDir). Called under _lock
        # with ("create"|"update"|"delete", committed object) BEFORE the
        # mutation becomes visible: if the journal append raises (disk full,
        # I/O error), the write fails un-acknowledged and memory is unchanged
        # — durability of every acknowledged write is the WAL contract.
        self._journal: Optional[Callable[[str, TypedObject], None]] = None
        # Debug guard for list_shared's no-mutation contract (ADVICE r4):
        # when LWS_TPU_STORE_DEBUG=1 (set by tests/conftest.py), every commit
        # records a fingerprint of the stored object, and list_shared verifies
        # it before handing out aliases — so a caller that mutated a previous
        # shared result fails loudly at the next read instead of silently
        # corrupting the store (no rv bump, no watch event). Off in
        # production: fingerprinting costs a full to_plain per commit.
        self._shared_guard = os.environ.get("LWS_TPU_STORE_DEBUG", "") == "1"
        self._fingerprints: dict[Key, int] = {}  # guarded-by: _lock

    # ---- admission registration -------------------------------------------
    def register_mutator(self, kind: str, fn) -> None:
        self._mutators.setdefault(kind, []).append(fn)

    def register_validator(self, kind: str, fn) -> None:
        self._validators.setdefault(kind, []).append(fn)

    def _restore_object(self, obj: TypedObject) -> None:  # holds-lock: _lock
        """Snapshot/WAL restore: place an already-admitted object verbatim
        (no admission, no events), maintaining all indexes. WAL replay of an
        'update' record re-restores over an existing key — the previous
        version's label/owner index entries must not survive it (a stale
        owner entry would feed the delete cascade after failover)."""
        key = obj.key()
        prev = self._objects.get(key)
        if prev is not None:
            self._unindex_labels(key, prev)
            self._unindex_owners(key, prev)
            self._unindex_node(key, prev)
        self._objects[key] = obj
        self._by_kind.setdefault(key[0], {})[key] = obj
        self._index_labels(key, obj)
        self._index_owners(key, obj)
        self._index_node(key, obj)
        self._record_fingerprint(key, obj)
        self._bump_kind(key[0])  # invalidate kind_version-keyed caches

    def _forget_object(self, key: Key) -> None:  # holds-lock: _lock
        """WAL-replay counterpart of _restore_object: remove an object
        verbatim (no admission, no cascade, no events) — the journal already
        carries one record per cascaded deletion."""
        obj = self._objects.pop(key, None)
        if obj is not None:
            self._by_kind.get(key[0], {}).pop(key, None)
            self._unindex_labels(key, obj)
            self._unindex_owners(key, obj)
            self._unindex_node(key, obj)
            self._fingerprints.pop(key, None)
            self._bump_kind(key[0])

    def kind_version(self, kind: str) -> int:
        """Monotonic counter bumped on every create/update/delete of `kind`
        (cache-invalidation token for derived views)."""
        with self._lock:
            return self._kind_version.get(kind, 0)

    def _bump_kind(self, kind: str) -> None:  # holds-lock: _lock
        self._kind_version[kind] = self._kind_version.get(kind, 0) + 1

    def _index_labels(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        for lk, lv in obj.meta.labels.items():
            self._label_index.setdefault((key[0], lk, lv), set()).add(key)

    def _unindex_labels(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        for lk, lv in obj.meta.labels.items():
            bucket = self._label_index.get((key[0], lk, lv))
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._label_index[(key[0], lk, lv)]

    def _index_owners(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        for ref in obj.meta.owner_references:
            if ref.controller:
                self._owner_index.setdefault(ref.uid, set()).add(key)

    def _unindex_owners(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        for ref in obj.meta.owner_references:
            if ref.controller:
                bucket = self._owner_index.get(ref.uid)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del self._owner_index[ref.uid]

    def _index_node(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        node = getattr(getattr(obj, "spec", None), "node_name", "")
        if node:
            self._node_index.setdefault(node, set()).add(key)

    def _unindex_node(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        node = getattr(getattr(obj, "spec", None), "node_name", "")
        if node:
            bucket = self._node_index.get(node)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._node_index[node]

    def watch(self, fn: Callable[[WatchEvent], None]) -> Callable[[], None]:
        """Subscribe to all mutations; returns an unsubscribe handle."""
        self._watchers.append(fn)

        def unsubscribe() -> None:
            try:
                self._watchers.remove(fn)
            except ValueError:
                pass

        return unsubscribe

    # ---- reads -------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> TypedObject:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return _clone(obj)

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[TypedObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def _iter_matching_locked(
        self, kind: str, namespace: Optional[str], labels: Optional[dict[str, str]]
    ):
        """Yield (key, stored_obj) for every match. Caller holds the lock.
        The ONE copy of the matching logic all three list variants share:
        narrow by the smallest label bucket, then verify the rest."""
        if labels:
            buckets = [
                self._label_index.get((kind, lk, lv), set())
                for lk, lv in labels.items()
            ]
            objects = self._objects
            for key in min(buckets, key=len):
                obj = objects.get(key)
                if obj is None:
                    continue
                if namespace is not None and key[1] != namespace:
                    continue
                if any(obj.meta.labels.get(lk) != lv for lk, lv in labels.items()):
                    continue
                yield key, obj
        else:
            for key, obj in self._by_kind.get(kind, {}).items():
                if namespace is None or key[1] == namespace:
                    yield key, obj

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> list[TypedObject]:
        with self._lock:
            out = [_clone(obj) for _, obj in self._iter_matching_locked(kind, namespace, labels)]
            out.sort(key=lambda o: (o.meta.namespace, o.meta.name))
            return out

    def list_shared(
        self,
        kind: str,
        namespace: Optional[str] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> list[TypedObject]:
        """READ-ONLY list returning the stored objects THEMSELVES, no clone.

        Informer-cache semantics (controller-runtime returns shared cache
        pointers the same way): callers MUST NOT mutate the result — write
        paths go through get()+update(). Safe to hold across writes because
        every write REPLACES the stored entry with a fresh clone
        (_update_locked), never mutates in place, so a returned reference
        stays a stable snapshot. Exists for hot read-only reconcile paths:
        list()'s per-call deep clone of every match was the fleet-rollout
        bottleneck (CONTROL_r04). Under LWS_TPU_STORE_DEBUG=1 each returned
        object is fingerprint-checked against its commit-time state so a
        past caller's mutation fails loudly here instead of corrupting the
        store silently."""
        with self._lock:
            matches = list(self._iter_matching_locked(kind, namespace, labels))
            self._verify_fingerprints_locked(k for k, _ in matches)
            out = [obj for _, obj in matches]
            out.sort(key=lambda o: (o.meta.namespace, o.meta.name))
            return out

    @staticmethod
    def _fingerprint(obj: TypedObject) -> int:
        return hash(repr(to_plain(obj)))

    def _verify_fingerprints_locked(self, keys) -> None:
        """Shared-read guard (LWS_TPU_STORE_DEBUG=1): fail loudly if any
        stored object drifted from its commit-time fingerprint — i.e. a
        list_shared/owned_by_shared caller mutated an alias in place
        (no-mutation contract violated)."""
        if not self._shared_guard:
            return
        for key in keys:
            fp = self._fingerprints.get(key)
            if fp is not None and fp != self._fingerprint(self._objects[key]):
                raise AssertionError(
                    f"store corruption: shared object {key} was mutated in "
                    f"place by a shared-read caller (no-mutation contract "
                    f"violated)"
                )

    def _record_fingerprint(self, key: Key, obj: TypedObject) -> None:  # holds-lock: _lock
        if self._shared_guard:
            self._fingerprints[key] = self._fingerprint(obj)

    def list_keys(
        self,
        kind: str,
        namespace: Optional[str] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> list[Key]:
        """Matching keys WITHOUT cloning the objects — for event mappers and
        anything else that only fans out to keys. list() clones every match
        at the isolation boundary, which is pure waste when the caller never
        touches the objects (the fleet-rollout hot path, CONTROL_r04)."""
        with self._lock:
            return sorted(
                key for key, _ in self._iter_matching_locked(kind, namespace, labels)
            )

    # ---- writes ------------------------------------------------------------
    def _begin_write(self) -> None:
        self._tls.write_depth = getattr(self._tls, "write_depth", 0) + 1

    def _end_write(self) -> None:
        self._tls.write_depth -= 1

    def create(self, obj: TypedObject) -> TypedObject:
        obj = _clone(obj)
        self._begin_write()
        try:
            with self._lock:
                key = obj.key()
                if key in self._objects:
                    raise AlreadyExistsError(f"{key} already exists")
                self._admit(obj, None)
                obj.meta.uid = obj.meta.uid or uuid.uuid4().hex[:12]
                obj.meta.resource_version = next(self._rv)
                obj.meta.generation = 1
                obj.meta.creation_timestamp = time.time()
                if self._journal is not None:
                    self._journal("create", obj)
                self._objects[key] = obj
                self._by_kind.setdefault(key[0], {})[key] = obj
                self._index_labels(key, obj)
                self._index_owners(key, obj)
                self._index_node(key, obj)
                self._record_fingerprint(key, obj)
                self._bump_kind(key[0])
                stored = _clone(obj)
                self._pending_events.append(WatchEvent("ADDED", _clone(stored)))
        finally:
            self._end_write()
            # In the finally: if admission rejected THIS write but a nested
            # hook already committed side objects, their events must still
            # reach watchers — otherwise caches go permanently stale.
            self._drain_events()
        return stored

    def update(self, obj: TypedObject) -> TypedObject:
        """Spec/metadata update: bumps generation when the non-status portion
        changes. Optimistic-concurrency on resource_version."""
        return self._update(obj, status_only=False)

    def update_status(self, obj: TypedObject) -> TypedObject:
        """Status-subresource update: never bumps generation."""
        return self._update(obj, status_only=True)

    def _update(self, obj: TypedObject, status_only: bool) -> TypedObject:
        obj = _clone(obj)
        self._begin_write()
        try:
            stored = self._update_locked(obj, status_only)
        finally:
            self._end_write()
            self._drain_events()  # see create(): drain even on rejection
        return stored

    def _update_locked(self, obj: TypedObject, status_only: bool) -> TypedObject:
        # Chaos hook for the optimistic-concurrency paths: an armed
        # `store.conflict` schedule forces this update to LOSE its race —
        # the cooperative hit() (not fire()) because the typed failure is
        # the store's own ConflictError, which every retry loop
        # (_retry_conflicts, controller requeues) must absorb.
        from lws_tpu_torch.core import faults

        if faults.hit("store.conflict") is not None:
            raise ConflictError(f"{obj.key()}: injected optimistic-concurrency loss")
        with self._lock:
            key = obj.key()
            current = self._objects.get(key)
            if current is None:
                raise NotFoundError(f"{key} not found")
            if obj.meta.resource_version != current.meta.resource_version:
                raise ConflictError(
                    f"{key}: stale resource_version {obj.meta.resource_version} "
                    f"(current {current.meta.resource_version})"
                )
            if status_only:
                # Carry over everything but status from the stored object.
                preserved = _clone(current)
                preserved.status = obj.status  # type: ignore[attr-defined]
                obj = preserved
            else:
                self._admit(obj, current)
                # Immutable system metadata.
                obj.meta.uid = current.meta.uid
                obj.meta.creation_timestamp = current.meta.creation_timestamp
                obj.meta.generation = current.meta.generation
                # SSA ownership is system-managed: a plain updater that
                # didn't carry it forward (fresh desired-state object) must
                # not silently erase the co-ownership records.
                if not obj.meta.managed_fields and current.meta.managed_fields:
                    obj.meta.managed_fields = _clone(current.meta.managed_fields)
                if self._spec_changed(current, obj):
                    obj.meta.generation += 1
            obj.meta.resource_version = next(self._rv)
            if self._journal is not None:
                self._journal("update", obj)
            self._unindex_labels(key, current)
            self._unindex_owners(key, current)
            self._unindex_node(key, current)
            self._objects[key] = obj
            self._by_kind.setdefault(key[0], {})[key] = obj
            self._index_labels(key, obj)
            self._index_owners(key, obj)
            self._index_node(key, obj)
            self._record_fingerprint(key, obj)
            self._bump_kind(key[0])
            stored = _clone(obj)
            self._pending_events.append(WatchEvent("MODIFIED", _clone(stored)))
        return stored

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Delete + synchronous cascade of controller-owned dependents (the
        foreground-propagation the reference leans on for group teardown,
        ref pkg/controllers/pod_controller.go:258-263)."""
        events: list[WatchEvent] = []
        self._begin_write()
        try:
            with self._lock:
                self._delete_locked((kind, namespace, name), events)
                self._pending_events.extend(events)
        finally:
            self._end_write()
            self._drain_events()  # see create(): drain even on rejection

    def _delete_locked(self, key: Key, events: list[WatchEvent]) -> None:
        obj = self._objects.get(key)
        if obj is None:
            return
        if self._journal is not None:
            self._journal("delete", obj)
        self._objects.pop(key)
        self._by_kind.get(key[0], {}).pop(key, None)
        self._unindex_labels(key, obj)
        self._unindex_owners(key, obj)
        self._unindex_node(key, obj)
        self._fingerprints.pop(key, None)
        self._bump_kind(key[0])
        # Cascade: anything whose controller owner is this object (same
        # namespace, as before — cross-namespace ownership is not a thing).
        dependents = [
            k
            for k in sorted(self._owner_index.get(obj.meta.uid, ()))
            if k[1] == key[1]
        ]
        for dep_key in dependents:
            self._delete_locked(dep_key, events)
        events.append(WatchEvent("DELETED", _clone(obj)))

    # ---- helpers -----------------------------------------------------------
    @staticmethod
    def _spec_changed(old: TypedObject, new: TypedObject) -> bool:
        old_spec = to_plain(getattr(old, "spec", None))
        new_spec = to_plain(getattr(new, "spec", None))
        if old_spec != new_spec:
            return True
        return (
            to_plain(old.meta.labels) != to_plain(new.meta.labels)
            or to_plain(old.meta.annotations) != to_plain(new.meta.annotations)
        )

    def _admit(self, obj: TypedObject, old: Optional[TypedObject]) -> None:
        for fn in self._mutators.get(obj.kind, []):
            fn(obj, old)
        for fn in self._validators.get(obj.kind, []):
            fn(obj, old)

    def _drain_events(self) -> None:
        """Deliver queued watch events in commit order. Whichever thread gets
        the dispatch lock drains everything pending (possibly including events
        committed by other threads — they will find an empty queue and
        return), so delivery order always equals commit order.

        Nested calls — a write issued from inside an admission hook (store
        lock held) or from inside a watcher (dispatch lock held) — return
        immediately: their events are already queued and the outermost
        drain/write delivers them after the current event finishes, so every
        watcher sees the triggering event before its consequences."""
        if getattr(self._tls, "write_depth", 0) > 0 or getattr(self._tls, "draining", False):
            return
        self._tls.draining = True
        try:
            while True:
                with self._dispatch_lock:
                    with self._lock:
                        if not self._pending_events:
                            return
                        event = self._pending_events.popleft()
                    for fn in list(self._watchers):
                        fn(event)
        finally:
            self._tls.draining = False

    # ---- server-side apply -------------------------------------------------
    def apply(
        self,
        kind: str,
        namespace: str,
        name: str,
        fields: dict,
        field_manager: str,
        force: bool = False,
    ) -> TypedObject:
        """Server-side apply (≈ client.Patch(client.Apply) with a
        fieldManager, ref leaderworkerset_controller.go:375-411): merge the
        partial plain tree `fields` (to_plain shape — {"spec": {...},
        "meta": {"labels": {...}}}) into the stored object, claiming
        ownership of exactly the leaf paths it sets.

        Semantics:
          * a leaf owned by ANOTHER manager raises FieldManagerConflict
            unless force=True (then ownership transfers — the reference's
            controller pattern);
          * a leaf this manager owned before but no longer sets is REMOVED
            from the object (k8s SSA unset-is-delete), unless some other
            manager also owns it;
          * dicts merge recursively; scalars and LISTS are atomic leaves
            (no associative-list merge keys — the repo's API lists are
            templates/containers where replace is the useful semantic);
          * the object is created when absent; admission/validation,
            generation, WAL and watch events all ride the normal
            create/update path;
          * a no-op apply (merged tree and ownership both unchanged)
            commits nothing — reconcilers can apply every pass without
            churning watches.

        Concurrency: optimistic retry on resource_version, like every
        controller write."""
        from lws_tpu_torch.core.serialize import _registry, from_plain

        cls = _registry().get(kind)
        if cls is None:
            raise ValueError(f"unknown kind {kind!r}")
        new_paths = set(_flatten_leaf_paths(fields))
        for _ in range(32):
            current = self.try_get(kind, namespace, name)
            if current is None:
                base = {"meta": {"name": name, "namespace": namespace}}
                mf: dict[str, set[tuple]] = {}
            else:
                base = to_plain(current)
                mf = {m: {tuple(p) for p in ps}
                      for m, ps in current.meta.managed_fields.items()}
            base.pop("kind", None)

            # Steady-state fast path (the reconcile hot loop): when this
            # manager already owns exactly these paths and every applied
            # value equals the stored one, nothing can change — skip the
            # clone/merge/decode entirely. (Overlapping ownership between
            # managers can't exist: conflicts transfer it atomically.)
            if (current is not None
                    and mf.get(field_manager, set()) == new_paths
                    and _overlay_matches(base, fields)):
                return current

            # A new leaf conflicts with another manager's leaf when the
            # paths are equal OR one is an ancestor of the other: applying a
            # scalar/None over a dict subtree replaces every owned leaf
            # beneath it, and applying a dict under someone's scalar leaf
            # replaces that leaf — shape mismatches must not bypass
            # ownership.
            def overlaps(a: tuple, b: tuple) -> bool:
                n = min(len(a), len(b))
                return a[:n] == b[:n]

            conflicts = [
                (path, owner)
                for path in sorted(new_paths)
                for owner, owned in mf.items()
                if owner != field_manager and any(overlaps(path, q) for q in owned)
            ]
            if conflicts:
                if not force:
                    raise FieldManagerConflict(conflicts)
                for path, owner in conflicts:
                    if owner in mf:
                        mf[owner] = {q for q in mf[owner] if not overlaps(path, q)}
                        if not mf[owner]:
                            del mf[owner]

            # Unset-is-delete for paths this manager previously owned alone —
            # but never an ANCESTOR of a newly-set path (removing it would
            # delete the value just applied: {} -> {"app": "x"} refines the
            # old leaf, it doesn't abandon it).
            abandoned = {
                p for p in mf.get(field_manager, set()) - new_paths
                if not any(p == q[: len(p)] for q in new_paths)
            }
            # _deep_merge shallow-copies, so untouched branches would alias
            # `base` — clone first so the removals/ownership writes below
            # can't leak into the no-op comparison baseline.
            merged = _deep_merge(_clone(base), fields)
            for path in abandoned:
                if any(path in ps for m, ps in mf.items() if m != field_manager):
                    continue
                _remove_path(merged, path)
            if new_paths:
                mf[field_manager] = set(new_paths)
            else:
                mf.pop(field_manager, None)
            merged.setdefault("meta", {})["managed_fields"] = {
                m: sorted(list(p) for p in ps) for m, ps in sorted(mf.items())
            }

            if current is not None and merged == base:
                # Steady-state reconcile fast path: byte-identical plain
                # trees need no decode/canonicalize round trip at all.
                return current

            obj = from_plain(cls, merged)
            obj.kind = kind
            # Nulls where the schema declares containers would commit and
            # then crash the indexers mid-write — reject before anything
            # becomes visible (maps to HTTP 400).
            _reject_null_containers(obj)
            # No-op detection AFTER re-decoding: the partial overlay may
            # abbreviate sub-objects (defaults omitted) that canonicalize
            # to the stored form.
            if current is not None and to_plain(obj) == to_plain(current):
                return current  # no rv bump, no event
            try:
                if current is None:
                    return self.create(obj)
                obj.meta.resource_version = current.meta.resource_version
                obj.meta.uid = current.meta.uid
                return self.update(obj)
            except (ConflictError, AlreadyExistsError, NotFoundError):
                # Raced another writer — or a cascade DELETED the object
                # between read and write (the LWS-teardown race): re-read
                # and re-merge; the create branch handles the latter.
                continue
        raise ConflictError(f"apply of {kind}/{namespace}/{name} kept racing")

    # ---- convenience -------------------------------------------------------
    def owned_by(self, kind: str, namespace: str, owner_uid: str) -> list[TypedObject]:
        with self._lock:
            out = [
                _clone(self._objects[k])
                for k in self._owner_index.get(owner_uid, ())
                if k[0] == kind and k[1] == namespace and k in self._objects
            ]
        out.sort(key=lambda o: (o.meta.namespace, o.meta.name))
        return out

    def bound_to_node(self, node_name: str) -> list[TypedObject]:
        """Objects whose spec.node_name binds them to `node_name` (pods, in
        practice), via the node binding index. Node drain/eviction used to
        scan-and-filter the whole Pod fleet per NotReady node — O(fleet)
        reconcile work for an O(pods-per-node) answer."""
        with self._lock:
            out = [
                _clone(self._objects[k])
                for k in self._node_index.get(node_name, ())
                if k in self._objects
            ]
        out.sort(key=lambda o: (o.meta.namespace, o.meta.name))
        return out

    def owned_by_shared(self, kind: str, namespace: str, owner_uid: str) -> list[TypedObject]:
        """owned_by without the per-call deep clone — list_shared's contract
        (READ-ONLY aliases of the stored objects; writes go through
        get()+update()). The leader groupset's reconcile clones O(replicas)
        leader pods per call through owned_by, which was the top rollout
        cost at 256 groups (CONTROL_r04). Same debug guard as list_shared."""
        with self._lock:
            keys = [
                k
                for k in self._owner_index.get(owner_uid, ())
                if k[0] == kind and k[1] == namespace and k in self._objects
            ]
            self._verify_fingerprints_locked(keys)
            out = [self._objects[k] for k in keys]
        out.sort(key=lambda o: (o.meta.namespace, o.meta.name))
        return out


def owner_ref(obj: TypedObject) -> "OwnerReference":
    from lws_tpu_torch.api.meta import OwnerReference

    return OwnerReference(kind=obj.kind, name=obj.meta.name, uid=obj.meta.uid, controller=True)


def new_meta(
    name: str,
    namespace: str = "default",
    labels: Optional[dict[str, str]] = None,
    annotations: Optional[dict[str, str]] = None,
    owners: Iterable[TypedObject] = (),
) -> ObjectMeta:
    return ObjectMeta(
        name=name,
        namespace=namespace,
        labels=dict(labels or {}),
        annotations=dict(annotations or {}),
        owner_references=[owner_ref(o) for o in owners],
    )
