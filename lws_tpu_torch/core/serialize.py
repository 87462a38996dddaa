"""Store persistence: snapshot/restore of the whole object graph
(≈ etcd durability for the reference's state — SURVEY §5: "all state lives in
the API server"; here it can live in a JSON file so `serve --state-file`
survives process restarts and resumes rollouts mid-flight).

Uses a generic dataclass<->plain codec driven by type hints; enums, nested
dataclasses, Optionals, lists, dicts, and int-or-percent unions round-trip.

The port's copy of lws_tpu/core/serialize.py.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Optional, Union, get_args, get_origin, get_type_hints

from lws_tpu_torch.api.meta import to_plain


def _registry() -> dict[str, type]:
    from lws_tpu_torch.api.autoscaler import Autoscaler
    from lws_tpu_torch.api.lease import Lease
    from lws_tpu_torch.api.disagg import DisaggregatedSet
    from lws_tpu_torch.api.groupset import GroupSet
    from lws_tpu_torch.api.node import Node
    from lws_tpu_torch.api.pod import Pod
    from lws_tpu_torch.api.podgroup import PodGroup
    from lws_tpu_torch.api.pvc import PersistentVolumeClaim
    from lws_tpu_torch.api.revision import ControllerRevision
    from lws_tpu_torch.api.service import Service
    from lws_tpu_torch.api.types import LeaderWorkerSet

    return {
        cls.kind: cls
        for cls in (
            LeaderWorkerSet, DisaggregatedSet, Pod, GroupSet, Service, Node,
            PodGroup, PersistentVolumeClaim, ControllerRevision, Autoscaler,
            Lease,
        )
    }


def from_plain(cls: Any, data: Any) -> Any:
    """Inverse of api.meta.to_plain for type-annotated dataclasses."""
    if data is None:
        return None
    origin = get_origin(cls)
    if origin is Union:  # Optional[X] / IntOrPercent
        args = [a for a in get_args(cls) if a is not type(None)]
        if len(args) == 1:
            return from_plain(args[0], data)
        return data  # e.g. int | str — already plain
    if cls is Any:
        return data
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return cls(data)
    if dataclasses.is_dataclass(cls):
        hints = get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kwargs[f.name] = from_plain(hints[f.name], data[f.name])
        return cls(**kwargs)
    if origin in (list, tuple):
        (item_type,) = get_args(cls)[:1] or (Any,)
        out = [from_plain(item_type, v) for v in data]
        return tuple(out) if origin is tuple else out
    if origin is dict:
        args = get_args(cls)
        val_type = args[1] if len(args) == 2 else Any
        return {k: from_plain(val_type, v) for k, v in data.items()}
    return data


def _revision_data_from_plain(data: dict) -> dict:
    """ControllerRevision.data is typed Any but holds known snapshot fields."""
    from lws_tpu_torch.api.types import LeaderWorkerTemplate, NetworkConfig

    out = dict(data)
    if "leader_worker_template" in out:
        out["leader_worker_template"] = from_plain(
            LeaderWorkerTemplate, out["leader_worker_template"]
        )
    if "network_config" in out:
        out["network_config"] = from_plain(Optional[NetworkConfig], out["network_config"])
    return out


def snapshot_store(store) -> dict:
    out: dict[str, list] = {}
    # One lock span for the WHOLE graph: a torn snapshot (pods without their
    # owning groupset) would restore as permanent orphans. The store lock is
    # re-entrant, so the per-kind list() calls nest fine.
    with store._lock:
        for kind in _registry():
            objs = store.list(kind)
            # Nodes live in the cluster pseudo-namespace; store.list(kind)
            # already spans namespaces.
            if objs:
                out[kind] = [to_plain(o) | {"kind": kind} for o in objs]
    return out


def restore_store(store, snapshot: dict) -> int:
    """Load objects verbatim (uids/resourceVersions preserved) into an empty
    store; returns the object count. Admission is NOT re-run — the snapshot is
    already-admitted state, exactly like an apiserver restart."""
    registry = _registry()
    count = 0
    max_rv = 0
    with store._lock:
        for kind, objs in snapshot.items():
            cls = registry[kind]
            for plain in objs:
                plain = dict(plain)
                plain.pop("kind", None)
                if kind == "ControllerRevision" and "data" in plain:
                    plain["data"] = _revision_data_from_plain(plain["data"])
                obj = from_plain(cls, plain)
                store._restore_object(obj)
                max_rv = max(max_rv, obj.meta.resource_version)
                count += 1
        # Resume the version counter past everything restored.
        import itertools

        store._rv = itertools.count(max_rv + 1)
    return count


def save_store(store, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot_store(store), f)
        f.flush()
        os.fsync(f.fileno())  # durable before the rename makes it visible
    os.replace(tmp, path)
    # fsync the directory so the rename itself is durable BEFORE callers
    # (StateDir._compact_locked) truncate the WAL — otherwise power loss can
    # persist the truncate without the rename, losing acknowledged writes.
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


class CorruptSnapshotError(ValueError):
    """The state file exists but is not parseable — a torn write from a crash
    that predates the atomic tmp+rename+fsync protocol, or disk corruption."""


def load_store(store, path: str) -> int:
    """Restore from `path`. A leftover `.tmp` (crash mid-snapshot — exactly
    the TPU-preemption window KEP-820 worries about) is discarded: the main
    file is the last COMPLETED snapshot and rename-atomicity guarantees it is
    whole. A corrupt main file raises CorruptSnapshotError rather than
    half-restoring."""
    with open(path) as f:
        try:
            snapshot = json.load(f)
        except ValueError as e:
            # Keep any .tmp around here: if the main file is corrupt it may
            # be the only near-complete local copy left to recover from.
            raise CorruptSnapshotError(
                f"state file {path} is not valid JSON ({e}); refusing a "
                "partial restore — recover from a replica, inspect "
                f"{path + '.tmp'} if present, or delete the file to start "
                "empty"
            ) from e
    count = restore_store(store, snapshot)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        os.unlink(tmp)  # torn partial snapshot: the restored main supersedes it
    return count
