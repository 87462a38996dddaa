"""Write-ahead log + state directory: durable, HA-capable store persistence.

The reference delegates durability and HA to etcd behind the apiserver
(SURVEY §5 checkpoint/resume; ref cmd/main.go:186 leader election assumes
shared storage). This module is the native equivalent for a self-hosted
control plane:

  <state-dir>/
    state.json   last COMPLETED snapshot (atomic tmp+fsync+rename)
    wal.jsonl    one fsync'd JSON line per committed store write since then
    lock         flock(2)-guarded writer lock

Durability contract: every *acknowledged* write (a Store.create/update/delete
call that returned) was journaled and fsync'd first — a crash at any instant
loses nothing acknowledged. Recovery = load snapshot, replay WAL; a torn
final line (crash mid-append) is discarded, matching "the write was never
acknowledged".

HA contract: the lock file is held with flock LOCK_EX for the life of the
active process. The kernel releases it on ANY process death — including
kill -9 — so a standby blocked in acquire() takes over immediately, replays
snapshot+WAL, and resumes with zero lost acknowledged writes. flock is
mandatory arbitration: two actives are impossible on one host/filesystem.
(Cross-host HA needs a shared filesystem with sane flock semantics, or an
external arbiter; same boundary etcd draws for the reference.)

Compaction: when the WAL exceeds record/byte thresholds the next append
writes a fresh snapshot and resets the journal (snapshot is made durable
BEFORE the truncate, so there is no window where neither holds the state).

The port's copy of lws_tpu/core/wal.py.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
from typing import Optional

from lws_tpu_torch.api.meta import to_plain
from lws_tpu_torch.core.serialize import (
    CorruptSnapshotError,
    _registry,
    _revision_data_from_plain,
    from_plain,
    load_store,
    save_store,
)

SNAPSHOT_FILE = "state.json"
WAL_FILE = "wal.jsonl"
LOCK_FILE = "lock"


class StateLockedError(RuntimeError):
    """Another process holds the state directory's writer lock."""


class CorruptWalError(ValueError):
    """A non-final WAL record failed to parse: real corruption, not a torn
    tail. Refuse a partial replay."""


def replay_wal(path: str) -> list[dict]:
    """Read all complete records; a torn FINAL line (crash mid-append) is
    dropped — that write was never acknowledged. A bad non-final line raises."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        raw_lines = f.read().split(b"\n")
    records = []
    for i, line in enumerate(raw_lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError as e:
            if all(not later.strip() for later in raw_lines[i + 1:]):
                break  # torn tail: unacknowledged, discard
            raise CorruptWalError(
                f"{path}: record {i + 1} is corrupt mid-journal ({e}); "
                "refusing a partial replay"
            ) from e
    return records


def _apply_record(store, record: dict, registry: dict) -> int:
    """Apply one journal record verbatim; returns its resource_version."""
    kind = record["kind"]
    if record["op"] == "delete":
        store._forget_object((kind, record["namespace"], record["name"]))
        return record.get("rv", 0)
    plain = dict(record["obj"])
    if kind == "ControllerRevision" and "data" in plain:
        plain["data"] = _revision_data_from_plain(plain["data"])
    obj = from_plain(registry[kind], plain)
    store._restore_object(obj)
    return obj.meta.resource_version


class StateDir:
    """Owns a state directory: lock acquisition, restore, journaling,
    compaction. One instance per control-plane process."""

    def __init__(
        self,
        path: str,
        fsync: bool = True,
        compact_records: int = 50_000,
        compact_bytes: int = 64 << 20,
    ) -> None:
        self.path = path
        self.fsync = fsync
        self.compact_records = compact_records
        self.compact_bytes = compact_bytes
        self._lock_fd: Optional[int] = None
        self._wal_f = None
        self._wal_records = 0
        self._wal_bytes = 0
        self._store = None
        self._mutex = threading.Lock()
        os.makedirs(path, exist_ok=True)

    # -- paths -------------------------------------------------------------
    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.path, SNAPSHOT_FILE)

    @property
    def wal_path(self) -> str:
        return os.path.join(self.path, WAL_FILE)

    @property
    def lock_path(self) -> str:
        return os.path.join(self.path, LOCK_FILE)

    # -- arbitration -------------------------------------------------------
    def acquire(self, wait: bool = False) -> None:
        """Take the exclusive writer lock. wait=True blocks (standby mode:
        returns only when the active process dies or releases); wait=False
        raises StateLockedError if held."""
        if self._lock_fd is not None:
            return
        fd = os.open(self.lock_path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            flags = fcntl.LOCK_EX if wait else fcntl.LOCK_EX | fcntl.LOCK_NB
            fcntl.flock(fd, flags)
        except BlockingIOError:
            os.close(fd)
            raise StateLockedError(
                f"state dir {self.path} is locked by another process "
                "(run with standby/wait mode to take over on its death)"
            ) from None
        except BaseException:
            os.close(fd)
            raise
        os.write(fd, f"{os.getpid()}\n".encode())
        self._lock_fd = fd

    def locked_by_other(self) -> bool:
        """Probe the writer lock. Returns False when THIS process holds it
        (Linux flock denies a second fd of the same file even within the
        holding process, which would misreport self as 'other'). When free,
        the probe momentarily acquires and releases the lock — a brief
        write-side action inherent to flock probing."""
        if self._lock_fd is not None:
            return False
        fd = os.open(self.lock_path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            fcntl.flock(fd, fcntl.LOCK_UN)
            return False
        except BlockingIOError:
            return True
        finally:
            os.close(fd)

    # -- restore + journal -------------------------------------------------
    def attach(self, store) -> int:
        """Restore snapshot+WAL into `store` (must be empty), compact so the
        journal starts fresh, and begin journaling every subsequent write.
        Returns the number of objects restored. Requires acquire() first."""
        if self._lock_fd is None:
            raise RuntimeError("acquire() the state dir before attach()")
        registry = _registry()
        if os.path.exists(self.snapshot_path):
            load_store(store, self.snapshot_path)
        max_rv = 0
        with store._lock:
            for record in replay_wal(self.wal_path):
                max_rv = max(max_rv, _apply_record(store, record, registry))
            if max_rv:
                import itertools

                # load_store already advanced _rv past the snapshot; the WAL
                # may reach further.
                current = next(store._rv)
                store._rv = itertools.count(max(current, max_rv + 1))
        self._store = store
        # Fold the replayed WAL into a fresh snapshot so recovery stays O(new
        # writes), then hook the journal in (under the store lock so no write
        # lands between compaction and hook-up).
        with store._lock:
            count = len(store._objects)
            self._compact_locked()
            store._journal = self._journal_write
        return count

    def _journal_write(self, op: str, obj) -> None:
        """Store journal hook: runs under the store lock, before the write
        becomes visible. Raising here fails the write un-acknowledged."""
        if op == "delete":
            record = {
                "op": op,
                "kind": obj.kind,
                "namespace": obj.meta.namespace,
                "name": obj.meta.name,
                "rv": obj.meta.resource_version,
            }
        else:
            record = {"op": op, "kind": obj.kind, "obj": to_plain(obj)}
        line = (json.dumps(record) + "\n").encode()
        with self._mutex:
            if self._wal_f is None:
                self._wal_f = open(self.wal_path, "ab")  # vet: ignore[lock-held-blocking]: WAL appends must serialize under _mutex — the durable write IS the critical section
            self._wal_f.write(line)
            self._wal_f.flush()
            if self.fsync:
                os.fsync(self._wal_f.fileno())
            self._wal_records += 1
            self._wal_bytes += len(line)
            if (
                self._wal_records >= self.compact_records
                or self._wal_bytes >= self.compact_bytes
            ):
                # Store lock is held (journal hook); safe to snapshot. The
                # in-flight write is NOT yet in the store maps, but its WAL
                # record precedes the truncate only logically — it re-lands in
                # the fresh journal below, keeping snapshot+WAL complete.
                self._compact_locked(pending=line)  # vet: ignore[lock-held-blocking]: snapshot+truncate must be atomic vs concurrent appends — compaction I/O belongs under _mutex

    def _compact_locked(self, pending: bytes = b"") -> None:
        """Write a durable snapshot, then reset the journal (in that order:
        both files always jointly cover every acknowledged write). `pending`
        is the record of a write journaled but not yet applied to the store
        maps — it must survive into the fresh WAL."""
        save_store(self._store, self.snapshot_path)  # tmp+fsync+rename
        if self._wal_f is not None:
            self._wal_f.close()
        self._wal_f = open(self.wal_path, "wb")
        if pending:
            self._wal_f.write(pending)
            self._wal_f.flush()
            if self.fsync:
                os.fsync(self._wal_f.fileno())
        self._wal_records = 1 if pending else 0
        self._wal_bytes = len(pending)

    def compact(self) -> None:
        """Manual compaction (also runs automatically at thresholds)."""
        if self._store is None:
            raise RuntimeError("attach() a store first")
        with self._store._lock, self._mutex:
            self._compact_locked()  # vet: ignore[lock-held-blocking]: manual compaction — same atomic snapshot+truncate contract as the journal hook

    def close(self, final_snapshot: bool = True) -> None:
        """Clean shutdown: optional final compaction, detach, release lock."""
        if self._store is not None:
            with self._store._lock:
                self._store._journal = None
                if final_snapshot:
                    with self._mutex:
                        self._compact_locked()  # vet: ignore[lock-held-blocking]: shutdown snapshot — single-threaded teardown, atomicity still required
            self._store = None
        with self._mutex:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None
        if self._lock_fd is not None:
            os.close(self._lock_fd)  # closing releases the flock
            self._lock_fd = None


__all__ = [
    "StateDir",
    "StateLockedError",
    "CorruptWalError",
    "CorruptSnapshotError",
    "replay_wal",
]
