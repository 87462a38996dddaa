"""Host-RAM spill tier for the paged engine's prefix cache: the port of
lws_tpu/serving/kv_host_arena.py (KVHostArena, from_env, the spilled-block
registry, the occupancy gauges, the spill byte counter, the
`arena_restore` pool provider, and the process prefix registry: engines
register a snapshot provider (weakly: a dead engine falls out), workers
register their KV fetch port, and `debug_prefixes()` merges both into the
digest advertisement a fleet prefix index folds in (the body the JAX
package's telemetry server serves at /debug/prefixes).

When the paged engine evicts an LRU-parked prefix block, it spills the
block's K/V into a bounded host arena, one blob in the KV wire's
`pack_payload` format per content digest; a later prefix-map miss that
hits the arena uploads the block instead of recomputing it (a host-tier
hit). Capacity is `LWS_TPU_KV_HOST_ARENA_MB` (0 or unset: no tier). The
arena is LRU within itself: `get` refreshes an entry, `put` evicts from the
cold end until the new entry fits, and an entry larger than the whole arena
is dropped and counted. `get` returns zero-copy views into the stored blob,
so the blocks a sibling fetches (`get_spilled`, the KVServer's
`fetch_prefix` provider) leave as they were spilled.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Callable, Optional

from lws_tpu_torch.core import metrics
from lws_tpu_torch.obs import device
from lws_tpu_torch.serving.kv_transport import bytes_to_arrays, pack_payload

ARENA_MB_ENV = "LWS_TPU_KV_HOST_ARENA_MB"

_REG_LOCK = threading.Lock()
_ARENAS: list = []  # weakrefs to every live KVHostArena; guarded-by: _REG_LOCK
# name -> snapshot provider; a provider returns {"block_size", "digests":
# [bytes...], "arena_digests": [bytes...]}, or None once its engine died.
_PREFIX_SOURCES: dict[str, Callable[[], Optional[dict]]] = {}  # guarded-by: _REG_LOCK
_FETCH_PORT: Optional[int] = None  # guarded-by: _REG_LOCK


class KVHostArena:
    """Bounded digest-addressed host store of spilled prefix blocks."""

    def __init__(self, capacity_bytes: int) -> None:
        if capacity_bytes <= 0:
            raise ValueError("arena capacity must be > 0 bytes")
        self.capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        # digest -> packed payload; dict order IS the LRU order (oldest first).
        self._entries: dict[bytes, bytes] = {}  # guarded-by: _lock
        self._bytes = 0                         # guarded-by: _lock
        self.drops = 0                          # guarded-by: _lock
        self._publish_gauges(0, 0)
        with _REG_LOCK:
            _ARENAS.append(weakref.ref(self))

    @staticmethod
    def _publish_gauges(nbytes: int, entries: int) -> None:
        metrics.set("serving_kv_host_arena_bytes", float(nbytes))
        metrics.set("serving_kv_host_arena_entries", float(entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def put(self, digest: bytes, arrays: dict) -> bool:
        """Spill one block's arrays under `digest` (the join is the spill's
        one host copy). False when the entry alone exceeds the arena: it is
        dropped, and the caller's eviction proceeds as without a tier."""
        bufs, _ = pack_payload(arrays)
        payload = b"".join(bufs)
        size = len(payload)
        with self._lock:
            if size > self.capacity:
                self.drops += 1
                return False
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= len(old)
            while self._bytes + size > self.capacity and self._entries:
                cold = next(iter(self._entries))
                self._bytes -= len(self._entries.pop(cold))
            self._entries[digest] = payload
            self._bytes += size
            nbytes, entries = self._bytes, len(self._entries)
        metrics.inc("serving_kv_spill_bytes_total", {"direction": "spill"}, value=float(size))
        self._publish_gauges(nbytes, entries)
        return True

    def get(self, digest: bytes) -> Optional[dict]:
        """Zero-copy array views of a spilled block (None on a miss); a hit
        refreshes the entry's LRU position."""
        with self._lock:
            payload = self._entries.pop(digest, None)
            if payload is None:
                return None
            self._entries[digest] = payload  # re-insert at the hot end
        return bytes_to_arrays(payload)

    def __contains__(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._entries

    def digests(self) -> list[bytes]:
        """Cold-to-hot digest list (a snapshot)."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "capacity": self.capacity, "drops": self.drops}


def from_env() -> Optional[KVHostArena]:
    """An arena of LWS_TPU_KV_HOST_ARENA_MB megabytes; None when unset or 0
    (the spill tier is opt-in)."""
    raw = os.environ.get(ARENA_MB_ENV, "").strip()
    if not raw:
        return None
    mb = float(raw)
    if mb <= 0:
        return None
    return KVHostArena(int(mb * 1e6))


def get_spilled(digest: bytes) -> Optional[dict]:
    """`fetch_prefix` provider: zero-copy views of the first live arena's
    entry for `digest`, None when no arena holds it. Spilled blocks are
    host-resident wire-format bytes already, so serving a sibling costs no
    device traffic and no engine coordination."""
    with _REG_LOCK:
        live = [r() for r in _ARENAS]
        _ARENAS[:] = [r for r, a in zip(list(_ARENAS), live) if a is not None]
    for arena in live:
        if arena is not None:
            got = arena.get(digest)
            if got is not None:
                return got
    return None


def arena_pool_bytes() -> float:
    """Total bytes across every live arena: the `arena_restore` pool feed
    for serving_hbm_pool_bytes (host-resident, so the device-memory refresh
    reports it without subtracting it from device in-use)."""
    with _REG_LOCK:
        live = [r() for r in _ARENAS]
        _ARENAS[:] = [r for r, a in zip(list(_ARENAS), live) if a is not None]
    return float(sum(a.nbytes for a in live if a is not None))


# Registered once at import: the pool reads 0 until an arena exists.
device.register_pool_provider("arena_restore", arena_pool_bytes)


def register_prefix_source(name: str, provider: Callable[[], Optional[dict]]) -> None:
    with _REG_LOCK:
        _PREFIX_SOURCES[name] = provider


def unregister_prefix_source(name: str) -> None:
    with _REG_LOCK:
        _PREFIX_SOURCES.pop(name, None)


def register_fetch_port(port: Optional[int]) -> None:
    """Advertise the KV wire port siblings should `fetch_prefix` against
    (the worker's KVServer port). None clears it."""
    global _FETCH_PORT
    with _REG_LOCK:
        _FETCH_PORT = int(port) if port is not None else None


def debug_prefixes(limit: int = 256) -> dict:
    """The prefix advertisement: every live source's resident (device) and
    arena digests as hex, capped at `limit` each, plus the advertised KV
    fetch port. Dead sources (provider returned None) are pruned."""
    with _REG_LOCK:
        sources = list(_PREFIX_SOURCES.items())
        port = _FETCH_PORT
    digests: list[str] = []
    arena: list[str] = []
    dead: list[str] = []
    for name, provider in sources:
        snap = provider()
        if snap is None:
            dead.append(name)
            continue
        digests.extend(d.hex() for d in snap.get("digests", []))
        arena.extend(d.hex() for d in snap.get("arena_digests", []))
    for name in dead:
        unregister_prefix_source(name)
    if limit:
        digests, arena = digests[:limit], arena[:limit]
    return {"digests": digests, "arena_digests": arena,
            "count": len(digests) + len(arena), "kv_port": port}
