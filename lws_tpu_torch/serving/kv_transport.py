"""KV-cache handoff transport: the port of lws_tpu/serving/kv_transport.py.

The wire is the JAX package's, byte for byte, so a port worker and a JAX
worker hand off to each other: frame = !II (header_len, payload_len) +
JSON header + raw payload; payload = !I(spec_len) + spec_json + buffers,
spec_json = {"arrays": [{"name", "dtype", "shape"}, ...]}; one request per
connection; streamed replies as BEGIN / CHUNK (acked) / END with a running
crc32. The server (`KVServer`) queues prompts in, bundles out and results,
and serves cached prefix blocks (`fetch_prefix`); the client helpers
(`submit_prompt`, `pull_bundle`, `pull_result`, `fetch_prefix`,
`RemotePrefixSource`, `discover_role_endpoint`) bind to the caller's
`resilience.Deadline`.

Telemetry and faults are the JAX wire's, at the same moments:
`serving_kv_transfer_bytes_total{role}` and `serving_kv_transfer_seconds
{role}` per delivery (role prefill: a bundle or stream sent; decode: one
received; prefix: a sibling prefix leg), `serving_kv_copy_bytes_total{site}`
for the one join `arrays_to_bytes` costs, `serving_kv_stream_inflight_chunks`
(chunks produced and not yet acked, over the process's live streams) and
`serving_kv_connection_errors_total` for a connection that died on the
server; `kv_requeue` and `kv_stream_torn` flight-recorder events. The fault
points are `kv.server.recv`, `kv.server.send_bundle` (partial_write, pace),
`kv.server.send_result` (partial_write), `kv.stream.send_chunk`
(partial_write, pace), `kv.client.connect`, `kv.client.recv`,
`kv.stream.recv_chunk` (drop, partial_write), `kv.ack` (drop) and
`kv.prefix.fetch`; the cooperative modes in brackets are honored where they
fire (core/faults.py:COOPERATIVE_POINTS).

bf16 on the wire. The spec names bf16 arrays "bfloat16", as JAX's
ml_dtypes type does. The port never relies on ml_dtypes for that: a
`torch.bfloat16` tensor, or uint16 bits viewed as `BF16` (`host_array`
makes them), go out as their uint16 bytes under the name "bfloat16", and a
received "bfloat16" array is a uint16 view with the `BF16` dtype, which the
device seams turn into torch.bfloat16 with `.view(torch.bfloat16)`. The
bytes on the wire therefore do not depend on whether ml_dtypes is
installed.

Device seams (`cache_arrays`, `cache_to_bundle`, `bundle_to_cache`,
`CacheAssembler`) move K/V between the port's `KVCache` (torch tensors on
the engine's device, host-int `pos`) and the wire's host arrays. Under a
tensor-parallel mesh a rank's cache holds only its Hkv/tp KV heads: the
bundle side gathers the heads over the tp group first (every rank calls it,
tp rank 0 gets the bytes), and the decode side scatters them by head from
tp rank 0 (every rank places only its own). The bundle is the single-device
engine's either way.
"""

from __future__ import annotations

import hmac
import json
import os
import queue
import socket
import struct
import threading
import time
import zlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
# The DisaggregatedSet's label keys, which endpoint discovery matches
# services by.
from lws_tpu_torch.api.disagg import (  # noqa: F401
    DS_NAME_LABEL_KEY,
    DS_REVISION_LABEL_KEY,
    DS_ROLE_LABEL_KEY,
    DS_SLICE_LABEL_KEY,
)
from lws_tpu_torch.core import faults, flightrecorder, metrics, resilience
from lws_tpu_torch.models.llama import KVCache
from lws_tpu_torch.obs import device as devicemod

_FRAME = struct.Struct("!II")
_SPEC = struct.Struct("!I")

# Socket buffer floor: small ack frames must never sit behind Nagle, and
# MB-scale frames should not drain through default-sized kernel buffers.
_SOCK_BUF_FLOOR = 1 << 20

Payload = Union[bytes, bytearray, memoryview, Sequence]

# bf16 as its uint16 bits, tagged for the wire: pack_payload names an array
# of this dtype "bfloat16", and bytes_to_arrays returns "bfloat16" arrays in
# it. The tag survives views, reshapes and slices (not arithmetic).
BF16 = np.dtype(np.uint16, metadata={"wire": "bfloat16"})



def tune_socket(sock: socket.socket) -> None:
    """TCP_NODELAY + SO_SNDBUF/SO_RCVBUF floor on every KV-transport socket."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # non-TCP test doubles
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            if sock.getsockopt(socket.SOL_SOCKET, opt) < _SOCK_BUF_FLOOR:
                sock.setsockopt(socket.SOL_SOCKET, opt, _SOCK_BUF_FLOOR)
        except OSError:
            pass


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """n bytes read into one preallocated buffer (writable, so received
    arrays need no copy to become tensors); None when the peer closed."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


def _as_views(payload: Payload) -> list:
    """A payload (bytes | buffer | sequence of buffers) as a flat list of
    byte views, copying none of them."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return [memoryview(payload).cast("B")] if len(payload) else []
    return [v if isinstance(v, memoryview) else memoryview(v) for v in payload]


def _sendall_vectored(sock: socket.socket, views: list) -> None:
    """sendall over a scatter-gather buffer list: the frame header and every
    array buffer go to the kernel from where they live."""
    bufs = [v for v in views if v.nbytes]
    if not hasattr(sock, "sendmsg"):
        for v in bufs:
            sock.sendall(v)
        return
    while bufs:
        sent = sock.sendmsg(bufs)
        while bufs and sent >= bufs[0].nbytes:
            sent -= bufs[0].nbytes
            bufs.pop(0)
        if sent and bufs:
            bufs[0] = bufs[0][sent:]


def send_msg(sock: socket.socket, meta: dict, payload: Payload = b"") -> None:
    views = _as_views(payload)
    header = json.dumps(meta).encode()
    plen = sum(v.nbytes for v in views)
    frame = _FRAME.pack(len(header), plen) + header
    _sendall_vectored(sock, [memoryview(frame)] + views)


def _send_partial(sock: socket.socket, meta: dict, payload: Payload, nbytes: int) -> None:
    """The cooperative `partial_write` fault: ship only the first `nbytes`
    of the frame, leaving the peer a truncated read (the mid-frame death the
    re-queue and re-insert paths must survive)."""
    header = json.dumps(meta).encode()
    body = b"".join(bytes(v) for v in _as_views(payload))
    frame = _FRAME.pack(len(header), len(body)) + header + body
    sock.sendall(frame[: max(0, nbytes)])


def _pace_sleep(fault, nbytes: int) -> None:
    """The cooperative `pace:MBPS` fault: a link of MBPS megabytes a second,
    slept per frame by its byte count (fair per byte across monolithic and
    streamed deliveries)."""
    time.sleep(nbytes / (max(float(fault.arg), 1e-6) * 1e6))


def recv_msg(sock: socket.socket) -> tuple[Optional[dict], bytes]:
    raw = _recv_exact(sock, _FRAME.size)
    if raw is None:
        return None, b""
    return _recv_msg_body(sock, raw)


def _recv_msg_body(sock: socket.socket, raw) -> tuple[Optional[dict], bytes]:
    """Finish reading a frame whose !II prefix (`raw`) already arrived."""
    hlen, plen = _FRAME.unpack(raw)
    header = _recv_exact(sock, hlen)
    if header is None:
        return None, b""
    payload = _recv_exact(sock, plen) if plen else b""
    return json.loads(header), payload or b""


# ---------------------------------------------------------------------------
# Raw-buffer array packing


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of tensor `t` for the wire: bf16 as its uint16 bits in
    the BF16 dtype, any other dtype as numpy's own."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _wire_dtype(arr: np.ndarray) -> str:
    meta = arr.dtype.metadata
    return meta["wire"] if meta and "wire" in meta else arr.dtype.name


def _resolve_dtype(name: str) -> np.dtype:
    """The receive-side numpy dtype of a spec's dtype name: "bfloat16" is a
    BF16 (uint16) view, every other name numpy's own."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def is_bfloat16(arr: np.ndarray) -> bool:
    """A host array of bf16 values: BF16-tagged bits, or a numpy bf16 type
    named "bfloat16" (JAX's host arrays)."""
    return _wire_dtype(arr) == "bfloat16"


def pack_payload(arrays: dict) -> tuple[list, int]:
    """dict of arrays (numpy, or torch tensors: `host_array` copies them to
    the host) -> ([spec_header_bytes, raw buffer views...], payload nbytes).
    Each C-contiguous host array contributes its own buffer view."""
    spec = []
    views: list = []
    nbytes = 0
    for name, value in arrays.items():
        arr = host_array(value) if isinstance(value, torch.Tensor) else np.asarray(value)
        if not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)  # the one copy a sliced source costs
        spec.append({"name": name, "dtype": _wire_dtype(arr), "shape": list(arr.shape)})
        if arr.nbytes:
            # uint8 reinterpret, not memoryview.cast: a numpy bf16 type has
            # no buffer-protocol format code.
            view = memoryview(arr.reshape(-1).view(np.uint8))
            views.append(view)
            nbytes += view.nbytes
    head = json.dumps({"arrays": spec}).encode()
    return [_SPEC.pack(len(head)) + head] + views, nbytes


def arrays_to_bytes(**arrays) -> bytes:
    """Pack arrays into ONE contiguous payload: the convenience path for
    small payloads (prompts, token results, tests); the join is its one
    host copy, counted in `serving_kv_copy_bytes_total{site}`."""
    bufs, nbytes = pack_payload(arrays)
    if nbytes:
        metrics.inc("serving_kv_copy_bytes_total", {"site": "arrays_to_bytes"},
                    value=float(nbytes))
    return b"".join(bufs)


def bytes_to_arrays(data) -> dict:
    """Payload bytes -> dict of arrays, each an `np.frombuffer` view into
    `data` (read-only when `data` is bytes); "bfloat16" arrays in BF16."""
    view = memoryview(data)
    (hlen,) = _SPEC.unpack(view[: _SPEC.size])
    spec = json.loads(bytes(view[_SPEC.size: _SPEC.size + hlen]))
    off = _SPEC.size + hlen
    out = {}
    for entry in spec["arrays"]:
        dt = _resolve_dtype(entry["dtype"])
        shape = tuple(entry["shape"])
        count = 1
        for dim in shape:
            count *= int(dim)
        nbytes = count * dt.itemsize
        arr = np.frombuffer(view[off: off + nbytes], dtype=dt, count=count)
        out[entry["name"]] = arr.reshape(shape)
        off += nbytes
    return out


# ---------------------------------------------------------------------------
# Device seams: the port's KVCache <-> the wire's host arrays


def to_tensor(arr, device: torch.device) -> torch.Tensor:
    """A host array (as bytes_to_arrays or JAX gives it) as a tensor on
    `device`; bf16 arrays become torch.bfloat16 through their uint16 bits.
    The copy from pageable host memory is synchronous."""
    arr = np.asarray(arr)
    bf16 = is_bfloat16(arr)
    if bf16:
        arr = arr.view(np.int16)
    # torch.from_numpy wants writable, C-ordered memory (views into a
    # received bytearray are; JAX's and bytes-backed arrays may not be).
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


_KV_NAMES = ("k", "v", "k_scale", "v_scale")


def cache_arrays(cache: KVCache, token, mesh=None) -> Optional[dict]:
    """KVCache + first token [B] -> the wire array dict, cut to the cache's
    `pos` rows: the one place the bundle schema lives. k/v (and k_scale/
    v_scale for an int8 cache) are host copies of rows [0, pos); pos ships
    as a 0-d int32 array and token as [B] int32, as JAX ships them. Bundle
    bytes follow the prompt's length, not the prefill engine's max_len.

    Under `mesh` (the engine's tensor-parallel mesh) every rank calls it:
    the KV heads are gathered over the tp group, so the arrays are the
    single-device engine's, and tp rank 0 gets them (the other ranks None)."""
    p = int(cache.pos)
    rows = {n: getattr(cache, n)[:, :, :p] for n in _KV_NAMES if getattr(cache, n) is not None}
    if mesh is not None:
        from lws_tpu_torch.parallel.collectives import gather_heads

        rows = {n: gather_heads(t, mesh.tp_group, dim=3) for n, t in rows.items()}
        if mesh.tp_rank != 0:
            return None
    arrays = {
        "k": host_array(rows["k"]),
        "v": host_array(rows["v"]),
        "pos": np.asarray(p, np.int32),
        "token": np.asarray(token.cpu() if isinstance(token, torch.Tensor) else token,
                            np.int32),
    }
    if "k_scale" in rows:
        arrays.update(k_scale=host_array(rows["k_scale"]), v_scale=host_array(rows["v_scale"]))
    return arrays


def cache_to_bundle(cache: KVCache, token, mesh=None) -> Optional[bytes]:
    """KVCache + first token -> one monolithic wire bundle (under `mesh`,
    on tp rank 0; None on the other ranks, which take part in the gather)."""
    arrays = cache_arrays(cache, token, mesh)
    return None if arrays is None else arrays_to_bytes(**arrays)


def _check_rows(bundle: dict, max_len: Optional[int]) -> None:
    for name in _KV_NAMES:
        if name in bundle and max_len is not None and bundle[name].shape[2] > max_len:
            raise ValueError(
                f"bundle holds {bundle[name].shape[2]} KV rows but decode max_len={max_len}")


def _fit(t: torch.Tensor, max_len: Optional[int]) -> torch.Tensor:
    """Rows [L, B, T, ...] in a zeroed [L, B, max_len, ...] buffer."""
    if max_len is None or t.shape[2] == max_len:
        return t
    out = t.new_zeros((*t.shape[:2], max_len, *t.shape[3:]))
    out[:, :, :t.shape[2]] = t
    return out


def bundle_to_cache(data, max_len: Optional[int] = None, device: DeviceLike = None,
                    mesh=None) -> tuple[KVCache, torch.Tensor]:
    """Wire bundle (payload bytes, or an unpacked array dict such as a
    stream's HostAssembler gives) -> (KVCache on `device`, first token [B]
    int32). `max_len` is the DECODE side's budget: the wire's rows are
    copied into zeroed [L, B, max_len, ...] buffers with room to append, and
    a bundle of more rows raises ValueError. Omitted, the cache is exactly
    the wire length.

    Under `mesh` (the decode engine's) every rank calls it, tp rank 0 with
    the bundle and the others with None: rank 0 checks the bundle and
    broadcasts its array specs (or its refusal, which every rank then
    raises), then scatters each array by KV head, so every rank places only
    its Hkv/tp heads."""
    device = resolve_device(device)
    if mesh is not None:
        return _bundle_to_mesh(data, max_len, device, mesh)
    bundle = data if isinstance(data, dict) else bytes_to_arrays(data)
    _check_rows(bundle, max_len)
    cache = KVCache(
        k=_fit(to_tensor(bundle["k"], device), max_len),
        v=_fit(to_tensor(bundle["v"], device), max_len),
        pos=int(np.asarray(bundle["pos"])),
        k_scale=_fit(to_tensor(bundle["k_scale"], device), max_len) if "k_scale" in bundle
        else None,
        v_scale=_fit(to_tensor(bundle["v_scale"], device), max_len) if "v_scale" in bundle
        else None,
    )
    devicemod.record_transfer("kv.bundle_to_cache", sum(
        int(np.asarray(bundle[n]).nbytes) for n in _KV_NAMES if n in bundle))
    return cache, to_tensor(np.asarray(bundle["token"], np.int32), device)


def _bundle_to_mesh(data, max_len: Optional[int], device: torch.device, mesh
                    ) -> tuple[KVCache, torch.Tensor]:
    from lws_tpu_torch.parallel import collectives

    group, tp = mesh.tp_group, mesh.tp
    bundle, head = None, None
    if mesh.tp_rank == 0:
        try:
            bundle = data if isinstance(data, dict) else bytes_to_arrays(data)
            _check_rows(bundle, max_len)
            specs = {}
            for n in _KV_NAMES:
                if n in bundle:
                    arr = np.asarray(bundle[n])
                    if arr.shape[3] % tp:
                        raise ValueError(f"bundle {n} has {arr.shape[3]} KV heads, not "
                                         f"divisible by tp={tp}")
                    specs[n] = (list(arr.shape), _wire_dtype(arr))
            head = {"arrays": specs, "pos": int(np.asarray(bundle["pos"])),
                    "token": np.asarray(bundle["token"], np.int32)}
        except Exception as e:  # noqa: BLE001 — every rank raises the refusal
            head = {"error": str(e)}
            err = e
    head = collectives.broadcast_object(head, group)  # the decision before any scatter
    if "error" in head:
        if mesh.tp_rank == 0:
            raise err
        raise ValueError(head["error"])
    out = {}
    for n, (shape, dt) in head["arrays"].items():
        local = list(shape)
        local[3] //= tp
        full = to_tensor(bundle[n], device) if bundle is not None else None
        dtype = torch.bfloat16 if dt == "bfloat16" else \
            torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype
        out[n] = _fit(collectives.scatter_heads(full, local, dtype, device, group, dim=3),
                      max_len)
    if bundle is not None:
        devicemod.record_transfer("kv.bundle_to_cache", sum(
            int(np.asarray(bundle[n]).nbytes) for n in head["arrays"]))
    cache = KVCache(k=out["k"], v=out["v"], pos=head["pos"], k_scale=out.get("k_scale"),
                    v_scale=out.get("v_scale"))
    return cache, to_tensor(head["token"], device)


# ---------------------------------------------------------------------------
# Streamed handoff: server-side stream record + client-side assemblers

# Axis each per-position array chunks along ("tokens" is the [B, width]
# prompt slice a stream ships so decode can seed its drafting history).
_CHUNK_AXES = {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2, "tokens": 1}

# serving_kv_stream_inflight_chunks: chunks produced by prefill and not yet
# acked by a decode puller, summed over this process's live streams.
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT_CHUNKS = 0  # guarded-by: _INFLIGHT_LOCK


def _inflight_delta(delta: int) -> None:
    global _INFLIGHT_CHUNKS
    with _INFLIGHT_LOCK:
        _INFLIGHT_CHUNKS = max(0, _INFLIGHT_CHUNKS + delta)
        value = _INFLIGHT_CHUNKS
    metrics.set("serving_kv_stream_inflight_chunks", float(value))


class _StreamFailed(Exception):
    """Producer-side failure: the stream is dead and is dropped, not
    re-queued (the router's resubmit is the recovery path)."""


class PoisonPayload:
    """A streamed delivery whose RECEIVER rejected the content (e.g. more KV
    rows than the decode budget) while the wire completed cleanly. The
    stream is drained and acked per protocol, and the error surfaces inside
    `process()`, whose poison guard consumes the request with a failed
    result."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException) -> None:
        self.error = error


class KVStream:
    """Server-side record of ONE streamed KV handoff. The prefill loop
    `put_chunk`s position ranges as their K/V lands (packed at produce
    time) and `finish`es with the tail payload and END metadata; connection
    threads `read` it, possibly several times: chunks stay buffered until
    the final ack, so a torn delivery replays from chunk 0. The running
    crc32 computed at produce time is the END frame's torn-cache check."""

    def __init__(self, chunk_tokens: int = 0) -> None:
        self._cond = threading.Condition()
        self.chunk_tokens = int(chunk_tokens)
        self._chunks: list[tuple[dict, list, int]] = []  # guarded-by: _cond
        self._end: Optional[tuple[dict, list]] = None    # guarded-by: _cond
        self._failed = False                             # guarded-by: _cond
        self.checksum = 0                                # guarded-by: _cond
        self.payload_bytes = 0                           # guarded-by: _cond
        self._acked_hw = 0                               # guarded-by: _cond
        self._t0 = time.monotonic()
        # When each position range left prefill compute (stream-relative s).
        self.chunk_timeline: list[dict] = []             # guarded-by: _cond

    @property
    def failed(self) -> bool:
        with self._cond:
            return self._failed

    @property
    def chunks(self) -> int:
        with self._cond:
            return len(self._chunks)

    def put_chunk(self, lo: int, hi: int, arrays: dict) -> None:
        """Buffer one position range [lo, hi) for delivery; never blocks on
        a puller."""
        bufs, _ = pack_payload(arrays)
        wire_len = _payload_len(bufs)
        # The gauge rises BEFORE the chunk becomes visible: a connection
        # thread may deliver and ack it the moment notify lands, and its -1
        # ahead of this +1 would be eaten by the gauge's zero clamp.
        _inflight_delta(+1)
        try:
            with self._cond:
                if self._end is not None or self._failed:
                    raise RuntimeError("put_chunk on a finished KVStream")
                for view in bufs:
                    self.checksum = zlib.crc32(view, self.checksum)
                produce_t = round(time.monotonic() - self._t0, 6)
                meta = {"chunk": len(self._chunks), "pos_range": [int(lo), int(hi)],
                        "t_produce_s": produce_t}
                self.chunk_timeline.append({"chunk": meta["chunk"], "t_s": produce_t,
                                            "bytes": wire_len})
                self._chunks.append((meta, bufs, wire_len))
                self.payload_bytes += wire_len
                self._cond.notify_all()
        except BaseException:
            _inflight_delta(-1)  # the chunk never became visible
            raise

    def finish(self, end_meta: dict, end_arrays: Optional[dict] = None) -> None:
        bufs, _ = pack_payload(end_arrays or {})
        with self._cond:
            self._end = (dict(end_meta), bufs)
            self._cond.notify_all()

    def fail(self) -> None:
        """Producer died or raised: wake pullers with a terminal verdict,
        and release the un-acked chunks from the in-flight gauge."""
        with self._cond:
            self._failed = True
            pending = len(self._chunks) - self._acked_hw
            # An ack already in flight then finds nothing to release.
            self._acked_hw = len(self._chunks)
            self._cond.notify_all()
        if pending > 0:
            _inflight_delta(-pending)

    def chunk_acked(self, idx: int) -> None:
        """First-time ack bookkeeping for the in-flight gauge (a redelivery
        re-sends acked chunks without releasing them twice)."""
        delta = 0
        with self._cond:
            if idx + 1 > self._acked_hw:
                delta = idx + 1 - self._acked_hw
                self._acked_hw = idx + 1
        if delta:
            _inflight_delta(-delta)

    def read(self, idx: int, timeout: float):
        """Next item for a delivery at position `idx`: ("chunk", meta,
        bufs), ("end", meta, bufs), ("failed", None, None), or ("timeout",
        None, None) when the producer stalls past `timeout`."""
        deadline_t = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._failed:
                    return "failed", None, None
                if idx < len(self._chunks):
                    meta, bufs, _ = self._chunks[idx]
                    return "chunk", meta, bufs
                if self._end is not None:
                    end_meta, bufs = self._end
                    meta = {**end_meta, "end": True, "chunks": len(self._chunks),
                            "checksum": self.checksum, "payload_bytes": self.payload_bytes}
                    return "end", meta, bufs
                remaining = deadline_t - time.monotonic()
                if remaining <= 0:
                    return "timeout", None, None
                self._cond.wait(remaining)


def _payload_len(bufs: list) -> int:
    # Spec header included: the length a receiver's per-chunk len(payload)
    # sees, so both ends account identical bytes.
    return sum(memoryview(v).nbytes for v in bufs)


class HostAssembler:
    """Default stream receiver: the chunked per-position arrays reassembled
    into the monolithic bundle dict bytes_to_arrays would have returned
    (plus the streamed-only "tokens" prompt array)."""

    def __init__(self, begin_meta: Optional[dict] = None) -> None:
        self._parts: dict[str, list] = {}
        self.chunks = 0

    def chunk(self, cmeta: dict, arrays: dict) -> None:
        for name, arr in arrays.items():
            self._parts.setdefault(name, []).append(arr)
        self.chunks += 1

    def finish(self, end_meta: dict, end_arrays: dict):
        # np.concatenate drops the BF16 tag: view the result as the parts'.
        out = {name: np.concatenate(parts, axis=_CHUNK_AXES.get(name, 0)).view(parts[0].dtype)
               for name, parts in self._parts.items()}
        out.update(end_arrays)
        return out


class CacheAssembler:
    """Decode-side incremental bundle_to_cache: each streamed chunk is copied
    on arrival into its [:, :, lo:hi] slice of a zeroed [L, B, max_len, ...]
    buffer on `device`, so the cache is ready the moment END lands.
    `device=True` is the default device (CUDA); `device=False` assembles in
    host numpy buffers instead (the JAX package's mesh-decode shape)."""

    def __init__(self, max_len: int, device: Union[DeviceLike, bool] = True) -> None:
        self.max_len = int(max_len)
        self.device = False if device is False else resolve_device(None if device is True
                                                                    else device)
        self._bufs: dict = {}
        self._token_parts: list = []
        self.chunks = 0
        self.payload_bytes = 0
        self._token = None
        self._pos: Optional[int] = None

    def chunk(self, cmeta: dict, arrays: dict) -> None:
        lo, hi = (int(x) for x in cmeta["pos_range"])
        for name in _KV_NAMES:
            arr = arrays.get(name)
            if arr is None:
                continue
            if lo + arr.shape[2] > self.max_len:
                raise ValueError(f"stream chunk ends at {lo + arr.shape[2]} KV rows but "
                                 f"decode max_len={self.max_len}")
            self._insert(name, arr, lo)
        if "tokens" in arrays:
            self._token_parts.append(arrays["tokens"])
        self.chunks += 1

    def _insert(self, name: str, arr, lo: int) -> None:
        buf = self._bufs.get(name)
        if self.device is False:
            if buf is None:
                shape = list(arr.shape)
                shape[2] = self.max_len
                buf = self._bufs[name] = np.zeros(tuple(shape), arr.dtype)
            buf[:, :, lo: lo + arr.shape[2]] = arr
            return
        rows = to_tensor(arr, self.device)
        devicemod.record_transfer("kv.assembler_insert", int(arr.nbytes))
        if buf is None:
            buf = self._bufs[name] = rows.new_zeros(
                (*rows.shape[:2], self.max_len, *rows.shape[3:]))
        buf[:, :, lo: lo + rows.shape[2]] = rows

    def finish(self, end_meta: dict, end_arrays: dict):
        if "token" not in end_arrays or "pos" not in end_arrays:
            raise OSError("kv stream END frame missing token/pos tail")
        self._token = end_arrays["token"]
        self._pos = int(end_arrays["pos"])
        if self._pos > self.max_len:
            raise ValueError(f"stream holds {self._pos} KV rows but decode max_len={self.max_len}")
        return self

    def take(self):
        """-> (KVCache, first token [B], pos, context tokens [B, pos] | None).
        On a device the cache IS the assembled buffers and the token a
        tensor there; with device=False both are host numpy arrays."""
        if self._pos is None:
            raise RuntimeError("take() before the stream END landed")
        cache = KVCache(k=self._bufs["k"], v=self._bufs["v"], pos=self._pos,
                        k_scale=self._bufs.get("k_scale"), v_scale=self._bufs.get("v_scale"))
        context = self.context()
        token = np.asarray(self._token, np.int32)
        if self.device is not False:
            token = to_tensor(token, self.device)
        return cache, token, self._pos, context

    def context(self) -> Optional[np.ndarray]:
        """The prompt tokens [B, pos] the stream shipped (None without)."""
        return np.concatenate(self._token_parts, axis=1) if self._token_parts else None

    def bundle(self) -> dict:
        """A host assembly (device=False) as the monolithic bundle's array
        dict, cut to pos rows: what bundle_to_cache takes for a mesh's
        reshard."""
        if self._pos is None or self.device is not False:
            raise RuntimeError("bundle() needs a finished host assembly")
        out = {n: buf[:, :, :self._pos] for n, buf in self._bufs.items()}
        out.update(pos=np.asarray(self._pos, np.int32), token=np.asarray(self._token, np.int32))
        return out


# ---------------------------------------------------------------------------
# The server


class KVServer:
    """Per-worker handoff server. The owning worker enqueues and dequeues
    locally; peers drive the queues through one-shot TCP ops:

      submit_prompt  (router/client -> prefill)   meta {id}, payload bytes
      pull_bundle    (decode -> prefill)          reply meta {id}|{none};
                     a monolithic payload or a BEGIN/CHUNK/END stream; the
                     puller ACKS on the same connection after processing,
                     and an unacked bundle or stream is re-queued
                     (at-least-once; decode is idempotent per id)
      pull_result    (router/client -> decode)    meta {id}; evicted on delivery
      fetch_prefix   (sibling -> any)             the contiguous run of the
                     requested digest chain this instance holds, one block
                     per stream chunk

    It binds the pod network (0.0.0.0) like a containerPort behind a
    Service. With LWS_TPU_KV_TOKEN set (or `token=`), every op must carry
    the matching "token" in its frame meta or is rejected unauthorized; the
    client helpers read the same variable. The socket listens from
    construction on."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 token: Optional[str] = None) -> None:
        self._token = token if token is not None else os.environ.get("LWS_TPU_KV_TOKEN")
        # provider(digest_bytes) -> arrays | None, set by serve_prefixes().
        self._prefix_provider = None
        self._prompts: "queue.Queue[tuple[dict, bytes]]" = queue.Queue()
        self._bundles: "queue.Queue[tuple[dict, object]]" = queue.Queue()
        self._results: dict[str, tuple[dict, bytes]] = {}  # guarded-by: _results_lock
        self._results_lock = threading.Lock()
        # Bumped from per-connection threads: every touch goes through the lock.
        self._counts_lock = threading.Lock()
        self.bundles_delivered = 0  # guarded-by: _counts_lock (acked pulls)
        self.results_served = 0     # guarded-by: _counts_lock (delivered results)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            tune_socket(self._sock)  # buffer floors inherit into accepted sockets
            self._sock.bind((host, port))
            self._sock.listen(16)
        except OSError:
            self._sock.close()  # a failed bind must not leak the socket
            raise
        self.port = self._sock.getsockname()[1]
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    # ---- worker side (in process) -----------------------------------------
    def next_prompt(self, timeout: float = 0.2) -> Optional[tuple[dict, bytes]]:
        try:
            meta, payload = self._prompts.get(timeout=timeout)
        except queue.Empty:
            return None
        enq = meta.pop("_enq_t", None)
        if enq is not None:
            meta["queue_wait_s"] = max(0.0, time.time() - enq)
            # The deadline budget pays for queue time too.
            if "deadline_s" in meta:
                meta["deadline_s"] = max(0.0, float(meta["deadline_s"]) - meta["queue_wait_s"])
        return meta, payload

    def offer_bundle(self, meta: dict, payload) -> None:
        if "deadline_s" in meta:
            # Anchor the remaining budget at enqueue: the wait for a decode
            # pull is charged when the bundle ships.
            meta["_offered_t"] = time.monotonic()
        self._bundles.put((meta, payload))
        self._backlog_beat()

    def offer_stream(self, meta: dict, stream: KVStream) -> None:
        """Offer a STREAMED handoff before prefill computes, so a puller
        attaches while chunks are still being produced."""
        self.offer_bundle(meta, stream)

    def _backlog_beat(self) -> None:
        # The handoff backlog's heartbeat: progress = bundles pulled and
        # acked, depth = bundles still waiting.
        with self._counts_lock:
            delivered = self.bundles_delivered
        flightrecorder.beat(f"kv_backlog:{self.port}", progress=delivered,
                            depth=self._bundles.qsize())

    def delivery_counts(self) -> tuple[int, int]:
        """(bundles_delivered, results_served) read under the lock."""
        with self._counts_lock:
            return self.bundles_delivered, self.results_served

    def post_result(self, req_id: str, meta: dict, payload: bytes) -> None:
        with self._results_lock:
            self._results[req_id] = (meta, payload)

    def serve_prefixes(self, provider) -> None:
        """Enable `fetch_prefix`: `provider(digest_bytes)` returns one cached
        prefix block's array dict, or None when this instance no longer
        holds that digest (typically a host arena's `get`)."""
        self._prefix_provider = provider

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    # ---- network side ------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,), daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        # A peer that died mid-frame must not kill the handler thread with a
        # trace: the protocol is one-shot and the re-queue paths already ran.
        try:
            with conn:
                tune_socket(conn)
                self._handle_one(conn)
        except OSError:
            metrics.inc("serving_kv_connection_errors_total")

    def _handle_one(self, conn: socket.socket) -> None:
        faults.fire("kv.server.recv")
        meta, payload = recv_msg(conn)
        if meta is None:
            return
        if self._token and not hmac.compare_digest(
            str(meta.get("token", "")).encode(), self._token.encode()
        ):
            send_msg(conn, {"error": "unauthorized"})
            return
        op = meta.get("op")
        if op == "submit_prompt":
            meta["_enq_t"] = time.time()  # queue-wait stamp (same host)
            self._prompts.put((meta, payload))
            send_msg(conn, {"ok": True})
        elif op == "pull_bundle":
            self._serve_bundle(conn, meta)
        elif op == "pull_result":
            # Pop under the lock BEFORE sending: concurrent pulls for one id
            # deliver it once; a failed send re-inserts it for a retry.
            with self._results_lock:
                entry = self._results.pop(meta.get("id", ""), None)
            if entry is None:
                send_msg(conn, {"none": True})
                return
            try:
                fault = faults.fire("kv.server.send_result")
                if fault is not None and fault.mode == "partial_write":
                    _send_partial(conn, entry[0], entry[1], int(fault.arg))
                    raise OSError("injected partial result write")
                send_msg(conn, entry[0], entry[1])
            except OSError:
                with self._results_lock:
                    self._results.setdefault(meta.get("id", ""), entry)
                return
            with self._counts_lock:
                self.results_served += 1
        elif op == "fetch_prefix":
            self._serve_prefix(conn, meta)
        else:
            send_msg(conn, {"error": f"unknown op {op!r}"})

    def _serve_bundle(self, conn: socket.socket, meta: dict) -> None:
        try:
            bmeta, bpayload = self._bundles.get(timeout=meta.get("timeout", 1.0))
        except queue.Empty:
            send_msg(conn, {"none": True})
            return
        offered = bmeta.pop("_offered_t", None)
        pop_t = time.monotonic()
        if offered is not None and "deadline_s" in bmeta:
            # The bundle-queue wait is charged against the deadline.
            bmeta["deadline_s"] = max(0.0, float(bmeta["deadline_s"]) - (pop_t - offered))
        # At-least-once END TO END: the bundle is discarded only once the
        # puller acks on this connection, after it PROCESSED it; a stream
        # re-queues whole and replays from chunk 0.
        ack_timeout = float(meta.get("ack_timeout", 120.0))
        try:
            if isinstance(bpayload, KVStream):
                self._send_stream(conn, bmeta, bpayload, ack_timeout)
            else:
                t0 = time.perf_counter()
                fault = faults.fire("kv.server.send_bundle")
                if fault is not None and fault.mode == "partial_write":
                    _send_partial(conn, bmeta, bpayload, int(fault.arg))
                    raise OSError("injected partial bundle write")
                if fault is not None and fault.mode == "pace":
                    _pace_sleep(fault, len(bpayload))
                send_msg(conn, bmeta, bpayload)
                metrics.inc("serving_kv_transfer_bytes_total", {"role": "prefill"},
                            value=float(len(bpayload)))
                metrics.observe("serving_kv_transfer_seconds", time.perf_counter() - t0,
                                {"role": "prefill"})
            conn.settimeout(ack_timeout)
            ack, _ = recv_msg(conn)
            if not (ack or {}).get("ack"):
                raise OSError("no ack")
            with self._counts_lock:
                self.bundles_delivered += 1
            self._backlog_beat()
        except _StreamFailed:
            return  # a dead producer's stream is dropped, never re-queued
        except OSError:
            if "deadline_s" in bmeta:
                # The failed delivery window burned budget too; re-anchor.
                now = time.monotonic()
                bmeta["deadline_s"] = max(0.0, float(bmeta["deadline_s"]) - (now - pop_t))
                bmeta["_offered_t"] = now
            # The id is the only key joining this requeue to its request.
            flightrecorder.record("kv_requeue", request_id=str(bmeta.get("id") or ""))
            self._bundles.put((bmeta, bpayload))
            self._backlog_beat()

    def _serve_prefix(self, conn: socket.socket, meta: dict) -> None:
        """The contiguous prefix of the requested digest chain this instance
        holds, one block per chunk over the kv_stream protocol; the chain
        stops at the first digest the provider misses (a block whose
        predecessors are absent is useless: digests chain positions)."""
        provider = self._prefix_provider
        digests = [bytes.fromhex(h) for h in meta.get("digests", [])]
        if provider is None or not digests:
            send_msg(conn, {"none": True})
            return
        ack_timeout = float(meta.get("ack_timeout", 30.0))
        stream = KVStream()
        served: list[str] = []
        try:
            for d in digests:
                arrays = provider(d)
                if arrays is None:
                    break
                stream.put_chunk(len(served), len(served) + 1, arrays)
                served.append(d.hex())
            if not served:
                send_msg(conn, {"none": True})
                return
            stream.finish({"digests": served})
            # A torn leg raises OSError to _serve_one with no re-queue: the
            # requester's retry re-serves from scratch.
            self._send_stream(conn, {"op": "fetch_prefix"}, stream, ack_timeout, role="prefix")
        finally:
            # After a fully acked delivery a no-op; on a torn leg it releases
            # the un-acked chunks from the in-flight gauge (no redelivery).
            stream.fail()

    def _send_stream(self, conn: socket.socket, bmeta: dict, stream: KVStream,
                     ack_timeout: float, role: str = "prefill") -> None:
        """One streamed delivery attempt: BEGIN, chunk/ack pairs as the
        producer lands them, then END. Raises OSError on a torn leg (the
        caller re-queues) or _StreamFailed when the producer died. `role`
        labels the transfer metrics: "prefill" for a handoff, "prefix" for a
        sibling's prefix leg."""
        t0 = time.perf_counter()
        send_msg(conn, {**bmeta, "stream": True})
        idx = 0
        while True:
            kind, cmeta, bufs = stream.read(idx, timeout=ack_timeout)
            if kind == "timeout":
                raise OSError("kv stream producer stalled")
            if kind == "failed":
                try:
                    send_msg(conn, {"stream_failed": True})
                except OSError:
                    pass
                raise _StreamFailed(bmeta.get("id", "?"))
            if kind == "chunk":
                fault = faults.fire("kv.stream.send_chunk")
                if fault is not None and fault.mode == "partial_write":
                    _send_partial(conn, cmeta, bufs, int(fault.arg))
                    raise OSError("injected partial stream chunk write")
                if fault is not None and fault.mode == "pace":
                    _pace_sleep(fault, _payload_len(bufs))
                send_msg(conn, cmeta, bufs)
                conn.settimeout(ack_timeout)
                ack, _ = recv_msg(conn)
                if ack is None or ack.get("ack_chunk") != cmeta["chunk"]:
                    raise OSError("kv stream chunk unacked")
                stream.chunk_acked(idx)
                idx += 1
                continue
            send_msg(conn, cmeta, bufs)  # END
            metrics.inc("serving_kv_transfer_bytes_total", {"role": role},
                        value=float(stream.payload_bytes))
            metrics.observe("serving_kv_transfer_seconds", time.perf_counter() - t0,
                            {"role": role})
            return


# ---------------------------------------------------------------------------
# Client helpers


def _auth(meta: dict) -> dict:
    token = os.environ.get("LWS_TPU_KV_TOKEN")
    if token:
        meta = dict(meta, token=token)
    return meta


def _one_shot(endpoint: tuple[str, int], meta: dict, payload: bytes = b"",
              timeout: float = 10.0) -> tuple[Optional[dict], bytes]:
    # Every blocking point checks the bound deadline BEFORE waiting and
    # clamps its socket timeout to the remaining budget.
    resilience.check("kv.connect")
    faults.fire("kv.client.connect")
    with socket.create_connection(endpoint, timeout=resilience.clamp_timeout(timeout)) as sock:
        tune_socket(sock)
        send_msg(sock, _auth(meta), payload)
        faults.fire("kv.client.recv")
        return recv_msg(sock)


def _deadline_meta(meta: dict) -> dict:
    """Attach the caller's bound deadline (remaining seconds) to the meta."""
    deadline = resilience.current()
    if deadline is not None:
        meta["deadline_s"] = deadline.to_wire()
    return meta


def submit_prompt(endpoint, req_id: str, prompt_bytes: bytes,
                  trace_ctx: Optional[dict] = None, klass: Optional[str] = None) -> None:
    """Queue a prompt on a prefill worker. `trace_ctx` (default: the
    caller's current span context) rides the frame meta, so the prefill
    worker's span subtree grafts onto the caller's trace; the bound Deadline
    (if any) rides the same way, so the worker drops the prompt once it has
    expired; `klass`, the request's workload class, rides to the prefill leg
    and on with the bundle to decode, so both workers' SLO series carry it."""
    if trace_ctx is None:
        from lws_tpu_torch.core import trace

        trace_ctx = trace.current_context()
    meta = _deadline_meta({"op": "submit_prompt", "id": req_id})
    if trace_ctx:
        meta["trace"] = trace_ctx
    if klass:
        meta["klass"] = klass
    meta, _ = _one_shot(endpoint, meta, prompt_bytes)
    if not (meta or {}).get("ok"):
        raise RuntimeError(f"submit_prompt failed: {meta}")


def _recv_stream(sock: socket.socket, begin_meta: dict, receiver,
                 ack_timeout: float) -> tuple[dict, object, int]:
    """Client half of the kv_stream protocol: CHUNK frames into `receiver`
    (each acked) until END, then the checksum and count verified. Returns
    (merged meta, receiver.finish(...) or a PoisonPayload, payload bytes).
    A wire mismatch raises OSError: no final ack, the server re-queues, and
    the redelivery replays from chunk 0."""
    crc = 0
    n = 0
    nbytes = 0
    t0 = time.monotonic()
    # When each chunk landed off the wire (stream-relative s), beside when
    # it left prefill.
    chunk_timeline: list[dict] = []
    poison: Optional[BaseException] = None
    while True:
        resilience.check("kv.stream.recv")
        fault = faults.fire("kv.stream.recv_chunk")
        if fault is not None and fault.mode in ("drop", "partial_write"):
            # Receive-side loss: the connection is abandoned mid-stream as
            # if the read tore.
            raise OSError(f"injected kv stream recv loss at chunk {n}")
        sock.settimeout(resilience.clamp_timeout(ack_timeout))
        cmeta, payload = recv_msg(sock)
        if cmeta is None:
            raise OSError("kv stream truncated mid-frame")
        if cmeta.get("stream_failed"):
            raise OSError("kv stream failed at the sender")
        if cmeta.get("end"):
            if int(cmeta.get("chunks", -1)) != n or int(cmeta.get("checksum", -1)) != crc:
                raise OSError("torn kv stream: checksum/chunk-count mismatch")
            end_arrays = bytes_to_arrays(payload) if payload else {}
            merged = {k: v for k, v in {**begin_meta, **cmeta}.items()
                      if k not in ("end", "checksum", "stream")}
            merged["streamed"] = True
            merged["payload_bytes"] = nbytes
            try:
                receiver.payload_bytes = nbytes
                receiver.chunk_timeline = chunk_timeline
            except AttributeError:
                pass
            if poison is None:
                try:
                    result = receiver.finish(cmeta, end_arrays)
                except Exception as e:  # noqa: BLE001 — a content verdict, see below
                    poison = e
            if poison is not None:
                merged["receiver_error"] = repr(poison)[:200]
                return merged, PoisonPayload(poison), nbytes
            return merged, result, nbytes
        if int(cmeta.get("chunk", -1)) != n:
            raise OSError("out-of-order kv stream chunk")
        crc = zlib.crc32(payload, crc)
        chunk_timeline.append({"chunk": n, "t_s": round(time.monotonic() - t0, 6),
                               "bytes": len(payload),
                               **({"t_produce_s": cmeta["t_produce_s"]}
                                  if "t_produce_s" in cmeta else {})})
        # Ack on receipt, then insert: the ack keeps the sender moving while
        # this side uploads; durability is the END checksum + final ack.
        send_msg(sock, {"ack_chunk": n})
        if poison is None:
            try:
                receiver.chunk(cmeta, bytes_to_arrays(payload))
            except Exception as e:  # noqa: BLE001
                # A receiver rejection is a CONTENT verdict: re-queueing could
                # not heal it, so drain the protocol and hand it to process().
                poison = e
        n += 1
        nbytes += len(payload)


def pull_bundle(endpoint, timeout: float = 1.0, process=None,
                ack_timeout: float = 120.0, receiver_factory=None):
    """(meta, payload), `process(meta, payload)`'s result when a callback is
    given, or None when the peer has nothing pending.

    Without `process` the receipt is acked at once; with it, the ack goes
    back only after the callback returns, so a puller that dies mid-process
    leaves the bundle re-queued (at-least-once end to end). `ack_timeout`
    is the server's ack-wait window. A streamed reply feeds its chunks to
    `receiver_factory(begin_meta)` (default: a HostAssembler) and `payload`
    is the receiver's finish() result; `meta` gains `streamed`, `chunks`
    and `payload_bytes`. A receiver exception arrives as a PoisonPayload
    for `process()` (re-raised after the ack without one). `meta` also
    gains `wire_s`, the seconds from the reply's first byte to its last (a
    local measurement, never on the wire)."""
    resilience.check("kv.pull_bundle")
    faults.fire("kv.client.connect")
    with socket.create_connection(
        endpoint, timeout=resilience.clamp_timeout(timeout + 9.0)
    ) as sock:
        tune_socket(sock)
        send_msg(sock, _auth({"op": "pull_bundle", "timeout": timeout,
                              "ack_timeout": ack_timeout}))
        faults.fire("kv.client.recv")
        # The wire clock opens at the FIRST reply byte: the wait before it
        # is the server's long poll for a bundle.
        raw = _recv_exact(sock, _FRAME.size)
        t0 = time.perf_counter()
        meta, payload = (None, b"") if raw is None else _recv_msg_body(sock, raw)
        if meta is None:
            raise OSError("truncated pull_bundle reply")
        if meta.get("error"):
            raise RuntimeError(f"pull_bundle rejected: {meta}")
        if meta.get("none"):
            return None
        if meta.get("stream"):
            receiver = receiver_factory(meta) if receiver_factory else HostAssembler(meta)
            try:
                meta, payload, rx_bytes = _recv_stream(sock, meta, receiver, ack_timeout)
            except OSError as e:
                # The server re-queues the whole stream; the id joins the
                # torn leg to the request it delayed.
                flightrecorder.record("kv_stream_torn", request_id=str(meta.get("id") or ""),
                                      error=repr(e)[:200])
                raise
        else:
            rx_bytes = len(payload)
        meta["wire_s"] = time.perf_counter() - t0
        metrics.inc("serving_kv_transfer_bytes_total", {"role": "decode"},
                    value=float(rx_bytes))
        metrics.observe("serving_kv_transfer_seconds", meta["wire_s"], {"role": "decode"})
        if process is None:
            _send_ack(sock)
            if isinstance(payload, PoisonPayload):
                raise payload.error
            return meta, payload
        result = process(meta, payload)  # raise => no ack => the server re-queues
        _send_ack(sock)
        return result


def _send_ack(sock: socket.socket) -> None:
    fault = faults.fire("kv.ack")
    if fault is not None and fault.mode == "drop":
        # Ack loss: the connection closes unacked, the server re-queues, and
        # the next pull replays the bundle into the puller's dedup guard.
        return
    send_msg(sock, {"ack": True})


def pull_result(endpoint, req_id: str, timeout: float = 10.0):
    """None while the result is not ready. Raises on a protocol-level
    rejection (e.g. auth); a result whose meta carries "failed" is the
    decode side's verdict on a poison request, returned for the caller to
    check."""
    meta, payload = _one_shot(endpoint, {"op": "pull_result", "id": req_id}, timeout=timeout)
    if meta is None or meta.get("none"):
        return None
    if meta.get("error"):
        raise RuntimeError(f"pull_result rejected: {meta}")
    return meta, payload


# ---------------------------------------------------------------------------
# Cross-instance prefix fetch


class _PrefixReceiver:
    """fetch_prefix's stream receiver: chunk i is block i of the served
    digest chain; finish() returns the ordered block list."""

    def __init__(self) -> None:
        self.blocks: list[dict] = []

    def chunk(self, cmeta: dict, arrays: dict) -> None:
        self.blocks.append(arrays)

    def finish(self, end_meta: dict, end_arrays: dict):
        return self.blocks


def fetch_prefix(endpoint, digests: Sequence, timeout: float = 5.0,
                 ack_timeout: float = 30.0) -> dict:
    """Pull cached prefix blocks for `digests` (a hash-chain run, in order)
    from a sibling's KVServer -> {digest_bytes: array dict} for the
    contiguous chain prefix it held; {} when it held nothing. A torn leg
    raises OSError without a partial result."""
    resilience.check("kv.prefix.fetch")
    faults.fire("kv.prefix.fetch")
    with socket.create_connection(endpoint, timeout=resilience.clamp_timeout(timeout)) as sock:
        tune_socket(sock)
        send_msg(sock, _auth({"op": "fetch_prefix", "digests": [d.hex() for d in digests],
                              "ack_timeout": ack_timeout}))
        t0 = time.perf_counter()
        meta, _ = recv_msg(sock)
        if meta is None:
            raise OSError("truncated fetch_prefix reply")
        if meta.get("error"):
            raise RuntimeError(f"fetch_prefix rejected: {meta}")
        if meta.get("none"):
            return {}
        if not meta.get("stream"):
            raise OSError("fetch_prefix reply was not a stream")
        merged, blocks, rx_bytes = _recv_stream(sock, meta, _PrefixReceiver(), ack_timeout)
        if isinstance(blocks, PoisonPayload):
            raise OSError(f"fetch_prefix receiver failed: {blocks.error!r}")
        metrics.inc("serving_kv_transfer_bytes_total", {"role": "prefix"}, value=float(rx_bytes))
        metrics.observe("serving_kv_transfer_seconds", time.perf_counter() - t0,
                        {"role": "prefix"})
        served = [bytes.fromhex(h) for h in merged.get("digests", [])]
        return dict(zip(served, blocks))


class RemotePrefixSource:
    """The paged engine's remote tier: candidate sibling endpoints from a
    dynamic `lookup(digest_hex) -> (host, port) | None` and/or a static
    `endpoints` list, each behind its own CircuitBreaker, each fetch retried
    once on a transient OSError. `fetch()` never raises: every failure
    degrades to {} and the engine prefills the prefix itself."""

    def __init__(self, endpoints: Sequence = (), lookup=None, timeout: float = 5.0,
                 ack_timeout: float = 30.0, failure_threshold: int = 3,
                 reset_timeout_s: float = 10.0):
        self.endpoints = [tuple(e) for e in endpoints]
        self.lookup = lookup
        self.timeout = timeout
        self.ack_timeout = ack_timeout
        self._failure_threshold = failure_threshold
        self._reset_timeout_s = reset_timeout_s
        self._breakers: dict[str, resilience.CircuitBreaker] = {}

    def _breaker(self, endpoint) -> resilience.CircuitBreaker:
        key = f"{endpoint[0]}:{endpoint[1]}"
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = resilience.CircuitBreaker(
                key, failure_threshold=self._failure_threshold,
                reset_timeout_s=self._reset_timeout_s)
        return br

    def _candidates(self, digests: list) -> list:
        out: list = []
        if self.lookup is not None:
            try:
                hit = self.lookup(digests[0].hex())
            except Exception:  # noqa: BLE001 — a stale index is not fatal
                hit = None
            if hit:
                out.append(tuple(hit))
        for ep in self.endpoints:
            if ep not in out:
                out.append(ep)
        return out

    def fetch(self, digests: Sequence) -> dict:
        digests = list(digests)
        if not digests:
            return {}
        for endpoint in self._candidates(digests):
            br = self._breaker(endpoint)
            if not br.allow():
                continue  # open circuit: fail fast to the next candidate
            try:
                found = resilience.call(
                    lambda ep=endpoint: fetch_prefix(ep, digests, timeout=self.timeout,
                                                     ack_timeout=self.ack_timeout),
                    site="kv.prefix.fetch",
                    policy=resilience.RetryPolicy(max_attempts=2, base_s=0.05, cap_s=0.25),
                )
            except Exception:  # noqa: BLE001 — any failure is a miss: next peer
                br.record_failure()
                continue
            br.record_success()
            if found:
                return found
        return {}


# ---------------------------------------------------------------------------
# Endpoint discovery from the DisaggregatedSet's `-prv` service record


def discover_role_endpoint(client, namespace: str, ds_name: str, role: str,
                           port_env: str = "LWS_TPU_KV_PORT",
                           revision: Optional[str] = None,
                           slice_idx: Optional[str] = None) -> Optional[tuple[str, int]]:
    """Resolve `role`'s KV endpoint through the revision-aware service
    record: the `-prv` Service labeled (ds, role), its selector matched
    against ready Pods, and the pod's address + its declared KV port (the
    `port_env` variable of its spec). `client` is an HTTP client of the API
    server (`lws_tpu_torch.client.RemoteClient`). `revision`/`slice_idx`
    pin the pairing to a worker's own revision and slice."""
    def svc_label(s, key):
        return s.get("metadata", {}).get("labels", {}).get(key)

    services = [
        s for s in client.list("Service")
        if s.get("metadata", {}).get("namespace") == namespace
        and svc_label(s, DS_NAME_LABEL_KEY) == ds_name
        and svc_label(s, DS_ROLE_LABEL_KEY) == role
        and s.get("metadata", {}).get("name", "").endswith("-prv")
        and (revision is None or svc_label(s, DS_REVISION_LABEL_KEY) == revision)
        and (slice_idx is None or svc_label(s, DS_SLICE_LABEL_KEY) == str(slice_idx))
    ]
    for svc in services:
        selector = svc.get("spec", {}).get("selector", {})
        for pod in client.list("Pod"):
            meta = pod.get("metadata", {})
            if meta.get("namespace") != namespace:
                continue
            labels = meta.get("labels", {})
            if any(labels.get(k) != v for k, v in selector.items()):
                continue
            status = pod.get("status", {})
            if not status.get("ready"):
                continue
            host = status.get("address") or "127.0.0.1"
            for container in pod.get("spec", {}).get("containers", []):
                for env in container.get("env", []):
                    if env.get("name") == port_env and env.get("value"):
                        return host, int(env["value"])
    return None
