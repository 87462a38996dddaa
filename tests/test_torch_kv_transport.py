"""The port's KV wire (lws_tpu_torch/serving/kv_transport.py) and its copy
of the resilience module, held to the JAX package's on the CPU.

  * The port counterpart of each case of tests/test_kv_transport.py
    (at-least-once bundle delivery, token auth, pull_result eviction and
    races, the raw array format, vectored sends, Nagle off, the streamed
    BEGIN/CHUNK/END protocol with its poison, checksum and producer-failure
    paths, bind-failure hygiene).
  * Cross-framework sockets, each way: a JAX KVServer answering the port's
    client helpers, and a port KVServer answering JAX's, for a monolithic
    bundle, a streamed bundle (per-chunk acks and the END checksum), a
    result and a prefix fetch. Arrays must arrive byte for byte.
  * pack_payload's bytes equal JAX's for f32, int8, int32 and bf16, also
    with ml_dtypes hidden from the port: every bf16 producer of the port (a
    tensor, host_array's copy, the dense engine's streamed chunks) names
    bf16 "bfloat16" either way, where plain uint16 bits would go out as
    "uint16" and a JAX receiver would read the K/V as integers.
  * The resilience copy behaves like lws_tpu.core.resilience under an
    injected clock: deadline wire round trip, retries, breaker transitions,
    SeenIds eviction, the drain latch.
Everything is exact: no tolerance is involved."""

import copy
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import resilience as jres
from lws_tpu.serving import kv_host_arena as jarena
from lws_tpu.serving import kv_transport as jkt
from lws_tpu_torch.core import resilience as tres
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.serving import kv_host_arena as tarena
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.engine import Engine


@pytest.fixture(scope="module", autouse=True)
def jax_metrics_restored():
    """The JAX package's wire records its transfers in its process-global
    metrics registry, and tests/test_profile_plane.py requires that registry
    to hold no serving_kv_transfer_* series when it runs later in the same
    process. So a module that drives JAX's wire leaves the registry as it
    found it."""
    reg = jmetrics.REGISTRY
    with reg._lock:
        saved = copy.deepcopy((reg._label_sets, reg._counters, reg._gauges, reg._histograms))
    yield
    with reg._lock:
        reg._label_sets, reg._counters, reg._gauges, reg._histograms = saved


def wait_for(predicate, timeout=5.0):
    """The final ack is one-way: the client returns before the server has
    counted it, so counter asserts poll briefly."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


@pytest.fixture
def server():
    s = kt.KVServer(port=0, host="127.0.0.1")
    yield s
    s.close()


def ep(server):
    return ("127.0.0.1", server.port)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_kv_transport.py


def test_process_failure_requeues_bundle(server):
    server.offer_bundle({"id": "r1"}, b"payload")
    with pytest.raises(RuntimeError, match="mid-process"):
        kt.pull_bundle(ep(server), timeout=1.0,
                       process=lambda m, p: (_ for _ in ()).throw(RuntimeError("mid-process")),
                       ack_timeout=2.0)
    assert server.bundles_delivered == 0
    got = kt.pull_bundle(ep(server), timeout=2.0)  # redelivery
    assert got is not None and got[0]["id"] == "r1" and got[1] == b"payload"
    assert wait_for(lambda: server.bundles_delivered == 1)


def test_process_success_acks_and_consumes(server):
    server.offer_bundle({"id": "r2"}, b"xyz")
    seen = {}

    def process(meta, payload):
        seen["meta"], seen["payload"] = meta, payload
        return "done"

    assert kt.pull_bundle(ep(server), timeout=1.0, process=process) == "done"
    assert seen["payload"] == b"xyz"
    assert wait_for(lambda: server.bundles_delivered == 1)
    assert kt.pull_bundle(ep(server), timeout=0.2) is None  # consumed


def test_token_auth_rejects_unauthenticated_ops(monkeypatch):
    s = kt.KVServer(port=0, host="127.0.0.1", token="sekret")
    try:
        monkeypatch.delenv("LWS_TPU_KV_TOKEN", raising=False)
        with pytest.raises(RuntimeError, match="submit_prompt failed"):
            kt.submit_prompt(ep(s), "r", b"p")
        with pytest.raises(RuntimeError, match="rejected"):
            kt.pull_bundle(ep(s), timeout=0.2)
        s.post_result("r", {"id": "r"}, b"out")
        with pytest.raises(RuntimeError, match="rejected"):
            kt.pull_result(ep(s), "r")
        monkeypatch.setenv("LWS_TPU_KV_TOKEN", "sekret")
        kt.submit_prompt(ep(s), "r2", b"p2")
        assert s.next_prompt(timeout=1.0)[0]["id"] == "r2"
        assert kt.pull_result(ep(s), "r")[1] == b"out"
    finally:
        s.close()


def test_pull_result_evicts_once(server):
    server.post_result("a", {"id": "a"}, b"res")
    assert kt.pull_result(ep(server), "a")[1] == b"res"
    assert kt.pull_result(ep(server), "a") is None
    assert server.results_served == 1


def test_pull_result_concurrent_single_delivery(server):
    server.post_result("c", {"id": "c"}, b"res")
    hits = []

    def pull():
        got = kt.pull_result(ep(server), "c")
        if got is not None:
            hits.append(got)

    threads = [threading.Thread(target=pull) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(hits) == 1 and server.results_served == 1


def test_pack_roundtrip_preserves_shapes_and_is_zero_copy():
    arrays = {
        "k": np.arange(48, dtype=np.float32).reshape(2, 1, 4, 2, 3),
        "pos": np.asarray(7, np.int32),
        "token": np.asarray([3], np.int32),
        "empty": np.zeros((2, 0, 4), np.float32),
    }
    out = kt.bytes_to_arrays(kt.arrays_to_bytes(**arrays))
    assert set(out) == set(arrays)
    for name, want in arrays.items():
        assert out[name].dtype == want.dtype and out[name].shape == want.shape
        np.testing.assert_array_equal(out[name], want)
    assert out["pos"].ndim == 0 and int(out["pos"]) == 7
    assert out["k"].base is not None, "decode copied instead of viewing"
    # bf16 (a torch tensor, or JAX's ml_dtypes host type) arrives as its
    # uint16 bits in the BF16 dtype, and round-trips to the same values.
    bf = torch.arange(6, dtype=torch.float32).to(torch.bfloat16).reshape(2, 3)
    for value in (bf, jax_host(bf)):
        back = kt.bytes_to_arrays(kt.arrays_to_bytes(x=value))["x"]
        assert back.dtype == kt.BF16 and kt.is_bfloat16(back) and back.shape == (2, 3)
        assert torch.equal(kt.to_tensor(back, torch.device("cpu")), bf)


def test_vectored_send_survives_large_multi_buffer_payloads(server):
    parts = [np.random.RandomState(i).bytes(257 * 1024) for i in range(9)]
    with kt.socket.create_connection(ep(server)) as sock:
        kt.tune_socket(sock)
        kt.send_msg(sock, {"op": "submit_prompt", "id": "vec"}, [memoryview(p) for p in parts])
        reply, _ = kt.recv_msg(sock)
    assert reply == {"ok": True}
    meta, got = server.next_prompt(timeout=2.0)
    assert meta["id"] == "vec" and got == b"".join(parts)


def test_kv_sockets_run_nodelay(server):
    with kt.socket.create_connection(ep(server)) as sock:
        kt.tune_socket(sock)
        assert sock.getsockopt(kt.socket.IPPROTO_TCP, kt.socket.TCP_NODELAY) != 0
    assert server._sock.getsockopt(kt.socket.IPPROTO_TCP, kt.socket.TCP_NODELAY) != 0


def stream_of(chunks, end_arrays, chunk_tokens=4):
    """A finished KVStream with f32 K/V chunks of the given widths and their
    prompt tokens."""
    stream = kt.KVStream(chunk_tokens)
    lo = 0
    for width in chunks:
        stream.put_chunk(lo, lo + width, {
            "k": np.full((2, 1, width, 2, 3), float(lo), np.float32),
            "v": np.full((2, 1, width, 2, 3), float(lo + 1), np.float32),
            "tokens": np.arange(lo, lo + width, dtype=np.int32)[None, :],
        })
        lo += width
    stream.finish({"handoff": {"streamed": True}}, end_arrays)
    return stream, lo


def test_streamed_pull_default_receiver_reassembles(server):
    end = {"token": np.asarray([9], np.int32), "pos": np.asarray(12, np.int32)}
    stream, total = stream_of([4, 4, 4], end)
    server.offer_stream({"id": "s1"}, stream)
    meta, arrays = kt.pull_bundle(ep(server), timeout=2.0, ack_timeout=10.0)
    assert meta["id"] == "s1" and meta["streamed"] and meta["chunks"] == 3
    assert meta["payload_bytes"] == stream.payload_bytes
    assert arrays["k"].shape[2] == total
    np.testing.assert_array_equal(arrays["tokens"][0], np.arange(total, dtype=np.int32))
    assert int(arrays["pos"]) == 12 and arrays["token"][0] == 9
    assert arrays["k"][0, 0, 0, 0, 0] == 0.0 and arrays["k"][0, 0, 4, 0, 0] == 4.0
    assert wait_for(lambda: server.delivery_counts()[0] == 1)
    assert kt.pull_bundle(ep(server), timeout=0.2) is None  # consumed


def test_stream_receiver_rejection_is_poison_not_requeue(server):
    end = {"token": np.asarray([1], np.int32), "pos": np.asarray(8, np.int32)}
    stream, _ = stream_of([4, 4], end)
    server.offer_stream({"id": "s2"}, stream)

    class RejectsContent(kt.HostAssembler):
        def chunk(self, cmeta, arrays):
            raise ValueError("rows past this side's budget")

    seen = {}

    def process(meta, payload):
        assert isinstance(payload, kt.PoisonPayload)
        with pytest.raises(ValueError, match="budget"):
            raise payload.error
        seen["meta"] = meta

    kt.pull_bundle(ep(server), timeout=2.0, ack_timeout=10.0,
                   receiver_factory=lambda m: RejectsContent(m), process=process)
    assert "receiver_error" in seen["meta"]
    assert wait_for(lambda: server.delivery_counts()[0] == 1)
    assert kt.pull_bundle(ep(server), timeout=0.2) is None  # consumed, no loop
    stream2, _ = stream_of([4], end)
    server.offer_stream({"id": "s2b"}, stream2)
    with pytest.raises(ValueError, match="budget"):
        kt.pull_bundle(ep(server), timeout=2.0, ack_timeout=10.0,
                       receiver_factory=lambda m: RejectsContent(m))
    assert wait_for(lambda: server.delivery_counts()[0] == 2)


def test_stream_checksum_mismatch_refused():
    lis = kt.socket.socket()
    lis.bind(("127.0.0.1", 0))
    lis.listen(1)
    port = lis.getsockname()[1]

    def evil_server():
        conn, _ = lis.accept()
        with conn:
            kt.recv_msg(conn)  # the pull op frame
            kt.send_msg(conn, {"id": "x", "stream": True})
            bufs, _ = kt.pack_payload({"k": np.zeros((1, 1, 2, 1, 1), np.float32)})
            kt.send_msg(conn, {"chunk": 0, "pos_range": [0, 2]}, bufs)
            kt.recv_msg(conn)  # chunk ack
            kt.send_msg(conn, {"end": True, "chunks": 1, "checksum": 12345})

    t = threading.Thread(target=evil_server, daemon=True)
    t.start()
    try:
        with pytest.raises(OSError, match="torn kv stream"):
            kt.pull_bundle(("127.0.0.1", port), timeout=2.0, ack_timeout=5.0)
    finally:
        lis.close()
        t.join(timeout=5)


def test_stream_producer_failure_drops_not_requeues(server):
    stream = kt.KVStream(4)
    server.offer_stream({"id": "s3"}, stream)
    stream.fail()
    with pytest.raises(OSError, match="failed at the sender"):
        kt.pull_bundle(ep(server), timeout=2.0, ack_timeout=10.0)
    assert kt.pull_bundle(ep(server), timeout=0.3) is None  # dropped, not queued


def test_bind_failure_closes_socket(server):
    created = []
    real_socket = kt.socket.socket

    def recording_socket(*args, **kwargs):
        s = real_socket(*args, **kwargs)
        created.append(s)
        return s

    kt.socket.socket = recording_socket
    try:
        with pytest.raises(OSError):
            kt.KVServer(port=server.port, host="127.0.0.1")
    finally:
        kt.socket.socket = real_socket
    assert len(created) == 1
    assert created[0].fileno() == -1, "failed bind leaked its socket"


# ---------------------------------------------------------------------------
# Cross-framework sockets: JAX server -> port client, port server -> JAX client


def bf16_rows(seed: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(torch.bfloat16)


def jax_host(t: torch.Tensor) -> np.ndarray:
    """The host array a JAX worker holds for the same bf16 tensor."""
    return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)


def raw_bytes(a) -> bytes:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8).tobytes()


def kv_arrays(seed: int, rows: int) -> dict:
    """A bf16 K/V slice [L, B, rows, Hkv, hd] with its prompt tokens."""
    return {"k": bf16_rows(seed, (2, 1, rows, 2, 8)), "v": bf16_rows(seed + 1, (2, 1, rows, 2, 8)),
            "tokens": torch.arange(rows, dtype=torch.int32)[None, :] + seed}


def as_sender(arrays: dict, sender) -> dict:
    """`arrays` as the sending framework holds them: the port sends torch
    tensors, JAX ml_dtypes/numpy host arrays."""
    if sender is kt:
        return arrays
    return {n: jax_host(a) if a.dtype == torch.bfloat16 else a.numpy() for n, a in arrays.items()}


def assert_same_arrays(got: dict, want: dict) -> None:
    assert set(want) <= set(got)
    for name, a in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(a.shape), name
        assert raw_bytes(g) == raw_bytes(a.numpy() if a.dtype != torch.bfloat16
                                         else a.view(torch.int16).numpy()), name
        if a.dtype == torch.bfloat16:
            assert g.dtype.name == "bfloat16" or kt.is_bfloat16(g), name


DIRECTIONS = {"jax_server_port_client": (jkt, kt), "port_server_jax_client": (kt, jkt)}


@pytest.fixture(params=list(DIRECTIONS))
def wire_pair(request):
    server_mod, client_mod = DIRECTIONS[request.param]
    s = server_mod.KVServer(port=0, host="127.0.0.1")
    yield server_mod, client_mod, s
    s.close()


def test_cross_framework_monolithic_bundle(wire_pair):
    server_mod, client_mod, s = wire_pair
    arrays = {"k": bf16_rows(0, (2, 1, 5, 2, 8)), "v": bf16_rows(1, (2, 1, 5, 2, 8)),
              "pos": torch.tensor(5, dtype=torch.int32), "token": torch.tensor([7], dtype=torch.int32)}
    s.offer_bundle({"id": "m1", "handoff": {"pos": 5}},
                   server_mod.arrays_to_bytes(**as_sender(arrays, server_mod)))
    seen = {}
    got = client_mod.pull_bundle(ep(s), timeout=2.0, ack_timeout=10.0,
                                 process=lambda m, p: seen.update(meta=m, arrays=client_mod
                                                                  .bytes_to_arrays(p)) or "ok")
    assert got == "ok" and seen["meta"]["id"] == "m1" and seen["meta"]["handoff"] == {"pos": 5}
    assert_same_arrays(seen["arrays"], arrays)
    assert wait_for(lambda: s.delivery_counts()[0] == 1)


def test_cross_framework_streamed_bundle(wire_pair):
    server_mod, client_mod, s = wire_pair
    chunks = [kv_arrays(10 * i, w) for i, w in enumerate([4, 4, 3])]
    stream = server_mod.KVStream(4)
    s.offer_stream({"id": "st1"}, stream)
    lo = 0
    for c in chunks:
        stream.put_chunk(lo, lo + c["k"].shape[2], as_sender(c, server_mod))
        lo += c["k"].shape[2]
    stream.finish({"handoff": {"streamed": True, "chunks": 3}},
                  {"token": np.asarray([3], np.int32), "pos": np.asarray(lo, np.int32)})
    meta, arrays = client_mod.pull_bundle(ep(s), timeout=2.0, ack_timeout=10.0)
    # The receiver verified the END frame's chunk count and crc32.
    assert meta["streamed"] and meta["chunks"] == 3 and meta["payload_bytes"] == stream.payload_bytes
    want = {n: torch.cat([c[n] for c in chunks], dim=2 if n != "tokens" else 1)
            for n in ("k", "v", "tokens")}
    assert_same_arrays(arrays, want)
    assert int(arrays["pos"]) == 11 and list(arrays["token"]) == [3]
    assert wait_for(lambda: s.delivery_counts()[0] == 1)


def test_cross_framework_result(wire_pair):
    server_mod, client_mod, s = wire_pair
    toks = np.arange(14, dtype=np.int32).reshape(2, 7)
    s.post_result("res1", {"id": "res1", "handoff": {"decode_s": 0.5}},
                  server_mod.arrays_to_bytes(tokens=toks))
    meta, payload = client_mod.pull_result(ep(s), "res1")
    assert meta == {"id": "res1", "handoff": {"decode_s": 0.5}}
    np.testing.assert_array_equal(client_mod.bytes_to_arrays(payload)["tokens"], toks)
    assert client_mod.pull_result(ep(s), "res1") is None


def test_cross_framework_prefix_fetch(wire_pair):
    server_mod, client_mod, s = wire_pair
    arena_mod = jarena if server_mod is jkt else tarena
    arena = arena_mod.KVHostArena(64 << 20)
    blocks = {bytes([i]) * 16: {"k": bf16_rows(i, (2, 16, 2, 8)), "v": bf16_rows(i + 50, (2, 16, 2, 8))}
              for i in range(3)}
    for d, arrays in blocks.items():
        assert arena.put(d, as_sender(arrays, server_mod))
    s.serve_prefixes(arena.get)
    d0, d1, d2 = blocks
    got = client_mod.fetch_prefix(ep(s), [d0, d1, d2])
    assert list(got) == [d0, d1, d2]
    for d in got:
        assert_same_arrays(got[d], blocks[d])
    assert list(client_mod.fetch_prefix(ep(s), [d0, b"\x77" * 16, d2])) == [d0]
    assert client_mod.fetch_prefix(ep(s), [b"\x55" * 16]) == {}


# ---------------------------------------------------------------------------
# pack_payload bytes, port vs JAX, with and without ml_dtypes


def wire_bytes(mod, arrays: dict) -> bytes:
    bufs, _ = mod.pack_payload(arrays)
    return b"".join(bytes(v) for v in bufs)


PACK_CASES = {
    "f32": lambda: torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0)),
    "int8": lambda: torch.randint(-127, 128, (2, 3, 4), dtype=torch.int8,
                                  generator=torch.Generator().manual_seed(1)),
    "int32": lambda: torch.arange(12, dtype=torch.int32).reshape(3, 4),
    "bf16": lambda: bf16_rows(2, (2, 3, 4)),
}


def streamed_chunk_rows(dtype: torch.dtype) -> tuple[torch.Tensor, np.ndarray]:
    """The dense engine's streamed-prefill producer: a tiny random model in
    `dtype`, one chunk of a 5-token prompt. Returns the cache rows the chunk
    holds (as the tensor) and the "k" array the engine emitted for them."""
    cfg = tl.LlamaConfig(vocab_size=32, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
                         d_ff=32, max_seq_len=16, dtype=dtype)
    engine = Engine(cfg, tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu"),
                    batch_size=1, max_len=8, device="cpu")
    out = []
    _, cache, _ = engine.prefill_chunked_stream(np.arange(1, 6, dtype=np.int32)[None], 8,
                                                emit=lambda lo, hi, a: out.append(a["k"]))
    return cache.k[:, :, :5], out[0]


@pytest.mark.parametrize("hide_ml_dtypes", [False, True])
@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_payload_bytes_equal_jax(case, hide_ml_dtypes, monkeypatch):
    t = PACK_CASES[case]()
    jax_bytes = wire_bytes(jkt, {"x": as_sender({"x": t}, jkt)["x"]})
    if hide_ml_dtypes:
        monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # `import ml_dtypes` now fails
    # The port's producers: a tensor, or host_array's copy of one.
    for value in (t, kt.host_array(t)):
        assert wire_bytes(kt, {"x": value}) == jax_bytes
    if case == "bf16":
        assert b'"bfloat16"' in jax_bytes and b'"uint16"' not in jax_bytes
        back = kt.bytes_to_arrays(jax_bytes)["x"]
        assert kt.is_bfloat16(back) and torch.equal(kt.to_tensor(back, torch.device("cpu")), t)
        # The engine's streamed chunks go out as JAX names the same rows.
        rows, emitted = streamed_chunk_rows(torch.bfloat16)
        want = wire_bytes(jkt, {"x": jax_host(rows)})
        assert wire_bytes(kt, {"x": emitted}) == want and b'"bfloat16"' in want


# ---------------------------------------------------------------------------
# The resilience copy against lws_tpu.core.resilience


class Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


RES = {"jax": jres, "port": tres}


def deadline_trace(mod) -> list:
    clock = Clock()
    d = mod.Deadline(2.5, clock=clock)
    out = [d.to_wire(), d.expired(), d.timeout(10.0), d.timeout(1.0)]
    clock.t += 1.0
    wire = d.to_wire()
    peer = mod.Deadline.from_wire(wire, clock=clock)
    out += [wire, peer.remaining(), mod.Deadline.from_wire(None), mod.Deadline.from_wire("x")]
    clock.t += 2.0
    out += [d.expired(), d.to_wire(), d.timeout(5.0), peer.expired()]
    with pytest.raises(mod.DeadlineExceeded):
        d.check("test.site")
    with mod.bind(d):
        with mod.bind(None):
            out += [mod.current() is d, mod.clamp_timeout(3.0)]
    out += [mod.current() is None, mod.clamp_timeout(3.0)]
    return out


def retry_trace(mod) -> list:
    sleeps, calls = [], []

    class Rng:
        def uniform(self, lo, hi):
            return (lo + hi) / 2

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    out = [mod.call(flaky, "s", mod.RetryPolicy(max_attempts=3, base_s=0.1, cap_s=1.0),
                    sleeper=sleeps.append, rng=Rng()), len(calls), sleeps]
    with pytest.raises(OSError):
        mod.call(lambda: (_ for _ in ()).throw(OSError("down")), "s",
                 mod.RetryPolicy(max_attempts=2), sleeper=lambda s: None, rng=Rng())
    with pytest.raises(ValueError):  # not in retry_on: no retry
        mod.call(lambda: (_ for _ in ()).throw(ValueError("poison")), "s",
                 sleeper=lambda s: None)
    return out


def breaker_trace(mod) -> list:
    clock = Clock()
    br = mod.CircuitBreaker("ep", failure_threshold=2, reset_timeout_s=5.0, clock=clock)
    out = [br.state, br.allow()]
    br.record_failure()
    out += [br.state, br.allow()]
    br.record_failure()
    out += [br.state, br.allow()]
    clock.t += 5.0
    out += [br.allow(), br.state, br.allow()]  # one half-open probe at a time
    br.record_failure()
    out += [br.state, br.allow()]
    clock.t += 5.0
    out += [br.allow(), br.state]
    br.record_success()
    out += [br.state, br.allow()]
    with pytest.raises(OSError):
        br.call(lambda: (_ for _ in ()).throw(OSError("x")))
    out += [br.state, br.call(lambda: 3), br.state]
    return out


def seen_trace(mod) -> list:
    seen = mod.SeenIds(capacity=3)
    out = [seen.seen("a"), seen.seen("b"), seen.seen("a"), seen.contains("c")]
    seen.record("c")
    seen.record("d")  # evicts "a", the oldest
    out += [len(seen), seen.contains("a"), seen.contains("b"), seen.seen("d"), seen.seen("a"),
            len(seen), seen.contains("b")]
    return out


def drain_trace(mod) -> list:
    gate = mod.DrainGate()
    out = [gate.draining, gate.request("test"), gate.draining, gate.reason]
    gate.reset()
    return out + [gate.draining, gate.reason]


def retry_deadline_trace(mod) -> list:
    """Retries under a bound deadline: each sleep is clamped to the budget
    left, and the attempt after it finds the budget gone."""
    clock, sleeps = Clock(), []

    def sleeper(dt):
        sleeps.append(dt)
        clock.t += dt

    class Rng:
        def uniform(self, lo, hi):
            return hi

    with mod.bind(mod.Deadline(0.5, clock=clock)):
        with pytest.raises(mod.DeadlineExceeded) as info:
            mod.call(lambda: (_ for _ in ()).throw(OSError("down")), "retry.site",
                     mod.RetryPolicy(max_attempts=4, base_s=0.2, cap_s=5.0),
                     sleeper=sleeper, rng=Rng())
    return [sleeps, info.value.site, round(info.value.overdue_s, 9)]


def breaker_probe_trace(mod) -> list:
    """A half-open probe that never reports frees its slot after one reset
    window; a non-transport error releases the probe without a verdict."""
    clock = Clock()
    br = mod.CircuitBreaker("ep", failure_threshold=1, reset_timeout_s=2.0, clock=clock)
    br.record_failure()
    clock.t += 2.0
    out = [br.state, br.allow(), br.allow()]
    clock.t += 2.0
    out += [br.allow(), br.state, br.allow()]
    clock.t += 2.0
    with pytest.raises(ValueError):
        br.call(lambda: (_ for _ in ()).throw(ValueError("poison")))
    out += [br.state, br.call(lambda: "ok"), br.state]
    return out


@pytest.mark.parametrize("trace", [deadline_trace, retry_trace, breaker_trace, seen_trace,
                                   drain_trace, retry_deadline_trace, breaker_probe_trace])
def test_resilience_copy_behaves_like_jax(trace, monkeypatch):
    monkeypatch.delenv(jres.DISABLE_ENV, raising=False)
    assert trace(tres) == trace(jres)
