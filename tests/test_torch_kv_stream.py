"""The port's disaggregated handoff (lws_tpu_torch/serving/kv_transport.py's
device seams and lws_tpu_torch/serving/disagg_worker.py's legs) held to the
JAX package's on the CPU, on one f32 model whose weights cross through
models/convert.py.

  * The port counterpart of each case of tests/test_kv_stream.py and of the
    bundle cases of tests/test_serving.py (bundle bytes follow the prompt
    length; the speculative decode leg; a too-small decode budget).
  * Cross-framework, each way and for both transfer shapes: a JAX prefill
    (Engine.prefill + cache_to_bundle, or the streamed _prefill_streamed
    over a socket) decoded by the port (bundle_to_cache or CacheAssembler,
    then decode_n, and decode_speculative), and a port prefill decoded by
    JAX. Greedy tokens must equal JAX's single-engine generate exactly.
  * Bundle bytes: given the same K/V rows (JAX's rows injected into the
    port's cache), the port's cache_to_bundle equals JAX's byte for byte in
    f32, bf16 and int8-with-scales. The rows each framework computes from
    the same weights differ in the last bits of their f32 sums, so computed
    bundles are held to JAX's within atol = rtol = 1e-5, with keys, shapes,
    dtypes, pos and token exact."""

import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lws_tpu.models import llama as jl
from lws_tpu.serving import disagg_worker as jdw
from lws_tpu.serving import kv_transport as jkt
from lws_tpu.serving.engine import Engine as JaxEngine
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving import kv_host_arena
from lws_tpu_torch.serving.disagg_worker import (
    _decode_bundle,
    _prefill_streamed,
    _serve_prefix_tier,
    kv_chunk_tokens,
    use_streaming,
)
from lws_tpu_torch.serving.engine import Engine
from tests.test_torch_kv_transport import jax_metrics_restored  # noqa: F401 — autouse

MAX_LEN = 48
STEPS = 6
TOL = 1e-5  # f32 K/V rows computed by the two frameworks
CPU = torch.device("cpu")


def tiny_cfg(**kw):
    """tests/test_kv_stream.py's model."""
    return jl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, max_seq_len=64, dtype=jnp.float32, remat=False, **kw)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_cfg()
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.asarray(jax.random.randint(jax.random.key(3), (21,), 0, 128), np.int32)


@pytest.fixture(scope="module")
def jax_engine(model):
    jcfg, jparams, _, _ = model
    return JaxEngine(jcfg, jparams, batch_size=1, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def oracle(jax_engine, prompt):
    """JAX's single-engine greedy stream: the first token and STEPS more."""
    return np.asarray(jax_engine.generate(jnp.asarray(prompt)[None], STEPS + 1).tokens)


def make_engine(model, max_len=MAX_LEN):
    _, _, tcfg, tparams = model
    return Engine(tcfg, tparams, batch_size=1, max_len=max_len, device="cpu")


def pull_in_thread(server_port, factory, mod=kt, **kw):
    """One decode-side pull run in a thread (the server delivers from a
    connection thread while the caller produces)."""
    out = {}

    def puller():
        out["got"] = mod.pull_bundle(("127.0.0.1", server_port), timeout=15.0,
                                     ack_timeout=60.0, receiver_factory=factory, **kw)

    t = threading.Thread(target=puller, daemon=True)
    t.start()
    return t, out


def port_assembler(m):
    return kt.CacheAssembler(max_len=MAX_LEN, device="cpu")


# ---------------------------------------------------------------------------
# Counterparts of tests/test_kv_stream.py


def test_streamed_handoff_byte_identical_to_monolithic_oracle(model, prompt):
    pre, dec_mono, dec_stream = make_engine(model), make_engine(model), make_engine(model)
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        token, cache = pre.prefill(prompt.reshape(1, -1))
        want, mono_stats, _ = _decode_bundle(dec_mono, kt.cache_to_bundle(cache, token),
                                             steps=STEPS)
        assert "streamed" not in mono_stats
        thread, out = pull_in_thread(server.port, port_assembler)
        _prefill_streamed(pre, server, {"id": "r1"}, "r1", prompt, 8, None)
        thread.join(timeout=60)
        meta, payload = out["got"]
        got, stats, _ = _decode_bundle(dec_stream, payload, steps=STEPS)
        np.testing.assert_array_equal(got, want)
        assert stats["streamed"] and stats["chunks"] == 3
        assert meta["handoff"]["bundle_bytes"] == meta["payload_bytes"] == stats["bundle_bytes"]
        assert meta["handoff"]["streamed"] and meta["handoff"]["chunks"] == 3
    finally:
        server.close()


def test_cache_assembler_matches_bundle_to_cache(model, prompt):
    pre, pre2 = make_engine(model), make_engine(model)
    tokens = prompt.reshape(1, -1)
    asm = kt.CacheAssembler(max_len=MAX_LEN, device="cpu")
    token_s, cache_s, stats = pre.prefill_chunked_stream(
        tokens, 8, emit=lambda lo, hi, a: asm.chunk({"pos_range": [lo, hi]}, a))
    asm.finish({}, {"token": token_s.numpy(), "pos": np.asarray(cache_s.pos, np.int32)})
    cache_a, token_a, pos, context = asm.take()
    token_c, cache_c = pre2.prefill_chunked(tokens, chunk_size=8)
    ref_cache, ref_token = kt.bundle_to_cache(kt.cache_to_bundle(cache_c, token_c),
                                              max_len=MAX_LEN, device="cpu")
    assert pos == len(prompt) == ref_cache.pos
    assert torch.equal(cache_a.k, ref_cache.k) and torch.equal(cache_a.v, ref_cache.v)
    assert torch.equal(token_a, ref_token)
    np.testing.assert_array_equal(context[0], prompt)
    assert stats["chunks"] == asm.chunks == 3


def test_host_assembly_path_matches_device_path(model, prompt):
    def run(engine, device):
        asm = kt.CacheAssembler(max_len=MAX_LEN, device=device)
        token, cache, _ = engine.prefill_chunked_stream(
            prompt.reshape(1, -1), 8, emit=lambda lo, hi, a: asm.chunk({"pos_range": [lo, hi]}, a))
        asm.finish({}, {"token": token.numpy(), "pos": np.asarray(cache.pos, np.int32)})
        return asm.take()

    cache_d, _, _, _ = run(make_engine(model), "cpu")
    cache_h, _, _, _ = run(make_engine(model), False)
    assert isinstance(cache_h.k, np.ndarray)
    np.testing.assert_array_equal(cache_d.k.numpy(), cache_h.k)
    np.testing.assert_array_equal(cache_d.v.numpy(), cache_h.v)


def test_streamed_spec_leg_seeds_history_and_stays_byte_identical(model, prompt):
    pre, dec_plain, dec_spec = make_engine(model), make_engine(model), make_engine(model)
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        token, cache = pre.prefill(prompt.reshape(1, -1))
        want, _, _ = _decode_bundle(dec_plain, kt.cache_to_bundle(cache, token), steps=STEPS)
        thread, out = pull_in_thread(server.port, port_assembler)
        _prefill_streamed(pre, server, {"id": "r2"}, "r2", prompt, 8, None)
        thread.join(timeout=60)
        _, payload = out["got"]
        assert payload._token_parts, "stream did not ship prompt tokens"
        got, stats, _ = _decode_bundle(dec_spec, payload, steps=STEPS, gamma=3, ngram=2)
        np.testing.assert_array_equal(got, want)
        assert stats["spec_gamma"] == 3 and stats["streamed"]
    finally:
        server.close()


def test_short_prompts_fall_back_to_single_shot():
    assert not use_streaming(prompt_len=5, chunk_tokens=256)
    assert not use_streaming(prompt_len=256, chunk_tokens=256)  # one chunk
    assert use_streaming(prompt_len=257, chunk_tokens=256)
    assert not use_streaming(prompt_len=10_000, chunk_tokens=0)
    assert not use_streaming(prompt_len=270, chunk_tokens=256, max_len=300)
    assert use_streaming(prompt_len=270, chunk_tokens=256, max_len=512)
    assert use_streaming(prompt_len=21, chunk_tokens=8, max_len=24)


def test_stream_fail_after_chunks_is_terminal():
    """A producer failure after chunks landed: every reader, at any
    position, gets the terminal verdict, and the stream takes no more."""
    stream = kt.KVStream(4)
    for lo in (0, 4, 8):
        stream.put_chunk(lo, lo + 4, {"k": np.zeros((1, 1, 4, 1, 1), np.float32)})
    kind, meta, _ = stream.read(1, timeout=0.1)
    assert kind == "chunk" and meta["chunk"] == 1 and meta["pos_range"] == [4, 8]
    assert stream.read(3, timeout=0.01)[0] == "timeout"
    stream.fail()
    assert stream.failed and stream.chunks == 3
    assert [stream.read(i, timeout=0.1)[0] for i in (0, 2, 3)] == ["failed"] * 3
    with pytest.raises(RuntimeError, match="finished"):
        stream.put_chunk(12, 16, {"k": np.zeros((1, 1, 4, 1, 1), np.float32)})


def test_kv_chunk_env_knob(monkeypatch):
    monkeypatch.setenv("LWS_TPU_KV_CHUNK", "0")
    assert kv_chunk_tokens() == 0
    monkeypatch.setenv("LWS_TPU_KV_CHUNK", "64")
    assert kv_chunk_tokens() == 64
    monkeypatch.delenv("LWS_TPU_KV_CHUNK")
    assert kv_chunk_tokens() == 256


def test_prefill_chunked_stream_serial_ring_matches(model, prompt):
    a, b = [], []
    tok_a, _, _ = make_engine(model).prefill_chunked_stream(
        prompt.reshape(1, -1), 8, emit=lambda lo, hi, ar: a.append((lo, hi, ar)))
    tok_b, _, _ = make_engine(model).prefill_chunked_stream(
        prompt.reshape(1, -1), 8, emit=lambda lo, hi, ar: b.append((lo, hi, ar)),
        ring_depth=0)
    assert [x[:2] for x in a] == [x[:2] for x in b] == [(0, 8), (8, 16), (16, 21)]
    assert int(tok_a[0]) == int(tok_b[0])
    for (_, _, ar_a), (_, _, ar_b) in zip(a, b):
        np.testing.assert_array_equal(ar_a["k"], ar_b["k"])


def test_assembler_rejects_rows_past_decode_budget():
    asm = kt.CacheAssembler(max_len=4, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        asm.chunk({"pos_range": [0, 8]}, {"k": np.zeros((2, 1, 8, 2, 3), np.float32)})


def test_streamed_poison_bundle_fails_request_not_worker(model, prompt):
    pre = make_engine(model)
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        results = {}

        def process(meta, payload):
            try:
                _decode_bundle(None, payload, steps=STEPS)
            except Exception as e:  # noqa: BLE001 — the worker's poison guard
                results[meta["id"]] = f"failed: {e!r}"
                return
            results[meta["id"]] = "decoded"

        thread, _ = pull_in_thread(server.port, lambda m: kt.CacheAssembler(max_len=8, device="cpu"),
                                   process=process)
        _prefill_streamed(pre, server, {"id": "poison"}, "poison", prompt, 8, None)
        thread.join(timeout=60)
        assert results.get("poison", "").startswith("failed:"), results
        assert "max_len" in results["poison"]
        deadline = time.time() + 5
        while server.delivery_counts()[0] < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert server.delivery_counts()[0] == 1
        assert kt.pull_bundle(("127.0.0.1", server.port), timeout=0.3) is None
    finally:
        server.close()


def test_serve_prefix_tier_advertises_the_port_and_serves_spilled_blocks():
    """A worker's KVServer joins the prefix tier: any live arena's spilled
    blocks are served over its port, the chain stopping at the first miss."""
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        _serve_prefix_tier(server)
        arena = kv_host_arena.KVHostArena(1 << 20)
        block = {"k": np.arange(24, dtype=np.float32).reshape(1, 4, 2, 3)}
        assert arena.put(b"\x42" * 16, block)
        got = kt.fetch_prefix(("127.0.0.1", server.port), [b"\x42" * 16, b"\x43" * 16])
        assert list(got) == [b"\x42" * 16]
        np.testing.assert_array_equal(got[b"\x42" * 16]["k"], block["k"])
    finally:
        server.close()


# ---------------------------------------------------------------------------
# Counterparts of tests/test_serving.py's bundle cases


def test_bundle_bytes_scale_with_prompt_length(model):
    engine = make_engine(model, max_len=64)

    def bundle_for(plen):
        prompt = np.asarray(jax.random.randint(jax.random.key(2), (1, plen), 0, 128), np.int32)
        token, cache = engine.prefill(prompt)
        return kt.cache_to_bundle(cache, token)

    b8, b32 = bundle_for(8), bundle_for(32)
    assert 2.5 * len(b8) < len(b32) < 6 * len(b8), (len(b8), len(b32))
    assert len(b8) < len(b32) * 2 / 4
    cache, token = kt.bundle_to_cache(b8, max_len=48, device="cpu")
    assert cache.k.shape[2] == 48 and cache.pos == 8
    tok2, _ = make_engine(model, max_len=48).decode(token, cache)
    assert tok2.shape == (1,)


def test_decode_bundle_speculative_leg_exact(model):
    engine = make_engine(model, max_len=64)
    token, cache = engine.prefill(np.asarray([[5, 9, 2, 11] * 4], np.int32))
    payload = kt.cache_to_bundle(cache, token)
    want, _, _ = _decode_bundle(engine, payload, steps=20)
    got, stats, _ = _decode_bundle(engine, payload, steps=20, gamma=4, ngram=3)
    np.testing.assert_array_equal(got, want)
    assert stats["spec_gamma"] == 4


def test_bundle_rejects_too_small_decode_budget(model):
    engine = make_engine(model, max_len=64)
    token, cache = engine.prefill(np.ones((1, 16), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        kt.bundle_to_cache(kt.cache_to_bundle(cache, token), max_len=8, device="cpu")


# ---------------------------------------------------------------------------
# Cross-framework handoffs: tokens equal JAX's single-engine generate


def jax_assembler(m):
    return jkt.CacheAssembler(max_len=MAX_LEN, device=True)


def handoff(src, model, jax_engine, prompt, streamed: bool):
    """One prefill on `src` ("jax" or "port") shipped over a real socket to
    the other framework's decode side; returns the received payload."""
    jax_side = src == "jax"
    mod = jkt if jax_side else kt
    server = mod.KVServer(port=0, host="127.0.0.1")
    try:
        if streamed:
            # The receiving side's assembler: the port's on the CPU device,
            # or JAX's device assembly.
            factory = port_assembler if jax_side else jax_assembler
            thread, out = pull_in_thread(server.port, factory, mod=kt if jax_side else jkt)
            if jax_side:
                jdw._prefill_streamed(jax_engine, server, jkt, {"id": "x"}, "x", prompt, 8, None)
            else:
                _prefill_streamed(make_engine(model), server, {"id": "x"}, "x", prompt, 8, None)
            thread.join(timeout=60)
            meta, payload = out["got"]
            assert meta["streamed"] and meta["chunks"] == 3
            return payload
        if jax_side:
            token, cache = jax_engine.prefill(jnp.asarray(prompt)[None])
            server.offer_bundle({"id": "x"}, jkt.cache_to_bundle(cache, token))
            _, payload = kt.pull_bundle(("127.0.0.1", server.port), timeout=5.0)
        else:
            token, cache = make_engine(model).prefill(prompt[None])
            server.offer_bundle({"id": "x"}, kt.cache_to_bundle(cache, token))
            _, payload = jkt.pull_bundle(("127.0.0.1", server.port), timeout=5.0)
        return payload
    finally:
        server.close()


@pytest.mark.parametrize("streamed", [False, True], ids=["monolithic", "streamed"])
@pytest.mark.parametrize("src", ["jax", "port"], ids=["jax_prefill_port_decode",
                                                     "port_prefill_jax_decode"])
def test_cross_framework_handoff_equals_single_engine_oracle(model, jax_engine, oracle, prompt,
                                                             src, streamed):
    for gamma in (0, 3):  # plain decode_n, then the speculative leg
        payload = handoff(src, model, jax_engine, prompt, streamed)
        if src == "jax":
            got, stats, _ = _decode_bundle(make_engine(model), payload, steps=STEPS, gamma=gamma,
                                           ngram=2)
        else:
            got, stats, _ = jdw._decode_bundle(jax_engine, payload, steps=STEPS, gamma=gamma,
                                               ngram=2)
        np.testing.assert_array_equal(np.asarray(got), oracle)
        assert stats.get("streamed", False) == streamed
        assert stats.get("spec_gamma", 0) == gamma


def jax_rows(cfg_name: str, rows: int, pos: int):
    """Random K/V rows (and scales) as a JAX KVCache holds them: [L, B, T,
    Hkv, hd] in f32, bf16, or int8 with f32 [L, B, T, Hkv] scales."""
    rng = np.random.default_rng(rows)
    shape = (2, 1, rows, 2, 16)
    if cfg_name == "int8":
        kv = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [rng.random(shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        dt = np.float32 if cfg_name == "f32" else ml_dtypes.bfloat16
        kv = [rng.standard_normal(shape).astype(np.float32).astype(dt) for _ in range(2)]
        scales = [None, None]
    jcache = jl.KVCache(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]), pos=jnp.asarray(pos, jnp.int32),
                        k_scale=None if scales[0] is None else jnp.asarray(scales[0]),
                        v_scale=None if scales[1] is None else jnp.asarray(scales[1]))
    return jcache, kv, scales


@pytest.mark.parametrize("cfg_name", ["f32", "bf16", "int8"])
def test_bundle_bytes_equal_jax_given_the_same_rows(cfg_name):
    jcache, kv, scales = jax_rows(cfg_name, rows=24, pos=13)

    def tensor(a):
        return None if a is None else kt.to_tensor(a, CPU)

    tcache = tl.KVCache(k=tensor(kv[0]), v=tensor(kv[1]), pos=13, k_scale=tensor(scales[0]),
                        v_scale=tensor(scales[1]))
    jtoken = jnp.asarray([42], jnp.int32)
    want = jkt.cache_to_bundle(jcache, jtoken)
    assert kt.cache_to_bundle(tcache, torch.tensor([42], dtype=torch.int32)) == want
    # And back: the port's seam restores JAX's rows exactly, padded to max_len.
    cache, token = kt.bundle_to_cache(want, max_len=32, device="cpu")
    assert cache.pos == 13 and token.tolist() == [42] and cache.k.shape[2] == 32
    assert torch.equal(cache.k[:, :, :13], tensor(kv[0][:, :, :13]))
    assert not cache.k[:, :, 13:].any()
    if scales[0] is not None:
        assert torch.equal(cache.v_scale[:, :, :13], tensor(scales[1][:, :, :13]))


def test_computed_bundles_match_jax_within_tolerance(model, jax_engine, prompt):
    """The rows each framework computes: monolithic bundles and streamed
    chunks, keys/shapes/dtypes/pos/token exact, K/V within TOL."""
    jtoken, jcache = jax_engine.prefill(jnp.asarray(prompt)[None])
    ttoken, tcache = make_engine(model).prefill(prompt[None])
    want = jkt.bytes_to_arrays(jkt.cache_to_bundle(jcache, jtoken))
    got = kt.bytes_to_arrays(kt.cache_to_bundle(tcache, ttoken))
    jchunks, tchunks = [], []
    jax_engine.prefill_chunked_stream(jnp.asarray(prompt)[None], 8,
                                      emit=lambda lo, hi, a: jchunks.append((lo, hi, a)))
    make_engine(model).prefill_chunked_stream(prompt[None], 8,
                                              emit=lambda lo, hi, a: tchunks.append((lo, hi, a)))
    pairs = [(got, want)] + [(t[2], j[2]) for t, j in zip(tchunks, jchunks)]
    assert [c[:2] for c in tchunks] == [c[:2] for c in jchunks]
    for g, w in pairs:
        assert list(g) == list(w)
        for name in w:
            assert g[name].shape == w[name].shape and g[name].dtype == w[name].dtype, name
            if name in ("k", "v"):
                np.testing.assert_allclose(g[name], w[name], rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(g[name], w[name])
