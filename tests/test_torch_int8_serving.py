"""int8 serving of the port held to the JAX package on the CPU: the f32
flagship "smoke" config with int8 weights (quantize_params) and an int8 KV
cache (kv_quant=True), the same converted weights and prompts through
lws_tpu and lws_tpu_torch.

Logits agree to f32 summation-order noise (1e-4, as tests/test_torch_model.py).
Cache int8 values are equal, or differ by 1 only where JAX's unquantized
value sits within 1e-4 of a rounding tie (the two frameworks' f32 K/V differ
in the last bits, which moves a value across a tie); scales agree to 2e-5.
Greedy streams must be token-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import flagship as jflagship
from lws_tpu.models import llama as jl
from lws_tpu.models.quant import quantize_params as jax_quantize_params
from lws_tpu.serving import Engine as JaxEngine
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

LOGIT_TOL = 1e-4
SCALE_TOL = 2e-5
TIE_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """(jcfg, jax int8 params, port cfg, port model) for the int8-KV smoke config."""
    jcfg = jflagship.flagship_config("smoke", kv_quant=True)
    jparams = jax.jit(lambda: jax_quantize_params(jl.init_params(jcfg, jax.random.key(0))))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def assert_int8_close(got_q, got_s, want_q, want_s, raw):
    """Port int8 values/scales against JAX's; `raw` is JAX's unquantized
    f32 tensor, whose distance to a rounding tie excuses a 1-off value."""
    np.testing.assert_allclose(got_s, want_s, rtol=SCALE_TOL, atol=0)
    diff = got_q.astype(np.int32) - want_q.astype(np.int32)
    off = diff != 0
    assert np.abs(diff).max(initial=0) <= 1
    if off.any():
        x = np.asarray(raw, np.float32) / np.maximum(np.asarray(want_s), 1e-30)[..., None]
        tie_dist = np.abs(np.abs(x - np.floor(x)) - 0.5)
        assert (tie_dist[off] < TIE_TOL).all(), tie_dist[off]


def jax_raw_kv(jcfg, jparams, tokens, bucket):
    """JAX's unquantized prefill K/V (the same forward with a bf16-style
    cache in the compute dtype)."""
    plain = dataclasses.replace(jcfg, kv_quant=False)
    _, cache = jl.forward_prefill(jparams, jnp.asarray(tokens), jl.init_cache(plain, 1, bucket),
                                  plain)
    return np.asarray(cache.k), np.asarray(cache.v)


@pytest.mark.parametrize("plen,bucket", [(16, 16), (13, 32)])
def test_quantized_prefill_matches_jax(model, plen, bucket):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(plen)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :plen] = rng.integers(1, jcfg.vocab_size, plen)
    jlogits, jcache = jax.jit(
        lambda p, tok: jl.forward_prefill(p, tok, jl.init_cache(jcfg, 1, bucket), jcfg,
                                          last_pos=plen - 1)
    )(jparams, jnp.asarray(tokens))
    tcache = tl.init_cache(tcfg, 1, bucket, "cpu")
    assert tcache.k.dtype == torch.int8 and tcache.k_scale.shape == (4, 1, bucket, 2)
    tlogits, tcache = tl.forward_prefill(tparams, t(tokens), tcache, last_pos=plen - 1)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    raw_k, raw_v = jax_raw_kv(jcfg, jparams, tokens, bucket)
    assert_int8_close(tcache.k.numpy(), tcache.k_scale.numpy(), np.asarray(jcache.k),
                      np.asarray(jcache.k_scale), raw_k)
    assert_int8_close(tcache.v.numpy(), tcache.v_scale.numpy(), np.asarray(jcache.v),
                      np.asarray(jcache.v_scale), raw_v)
    assert tcache.pos == int(jcache.pos) == plen


def _prefilled_pools(model, block_ids, bucket, num_blocks, bs):
    jcfg, jparams, tcfg, tparams = model
    tokens = np.random.default_rng(5).integers(1, jcfg.vocab_size, (1, bucket)).astype(np.int32)
    _, jcache = jl.forward_prefill(jparams, jnp.asarray(tokens), jl.init_cache(jcfg, 1, bucket), jcfg)
    _, tcache = tl.forward_prefill(tparams, t(tokens), tl.init_cache(tcfg, 1, bucket, "cpu"))
    jpool = jl.paged_insert(jl.init_paged_cache(jcfg, num_blocks, bs), jcache.k[:, 0],
                            jcache.v[:, 0], jnp.asarray(block_ids),
                            jcache.k_scale[:, 0], jcache.v_scale[:, 0])
    tpool = tl.paged_insert(tl.init_paged_cache(tcfg, num_blocks, bs, "cpu"), tcache.k[:, 0],
                            tcache.v[:, 0], t(block_ids), tcache.k_scale[:, 0],
                            tcache.v_scale[:, 0])
    raw_k, raw_v = jax_raw_kv(jcfg, jparams, tokens, bucket)
    return jpool, tpool, tokens, (raw_k, raw_v)


def test_quantized_paged_insert_requires_scales_and_matches_jax(model):
    _, _, tcfg, _ = model
    with pytest.raises(ValueError, match="k_scale/v_scale"):
        tl.paged_insert(tl.init_paged_cache(tcfg, 3, 8, "cpu"), torch.zeros(4, 8, 2, 16),
                        torch.zeros(4, 8, 2, 16), torch.tensor([1]))
    block_ids = np.array([5, 2, 7, 1], np.int32)
    jpool, tpool, _, (raw_k, _) = _prefilled_pools(model, block_ids, 32, 9, 8)
    raw = np.zeros(np.asarray(jpool.k).shape, np.float32)
    raw[:, block_ids] = raw_k[:, 0].reshape(raw_k.shape[0], 4, 8, *raw_k.shape[3:])
    assert_int8_close(tpool.k.numpy(), tpool.k_scale.numpy(), np.asarray(jpool.k),
                      np.asarray(jpool.k_scale), raw)
    untouched = [0, 3, 4, 6, 8]
    assert not tpool.k[:, untouched].any() and not tpool.k_scale[:, untouched].any()


@pytest.mark.parametrize("jax_path", ["gather", "pallas_interpret"])
def test_quantized_paged_decode_step_matches_jax(model, jax_path, monkeypatch):
    """One decode step over two slots (one appending past its prefilled
    bucket, one released to the null row) over the int8 pool, against
    JAX's gather + dequant path and its Pallas kernel's int8 branch."""
    jcfg, jparams, tcfg, tparams = model
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret" if jax_path == "pallas_interpret" else "0")
    bs, num_blocks = 8, 12
    jpool, tpool, _, _ = _prefilled_pools(model, np.array([3, 9, 4, 1], np.int32), 32,
                                          num_blocks, bs)
    table = np.array([[3, 9, 4, 1, 6, 0], [0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.array([32, 11], np.int32)
    tokens = np.array([17, 5], np.int32)
    jlogits, jpool = jl.forward_decode_paged(jparams, jnp.asarray(tokens), jpool,
                                             jnp.asarray(table), jnp.asarray(pos), jcfg)
    tlogits, tpool = tl.forward_decode_paged(tparams, t(tokens), tpool, t(table), t(pos))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # The written row (block 6, offset 0 for slot 0): at most 1 off, scales close.
    np.testing.assert_allclose(tpool.k_scale.numpy(), np.asarray(jpool.k_scale), rtol=SCALE_TOL)
    np.testing.assert_allclose(tpool.v_scale.numpy(), np.asarray(jpool.v_scale), rtol=SCALE_TOL)
    for got, want in ((tpool.k, jpool.k), (tpool.v, jpool.v)):
        assert np.abs(got.numpy().astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_forward_with_cache_on_int8_cache_matches_jax(model):
    """A prompt appended to an int8 dense cache, then two single-token
    steps (the int8 decode kernel's plain version here)."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(8)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jcache, tcache = jl.init_cache(jcfg, 2, 32), tl.init_cache(tcfg, 2, 32, "cpu")
    steps = [tokens, tokens[:, -1:] + 1, tokens[:, -1:] + 2]
    for chunk in steps:
        jlogits, jcache = jl.forward_with_cache(jparams, jnp.asarray(chunk), jcache, jcfg)
        tlogits, tcache = tl.forward_with_cache(tparams, t(chunk), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    assert tcache.pos == int(jcache.pos) == 11
    np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jcache.k_scale), rtol=SCALE_TOL)


def prompts(n, rng=3, vocab=512):
    r = np.random.RandomState(rng)
    return [r.randint(1, vocab - 1, size=r.randint(4, 40)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("jax_path", ["interpret", "xla"])
def test_paged_engine_int8_streams_match_jax(model, jax_path, monkeypatch):
    """PagedBatchEngine with int8 weights and an int8 pool: greedy streams
    token-identical to the JAX engine, on its Pallas kernel (interpret) and
    on its XLA gather path."""
    jcfg, jparams, tcfg, tparams = model
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret" if jax_path == "interpret" else "0")
    kw = dict(slots=4, max_len=96, block_size=16)
    jax_eng = JaxPagedBatchEngine(jcfg, jparams, **kw)
    eng = PagedBatchEngine(tcfg, tparams, device="cpu", **kw)
    assert eng.cache.k.dtype == torch.int8 and eng.cache.k_scale is not None
    ps = prompts(4)
    ids_j = [jax_eng.submit(p, max_new_tokens=12) for p in ps]
    ids_t = [eng.submit(p, max_new_tokens=12) for p in ps]
    jax_eng.run_until_drained()
    eng.run_until_drained()
    got = [eng.result(i) for i in ids_t]
    assert got == [jax_eng.result(i) for i in ids_j]
    assert all(len(r) == 12 for r in got)
    assert eng.pool_accounting() == jax_eng.pool_accounting() == {
        "free": eng.num_blocks - 1, "parked": 0, "live": 0, "total": eng.num_blocks - 1}


def test_paged_engine_int8_staggered_admission_matches_jax(model, monkeypatch):
    """A third request reuses int8 blocks (and scales) released by the first
    while the second keeps decoding."""
    jcfg, jparams, tcfg, tparams = model
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")
    ps = prompts(3, rng=7)

    def run(engine):
        a = engine.submit(ps[0], max_new_tokens=4)
        b = engine.submit(ps[1], max_new_tokens=20)
        third = None
        for _ in range(200):
            engine.step()
            if third is None and engine.active_count < 2:
                third = engine.submit(ps[2], max_new_tokens=10)
                assert third is not None
            if engine.active_count == 0 and third is not None:
                break
        return [engine.result(a), engine.result(b), engine.result(third)]

    kw = dict(slots=2, max_len=64, block_size=16, num_blocks=2 * 4 + 1)
    assert run(PagedBatchEngine(tcfg, tparams, device="cpu", **kw)) == \
        run(JaxPagedBatchEngine(jcfg, jparams, **kw))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_dense_engine_generate_matches_jax(model, kv_quant):
    """Engine.generate with int8 weights, over a bf16-style (f32 here) and an
    int8 KV cache: greedy tokens identical to the JAX Engine's, across a
    full DECODE_CHUNK chunk and single-step remainder."""
    jcfg, jparams, _, _ = model
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    tcfg = config_from_jax(jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    prompt = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = JaxEngine(jcfg, jparams, batch_size=2, max_len=64).generate(jnp.asarray(prompt), 36)
    eng = Engine(tcfg, tparams, batch_size=2, max_len=64, device="cpu")
    got = eng.generate(prompt, 36)
    assert eng.new_cache().k.dtype == (torch.int8 if kv_quant else torch.float32)
    assert got.tokens.shape == (2, 36) and got.decode_steps == 35
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.ttft_s > 0 and got.decode_tokens_per_s > 0


def test_decode_n_equals_chained_decode(model):
    """tests/test_quant.py:98-124 on the port: decode_n and single decode
    steps give the same greedy tokens on int8 weights with int8 KV."""
    _, _, tcfg, tparams = model
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    eng = Engine(tcfg, tparams, batch_size=2, max_len=32, device="cpu")
    tok, cache = eng.prefill(prompt)
    tok_n, cache_n, toks = eng.decode_n(tok, cache, 4)
    assert toks.shape == (2, 4) and cache_n.pos == 8 + 4
    tok2, cache2 = eng.prefill(prompt)
    torch.testing.assert_close(tok2, tok, rtol=0, atol=0)
    singles = []
    for _ in range(4):
        tok2, cache2 = eng.decode(tok2, cache2)
        singles.append(tok2)
    torch.testing.assert_close(torch.stack(singles, dim=1), toks, rtol=0, atol=0)
    torch.testing.assert_close(tok_n, toks[:, -1], rtol=0, atol=0)


def test_dense_engine_refuses_missing_gpu_and_a_full_cache(model):
    _, _, tcfg, tparams = model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(tcfg, tparams)
    eng = Engine(tcfg, tparams, batch_size=1, max_len=10, device="cpu")
    tok, cache = eng.prefill(np.arange(1, 10, dtype=np.int32)[None])
    tok, cache = eng.decode(tok, cache)
    with pytest.raises(ValueError, match="cache full"):
        eng.decode(tok, cache)
