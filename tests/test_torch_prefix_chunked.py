"""The port's PagedBatchEngine with prefix caching and chunked-prefill
admission (lws_tpu_torch/serving/paged_engine.py) held to the JAX engine on
the CPU, case by case after tests/test_prefix_cache.py and
tests/test_chunked_admission.py; their TP-mesh cases run in
tests/test_torch_tp_serving.py's world-2 spawn.

Both engines run the same converted f32 weights and prompts, the JAX one on
its Pallas paged kernel in interpret mode (as tests/test_torch_paged_engine.py
runs it). Greedy streams must be token-identical to JAX's and to the port's
own uncached, unchunked engine; prefix statistics, chunked-admission counts
and pool accounting must equal JAX's at the same quiescent points. Sampled
cases are held inside the port (the frameworks' generators differ). The
model functions these modes add are held to JAX's at f32 summation-order
tolerance (logits and hidden states 1e-4, K/V 2e-5, as
tests/test_torch_model.py)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import llama as jl
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

TOL = 2e-5
LOGIT_TOL = 1e-4


def build(jcfg):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def tiny(vocab, max_seq_len, **kw):
    return jl.LlamaConfig(vocab_size=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, max_seq_len=max_seq_len, dtype=jnp.float32,
                          param_dtype=jnp.float32, remat=False, **kw)


@pytest.fixture(scope="module")
def pmodel():
    """tests/test_prefix_cache.py's model."""
    return build(tiny(128, 64))


@pytest.fixture(scope="module")
def cmodel():
    """tests/test_chunked_admission.py's model."""
    return build(tiny(256, 256))


def int8_kv(model):
    """The same weights under kv_quant=True (the port needs its own module:
    params.cfg must equal the engine's cfg)."""
    jcfg, jparams, tcfg, tparams = model
    tq = tl.Llama(dataclasses.replace(tcfg, kv_quant=True), "cpu")
    tq.load_state_dict(tparams.state_dict())
    return dataclasses.replace(jcfg, kv_quant=True), jparams, tq.cfg, tq


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")


def jax_engine(model, **kw):
    jcfg, jparams, _, _ = model
    return JaxPagedBatchEngine(jcfg, jparams, **kw)


def port_engine(model, **kw):
    _, _, tcfg, tparams = model
    return PagedBatchEngine(tcfg, tparams, device="cpu", **kw)


def assert_same_state(jeng, teng):
    """Prefix statistics, chunked-admission counts and pool accounting of
    the port's engine equal the JAX engine's."""
    for k in ("hit_tokens", "hit_blocks", "evictions"):
        assert teng.stats_prefix[k] == jeng.stats_prefix[k], k
    for k in ("chunked_admissions", "interleaved_decode_steps"):
        assert teng.stats[k] == jeng.stats.get(k, 0), k
    assert teng.pool_accounting() == jeng.pool_accounting()


def drain(engine, prompts, n, between=0):
    rids = []
    for p in prompts:
        rids.append(engine.submit(p, max_new_tokens=n))
        assert rids[-1] is not None
        if between:
            engine.step_n(between)
    engine.run_until_drained()
    return [engine.result(r) for r in rids]


# ---------------------------------------------------------------------------
# Prefix caching (tests/test_prefix_cache.py)

SYS = np.arange(1, 17, dtype=np.int32)  # 16 tokens = 2 full 8-blocks
PROMPT_X = np.concatenate([SYS, [40, 41, 42]]).astype(np.int32)
PROMPT_Y = np.concatenate([SYS, [50, 51]]).astype(np.int32)
PROMPT_Z = np.full((10,), 9, np.int32)  # no shared prefix
P24 = np.arange(1, 25, dtype=np.int32)
P16 = np.arange(1, 17, dtype=np.int32)
PREFIX_KW = dict(slots=3, max_len=64, block_size=8)


@pytest.mark.parametrize("prompts,hit_blocks", [
    ([PROMPT_X, PROMPT_Y, PROMPT_Z], 2),  # Y hits X's system prompt, Z nothing
    ([P24, P24], 2),  # a repeat hits every shareable block: (24-1)//8
    ([P16, P16], 1),  # a block-aligned prompt keeps its last block uncached
], ids=["shared_prefix", "repeat_prompt", "block_aligned"])
def test_prefix_streams_and_stats_match_jax(pmodel, jax_kernel, prompts, hit_blocks):
    jeng = jax_engine(pmodel, prefix_cache=True, **PREFIX_KW)
    teng = port_engine(pmodel, prefix_cache=True, **PREFIX_KW)
    want = drain(jeng, prompts, 6)
    assert drain(teng, prompts, 6) == want
    assert drain(port_engine(pmodel, **PREFIX_KW), prompts, 6) == want
    assert teng.stats_prefix["hit_blocks"] == hit_blocks
    assert teng.stats_prefix["hit_tokens"] == 8 * hit_blocks
    assert_same_state(jeng, teng)


def test_parked_prefix_survives_release_and_matches_jax(pmodel, jax_kernel):
    """Sequential sharers: the first request's prefix blocks park at
    refcount 0 and the second still hits them."""

    def run(engine):
        a = engine.submit(PROMPT_X, max_new_tokens=4)
        engine.run_until_drained()
        hits = [engine.stats_prefix["hit_tokens"]]
        b = engine.submit(PROMPT_Y, max_new_tokens=4)
        engine.run_until_drained()
        return [engine.result(a), engine.result(b)], hits + [engine.stats_prefix["hit_tokens"]]

    kw = dict(slots=1, max_len=64, block_size=8)
    jeng = jax_engine(pmodel, prefix_cache=True, **kw)
    teng = port_engine(pmodel, prefix_cache=True, **kw)
    want, want_hits = run(jeng)
    got, hits = run(teng)
    assert got == want and hits == want_hits == [0, 16]
    assert run(port_engine(pmodel, **kw))[0] == want
    assert teng.pool_accounting()["parked"] > 0
    assert_same_state(jeng, teng)


def test_eviction_under_pool_pressure_matches_jax(pmodel, jax_kernel):
    """9 usable blocks: every distinct 25-token prompt takes 4 and parks 3,
    so the third distinct prompt evicts; later results stay exact and every
    block is accounted for once."""
    prompts = [np.arange(60 + 30 * i, 85 + 30 * i, dtype=np.int32) % 127 + 1 for i in range(4)]
    prompts.append(np.concatenate([SYS, [40, 41]]).astype(np.int32))
    kw = dict(slots=1, max_len=64, block_size=8)
    jeng = jax_engine(pmodel, num_blocks=10, prefix_cache=True, **kw)
    teng = port_engine(pmodel, num_blocks=10, prefix_cache=True, **kw)
    ref = port_engine(pmodel, **kw)
    for p in prompts:
        got = drain(teng, [p], 4)
        assert got == drain(jeng, [p], 4) == drain(ref, [p], 4), p
        assert_same_state(jeng, teng)
    assert teng.stats_prefix["evictions"] > 0
    accounted = set(teng._free_blocks) | set(teng._lru)
    assert len(teng._free_blocks) + len(teng._lru) == len(accounted) == teng.num_blocks - 1


def test_concurrent_sharers_refcount_matches_jax(pmodel, jax_kernel):
    """Two active requests share the prefix blocks; they stay pinned until
    both finish, then park at refcount 0."""

    def run(engine):
        a = engine.submit(PROMPT_X, max_new_tokens=12)
        b = engine.submit(PROMPT_Y, max_new_tokens=4)
        shared = sorted(blk for blk, r in engine._block_refs.items() if r >= 2)
        engine.run_until_drained()
        assert len(shared) == 2 and all(engine._block_refs[s] == 0 for s in shared)
        assert all(s in engine._lru for s in shared)
        return [engine.result(a), engine.result(b)], shared

    kw = dict(slots=2, max_len=64, block_size=8)
    jeng = jax_engine(pmodel, prefix_cache=True, **kw)
    teng = port_engine(pmodel, prefix_cache=True, **kw)
    got = run(teng)
    assert got == run(jeng)
    ref = port_engine(pmodel, **kw)
    assert drain(ref, [PROMPT_X], 12) + drain(ref, [PROMPT_Y], 4) == got[0]
    assert_same_state(jeng, teng)


def test_prefix_cache_with_int8_kv_matches_jax(pmodel, jax_kernel):
    model = int8_kv(pmodel)
    jeng = jax_engine(model, prefix_cache=True, **PREFIX_KW)
    teng = port_engine(model, prefix_cache=True, **PREFIX_KW)
    want = drain(jeng, [PROMPT_X, PROMPT_Y], 6)
    assert drain(teng, [PROMPT_X, PROMPT_Y], 6) == want
    assert drain(port_engine(model, **PREFIX_KW), [PROMPT_X, PROMPT_Y], 6) == want
    assert teng.stats_prefix["hit_tokens"] == 16
    assert_same_state(jeng, teng)


def test_prefix_cache_with_seeded_sampling(pmodel):
    """A seeded sampled request admitted over a cached prefix gives the
    same tokens as without the cache (inside the port)."""

    def go(prefix_cache):
        eng = port_engine(pmodel, slots=2, max_len=64, block_size=8, prefix_cache=prefix_cache)
        drain(eng, [PROMPT_X], 4)  # warms the prefix map
        r = eng.submit(PROMPT_Y, max_new_tokens=8, temperature=1.0, seed=5)
        eng.run_until_drained()
        return eng.result(r), eng.stats_prefix["hit_tokens"]

    cached, hits = go(True)
    assert hits == 16
    assert cached == go(False)[0]


def test_backpressure_with_parked_hits_rolls_back_like_jax(pmodel, jax_kernel):
    """Parked hit blocks are not extra capacity: when pinning them leaves too
    few blocks, submit returns None with the pins rolled back, and succeeds
    once capacity frees."""
    pa = np.arange(60, 85, dtype=np.int32)  # 4 blocks, parks 3 on release

    def run(engine):
        a = engine.submit(pa, max_new_tokens=4)
        engine.run_until_drained()
        assert a is not None and len(engine._lru) == 3
        b = engine.submit(np.arange(2, 27, dtype=np.int32), max_new_tokens=20)
        assert b is not None
        assert engine.submit(pa, max_new_tokens=4) is None  # hits 3, needs 1: none left
        assert sorted(engine._block_refs[blk] for blk in engine._lru) == [0, 0, 0]
        acct = engine.pool_accounting()
        engine.run_until_drained()
        c = engine.submit(pa, max_new_tokens=4)
        assert c is not None
        engine.run_until_drained()
        return [engine.result(i) for i in (a, b, c)], acct

    kw = dict(slots=2, max_len=64, block_size=8, num_blocks=10, prefix_cache=True)
    jeng, teng = jax_engine(pmodel, **kw), port_engine(pmodel, **kw)
    got = run(teng)
    assert got == run(jeng)
    assert drain(port_engine(pmodel, slots=1, max_len=64, block_size=8), [pa], 4)[0] == got[0][2]
    assert_same_state(jeng, teng)


# ---------------------------------------------------------------------------
# Chunked-prefill admission (tests/test_chunked_admission.py)

CHUNK_KW = dict(slots=4, max_len=256, block_size=16)


def test_active_slots_progress_during_long_admission_like_jax(cmodel, jax_kernel):
    """70 tokens in chunks of 16: 5 chunks, 4 gaps of 2 decode steps for the
    active slot; the unchunked engine stalls it for the whole prefill."""
    rng = np.random.RandomState(0)
    short = rng.randint(1, 200, size=10).astype(np.int32)
    long_prompt = rng.randint(1, 200, size=70).astype(np.int32)

    def run(engine):
        ra = engine.submit(short, max_new_tokens=60)
        engine.step_n(4)
        req = next(r for r in engine._active.values() if r.request_id == ra)
        before = len(req.tokens)
        rb = engine.submit(long_prompt, max_new_tokens=8)
        progress = len(req.tokens) - before
        engine.run_until_drained()
        return [engine.result(ra), engine.result(rb)], progress

    kw = dict(prefill_chunk=16, interleave_steps=2, **CHUNK_KW)
    jeng, teng = jax_engine(cmodel, **kw), port_engine(cmodel, **kw)
    got, progress = run(teng)
    assert (got, progress) == run(jeng)
    assert progress == 8
    assert teng.stats["chunked_admissions"] == 1 and teng.stats["interleaved_decode_steps"] == 8
    plain, stalled = run(port_engine(cmodel, **CHUNK_KW))
    assert plain == got and stalled == 0
    assert_same_state(jeng, teng)


def test_chunked_streams_match_jax_and_unchunked(cmodel, jax_kernel):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 200, size=n).astype(np.int32) for n in (10, 70, 33, 64)]
    kw = dict(prefill_chunk=16, interleave_steps=2, **CHUNK_KW)
    jeng, teng = jax_engine(cmodel, **kw), port_engine(cmodel, **kw)
    got = drain(teng, prompts, 16, between=3)
    assert got == drain(jeng, prompts, 16, between=3)
    assert got == drain(port_engine(cmodel, **CHUNK_KW), prompts, 16, between=3)
    assert teng.stats["chunked_admissions"] == 3
    assert_same_state(jeng, teng)


def test_chunked_with_prefix_cache_long_suffix_matches_jax(cmodel, jax_kernel):
    """A shared 64-token prefix with 40-token suffixes (longer than a chunk,
    so the hit route chunks too) and a miss admission, against the JAX
    engine and the port's unchunked prefix-cache engine."""
    rng = np.random.RandomState(1)
    base = rng.randint(1, 200, size=64).astype(np.int32)
    prompts = [np.concatenate([base, rng.randint(1, 200, size=40).astype(np.int32)])
               for _ in range(3)]
    kw = dict(prefix_cache=True, **CHUNK_KW)
    jeng = jax_engine(cmodel, prefill_chunk=16, interleave_steps=2, **kw)
    teng = port_engine(cmodel, prefill_chunk=16, interleave_steps=2, **kw)
    got = drain(teng, prompts, 12, between=2)
    assert got == drain(jeng, prompts, 12, between=2)
    ref = port_engine(cmodel, **kw)
    assert got == drain(ref, prompts, 12, between=2)
    assert teng.stats_prefix["hit_tokens"] == ref.stats_prefix["hit_tokens"] == 128
    assert teng.stats["chunked_admissions"] == 3
    assert_same_state(jeng, teng)


def test_chunked_int8_kv_matches_jax(cmodel, jax_kernel):
    model = int8_kv(cmodel)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 200, size=n).astype(np.int32) for n in (50, 70)]
    kw = dict(slots=2, max_len=256, block_size=16)
    jeng = jax_engine(model, prefill_chunk=16, interleave_steps=2, **kw)
    teng = port_engine(model, prefill_chunk=16, interleave_steps=2, **kw)
    got = drain(teng, prompts, 10)
    assert got == drain(jeng, prompts, 10) == drain(port_engine(model, **kw), prompts, 10)
    assert teng.stats["chunked_admissions"] == 2
    assert_same_state(jeng, teng)


def test_non_pow2_max_len_bucket_cap_matches_jax(cmodel, jax_kernel):
    """max_len 384 caps a 300-token prompt's bucket below a power of two, so
    n_chunks * chunk (512) exceeds it: the chunk cache must be wider than
    the bucket."""
    prompt = np.random.RandomState(5).randint(1, 200, size=300).astype(np.int32)
    kw = dict(slots=2, max_len=384, block_size=16)
    jeng = jax_engine(cmodel, prefill_chunk=256, interleave_steps=2, **kw)
    teng = port_engine(cmodel, prefill_chunk=256, interleave_steps=2, **kw)
    got = drain(teng, [prompt], 10)
    assert got == drain(jeng, [prompt], 10) == drain(port_engine(cmodel, **kw), [prompt], 10)
    assert teng.stats["chunked_admissions"] == 1
    assert_same_state(jeng, teng)


def test_mode_validation_matches_jax(cmodel):
    for bad in (24, 8):  # not a power of two; below the block size
        with pytest.raises(ValueError, match="prefill_chunk"):
            port_engine(cmodel, block_size=16, prefill_chunk=bad)
    with pytest.raises(ValueError, match="spec_history"):
        port_engine(cmodel, spec_history=1)


# ---------------------------------------------------------------------------
# Model functions and the digest chain


def test_block_digests_equal_jax_bytes():
    rng = np.random.RandomState(7)
    for bs in (8, 16):
        prompt = rng.randint(0, 50000, size=5 * bs + 3).astype(np.int32)
        eng = types.SimpleNamespace(block_size=bs)
        want = JaxPagedBatchEngine._block_digests(eng, prompt, 5)
        got = PagedBatchEngine._block_digests(eng, prompt, 5)
        assert got == want and len(set(got)) == 5
        # The chain binds position: the same block later in a prompt differs.
        again = PagedBatchEngine._block_digests(eng, np.concatenate([prompt[:bs]] * 2), 2)
        assert again[0] == got[0] and again[1] != got[0]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_prefill_chunk_matches_jax(cmodel, kv_quant):
    """Three chunks of 16 appended from position 8 of a 64-row cache: the
    normalized hidden states and the K/V against JAX's."""
    jcfg, jparams, tcfg, tparams = int8_kv(cmodel) if kv_quant else cmodel
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (1, 56)).astype(np.int32)
    jcache = jl.init_cache(jcfg, 1, 64)
    tcache = tl.init_cache(tcfg, 1, 64, "cpu")
    jcache = dataclasses.replace(jcache, pos=jnp.asarray(8, jnp.int32))
    tcache.pos = 8
    chunk_fn = jax.jit(lambda p, t, c: jl.forward_prefill_chunk(p, t, c, jcfg))
    for i in range(3):
        chunk = tokens[:, 8 + 16 * i: 24 + 16 * i]
        jh, jcache = chunk_fn(jparams, jnp.asarray(chunk), jcache)
        th, tcache = tl.forward_prefill_chunk(tparams, torch.from_numpy(chunk).long(), tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert tcache.pos == int(jcache.pos) == 56
    if kv_quant:  # int8 values may differ by 1 at rounding ties; scales agree
        for name in ("k", "v"):
            diff = getattr(tcache, name).numpy().astype(int) - np.asarray(getattr(jcache, name))
            assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
        np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jcache.k_scale), rtol=TOL)
    else:
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=TOL, atol=TOL)


def test_forward_with_cache_offsets_and_all_logits_match_jax(cmodel):
    """A padded 16-token suffix at position 24: the logits at `last_offset`
    (scalar and per row) and the all-positions [B, S, V] logits."""
    jcfg, jparams, tcfg, tparams = cmodel
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, jcfg.vocab_size, (2, 24)).astype(np.int32)
    suffix = rng.integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jfwd = jax.jit(lambda p, t, c, off, every: jl.forward_with_cache(
        p, t, c, jcfg, last_offset=off, all_logits=every), static_argnums=(4,))
    for off, every in ((None, False), (5, False), (np.array([3, 11], np.int32), False),
                       (None, True)):
        jcache = jl.init_cache(jcfg, 2, 64)
        _, jcache = jax.jit(lambda p, t, c: jl.forward_with_cache(p, t, c, jcfg))(
            jparams, jnp.asarray(prefix), jcache)
        jlogits, jcache = jfwd(jparams, jnp.asarray(suffix), jcache,
                               None if off is None else jnp.asarray(off), every)
        tcache = tl.init_cache(tcfg, 2, 64, "cpu")
        _, tcache = tl.forward_with_cache(tparams, torch.from_numpy(prefix).long(), tcache)
        t_off = off if off is None or isinstance(off, int) else torch.from_numpy(off)
        tlogits, tcache = tl.forward_with_cache(tparams, torch.from_numpy(suffix).long(), tcache,
                                                last_offset=t_off, all_logits=every)
        assert tlogits.shape == ((2, 16, jcfg.vocab_size) if every else (2, jcfg.vocab_size))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        assert tcache.pos == int(jcache.pos) == 40
    with pytest.raises(ValueError, match="overflow"):  # 32 more rows at 40 of 64
        tl.forward_with_cache(tparams, torch.from_numpy(np.tile(suffix, 2)).long(), tcache)
