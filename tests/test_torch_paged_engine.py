"""The port's PagedBatchEngine (lws_tpu_torch/serving) held to the JAX
PagedBatchEngine on the CPU: the same converted weights and prompts must give
token-identical greedy streams, in the cases of tests/test_paged_kv.py
(dense equality, staggered admission into freed blocks, backpressure and
reuse, a half-size pool) and the greedy-stream cases of
tests/test_paged_sampling.py (a greedy slot beside a sampled one, a greedy
request in a slot that served a sampled one). The JAX side runs its Pallas
paged kernel in interpret mode, as tests/test_paged_attention_kernel.py
does. Also: the port's per-slot sampling against JAX's on the same
logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import flagship as jflagship
from lws_tpu.models import llama as jl
from lws_tpu.serving.engine import SamplingParams as JaxSamplingParams
from lws_tpu.serving.engine import sample_logits as jax_sample_logits
from lws_tpu.serving.engine import sample_logits_per_slot as jax_sample_per_slot
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.engine import (
    SamplingParams,
    mask_logits_per_slot,
    sample_logits,
    sample_logits_per_slot,
)
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine
from lws_tpu_torch.serving.pipeline import DecodePipeline


def build(jcfg):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def small_model():
    return build(jl.LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq_len=128, dtype=jnp.float32, param_dtype=jnp.float32, remat=False,
    ))


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")


def engines(model, **kw):
    jcfg, jparams, tcfg, tparams = model
    return (JaxPagedBatchEngine(jcfg, jparams, **kw),
            PagedBatchEngine(tcfg, tparams, device="cpu", **kw))


def prompts(n, rng=3, vocab=256):
    r = np.random.RandomState(rng)
    return [r.randint(1, vocab - 1, size=r.randint(4, 40)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_greedy_streams_match_jax_engine(small_model, jax_kernel, pipeline_depth):
    jax_eng, eng = engines(small_model, slots=4, max_len=64, block_size=8,
                           pipeline_depth=pipeline_depth)
    ps = prompts(4)
    ids_j = [jax_eng.submit(p, max_new_tokens=12) for p in ps]
    ids_t = [eng.submit(p, max_new_tokens=12) for p in ps]
    jax_eng.run_until_drained()
    eng.run_until_drained()
    got = [eng.result(i) for i in ids_t]
    assert got == [jax_eng.result(i) for i in ids_j]
    assert all(len(r) == 12 for r in got)
    assert eng.stats["attention_path"] == "plain"


def test_staggered_admission_into_freed_blocks_matches_jax(small_model, jax_kernel):
    """A third request reuses blocks released by the first while the second
    keeps decoding (pool sized so it must)."""
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

    jax_eng, eng = engines(small_model, slots=2, max_len=64, block_size=8, num_blocks=2 * 8 + 1)
    assert run(eng) == run(jax_eng)


def test_pool_backpressure_and_reuse_match_jax(small_model, jax_kernel):
    """Admission returns None when the pool is dry; blocks come back on
    completion and admission succeeds again."""
    p = np.arange(1, 9, dtype=np.int32)  # bucket 8; footprint 8+24 = 32 -> 4 blocks

    def run(engine):
        a = engine.submit(p, max_new_tokens=24)
        b = engine.submit(p, max_new_tokens=24)
        assert a is not None and b is not None and engine.free_blocks == 1
        assert engine.submit(p, max_new_tokens=24) is None  # pool dry, slots free
        engine.run_until_drained()
        assert engine.free_blocks == 9
        c = engine.submit(p, max_new_tokens=24)
        engine.run_until_drained()
        assert engine.result(c) == engine.result(a)
        return [engine.result(i) for i in (a, b, c)]

    jax_eng, eng = engines(small_model, slots=4, max_len=64, block_size=8, num_blocks=10)
    assert run(eng) == run(jax_eng)
    assert eng.pool_accounting() == jax_eng.pool_accounting() == {
        "free": 9, "parked": 0, "live": 0, "total": 9}


def test_half_size_pool_serves_every_slot_and_matches_jax(small_model, jax_kernel):
    slots, max_len, bs = 8, 64, 8
    p = np.arange(1, 17, dtype=np.int32)  # footprint 16+8 = 24 -> 3 blocks

    def run(engine):
        ids = [engine.submit(p, max_new_tokens=8) for _ in range(slots)]
        assert None not in ids and engine.active_count == slots
        engine.run_until_drained()
        return [engine.result(i) for i in ids]

    jax_eng, eng = engines(small_model, slots=slots, max_len=max_len, block_size=bs,
                           num_blocks=slots * (max_len // bs) // 2 + 1)
    got = run(eng)
    assert got == run(jax_eng)
    assert all(r == got[0] for r in got)


def test_flagship_smoke_streams_match_jax(jax_kernel):
    model = build(jflagship.flagship_config("smoke", unroll_cached_layers=False))
    jax_eng, eng = engines(model, slots=3, max_len=128, block_size=16)
    ps = prompts(3, rng=11, vocab=512)
    ids_j = [jax_eng.submit(p, max_new_tokens=10) for p in ps]
    ids_t = [eng.submit(p, max_new_tokens=10) for p in ps]
    jax_eng.run_until_drained()
    eng.run_until_drained()
    assert [eng.result(i) for i in ids_t] == [jax_eng.result(i) for i in ids_j]


def test_engine_refuses_missing_gpu_and_bad_shapes(small_model):
    _, _, tcfg, tparams = small_model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedBatchEngine(tcfg, tparams)
    with pytest.raises(ValueError, match="multiple of block_size"):
        PagedBatchEngine(tcfg, tparams, max_len=60, block_size=8, device="cpu")
    eng = PagedBatchEngine(tcfg, tparams, slots=1, max_len=32, block_size=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.arange(1, 30, dtype=np.int32), max_new_tokens=8)


# ---------------------------------------------------------------------------
# Sampling


def test_seeded_sampling_reproduces_and_top_k_1_is_greedy(small_model):
    _, _, tcfg, tparams = small_model
    p = prompts(1, rng=5)[0]

    def run(**kw):
        eng = PagedBatchEngine(tcfg, tparams, slots=2, max_len=64, block_size=8, device="cpu")
        rid = eng.submit(p, max_new_tokens=10, **kw)
        eng.run_until_drained()
        return eng.result(rid)

    greedy = run()
    assert run(temperature=0.8, seed=7) == run(temperature=0.8, seed=7)
    assert run(temperature=0.8, top_k=1, seed=3) == greedy


@pytest.fixture(scope="module")
def sampling_model():
    """tests/test_paged_sampling.py's config."""
    return build(jl.LlamaConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq_len=64, dtype=jnp.float32, remat=False,
    ))


PROMPT_A = np.array([5, 9, 2], np.int32)
PROMPT_B = np.array([7, 7, 1, 4], np.int32)


def test_greedy_slot_unperturbed_by_sampled_neighbors(sampling_model, jax_kernel):
    """tests/test_paged_sampling.py:39: a greedy request decodes the same
    tokens beside a sampled neighbor as alone, and JAX's greedy stream."""
    jax_ref, ref = engines(sampling_model, slots=3, max_len=32, block_size=8)
    want = jax_ref.submit(PROMPT_A, max_new_tokens=8)
    jax_ref.run_until_drained()
    a0 = ref.submit(PROMPT_A, max_new_tokens=8)
    ref.run_until_drained()
    _, eng = engines(sampling_model, slots=3, max_len=32, block_size=8)
    a = eng.submit(PROMPT_A, max_new_tokens=8)
    b = eng.submit(PROMPT_B, max_new_tokens=8, temperature=1.5, top_k=20, seed=7)
    eng.run_until_drained()
    assert eng.result(a) == ref.result(a0) == jax_ref.result(want)
    assert len(eng.result(b)) == 8


def test_sampling_survives_slot_reuse(sampling_model, jax_kernel):
    """tests/test_paged_sampling.py:84: a greedy request admitted into a slot
    that served a sampled one stays greedy, and equals JAX's stream."""
    jax_ref, eng = engines(sampling_model, slots=1, max_len=32, block_size=8)
    s = eng.submit(PROMPT_A, max_new_tokens=4, temperature=2.0, seed=9)
    eng.run_until_drained()
    assert len(eng.result(s)) == 4
    g = eng.submit(PROMPT_B, max_new_tokens=8)  # same slot, greedy
    eng.run_until_drained()
    g0 = jax_ref.submit(PROMPT_B, max_new_tokens=8)
    jax_ref.run_until_drained()
    ref = PagedBatchEngine(*sampling_model[2:], slots=3, max_len=32, block_size=8, device="cpu")
    g1 = ref.submit(PROMPT_B, max_new_tokens=8)
    ref.run_until_drained()
    assert eng.result(g) == ref.result(g1) == jax_ref.result(g0)


def test_greedy_sampling_is_exact_argmax():
    logits = np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32)
    z = np.zeros(4, np.float32)
    got = sample_logits_per_slot(torch.from_numpy(logits), [torch.Generator()] * 4,
                                 torch.from_numpy(z), torch.zeros(4, dtype=torch.int32),
                                 torch.ones(4)).numpy()
    keys = jax.random.split(jax.random.key(0), 4)
    want = np.asarray(jax_sample_per_slot(jnp.asarray(logits), keys, jnp.asarray(z),
                                          jnp.zeros(4, jnp.int32), jnp.ones(4)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, logits.argmax(-1))
    batch = sample_logits(torch.from_numpy(logits), torch.Generator(), SamplingParams()).numpy()
    jbatch = jax_sample_logits(jnp.asarray(logits), jax.random.key(0), JaxSamplingParams())
    np.testing.assert_array_equal(batch, np.asarray(jbatch))
    top1 = sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(1),
                         SamplingParams(temperature=0.9, top_k=1)).numpy()
    np.testing.assert_array_equal(top1, logits.argmax(-1))


def test_top_k_top_p_masks_equal_jax_support():
    """The port's mask keeps exactly the tokens JAX's sampler can draw: over
    2048 JAX draws per slot every kept token (probability >= 1% by
    construction) appears and no masked token does."""
    V = 12
    logits = np.log(np.array([
        [30, 20, 15, 10, 8, 6, 4, 3, 2, 1, 0.5, 0.5],
        [5, 30, 4, 20, 3, 15, 2, 10, 1, 6, 2, 2],
        [10, 10, 10, 10, 10, 10, 10, 10, 10, 5, 2.5, 2.5],
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 22, 23],
    ], np.float32) / 100.0)
    temp = np.array([1.0, 0.7, 1.3, 1.0], np.float32)
    top_k = np.array([4, 0, 9, 6], np.int32)
    top_p = np.array([1.0, 0.8, 0.9, 0.6], np.float32)
    kept = torch.isfinite(mask_logits_per_slot(
        torch.from_numpy(logits), torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p))).numpy()
    n = 2048
    draws = jax.vmap(lambda k: jax_sample_per_slot(
        jnp.asarray(logits), jax.random.split(k, 4), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p)))(jax.random.split(jax.random.key(1), n))
    draws = np.asarray(draws)  # [n, 4]
    for b in range(4):
        support = np.zeros(V, bool)
        support[np.unique(draws[:, b])] = True
        np.testing.assert_array_equal(kept[b], support, err_msg=f"slot {b}")
    assert kept.sum(1).tolist() == [4, 4, 9, 3]


def test_pipeline_commits_in_dispatch_order_and_flushes():
    pipe = DecodePipeline(depth=2)
    seen = []
    for i in range(5):
        pipe.push(1, torch.tensor([[i]]), lambda host: seen.append(int(host[0, 0])))
        assert len(pipe) == min(i + 1, 2) and pipe.inflight_steps() == len(pipe)
    assert seen == [0, 1, 2]
    pipe.flush()
    assert seen == [0, 1, 2, 3, 4] and not pipe
    assert pipe.stats["dispatched"] == pipe.stats["consumed"] == 5
