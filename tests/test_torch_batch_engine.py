"""The port's BatchEngine and forward_decode_slotted (lws_tpu_torch) held to
the JAX package's on the CPU: the same converted weights, caches and prompts
through lws_tpu and lws_tpu_torch.

forward_decode_slotted: logits within 1e-4 (f32 summation-order noise, as
tests/test_torch_model.py), 1e-3 with an int8 cache (the new K/V row is
quantized from f32 values that differ in the last bits, so a value at a
rounding tie may land 1 off, which moves the logits by about 2e-4), 3e-2
for the bf16 config; written rows within 1e-2, int8 rows equal up to a
1-off value and scales within 2e-5; every other row byte-identical. The
engines' greedy streams must be token-identical to JAX's, in the cases of
tests/test_batch_engine.py and the BatchEngine cases of
tests/test_decode_pipeline.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import llama as jl
from lws_tpu.serving.batch_engine import BatchEngine as JaxBatchEngine
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.batch_engine import BatchEngine
from lws_tpu_torch.serving.engine import Engine

LOGIT_TOL = {(jnp.float32, False): 1e-4, (jnp.float32, True): 1e-3,
             (jnp.bfloat16, False): 3e-2}


def build(jcfg):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def tiny(**kw):
    """tests/test_batch_engine.py's config."""
    base = dict(vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, dtype=jnp.float32, remat=False)
    return build(jl.LlamaConfig(**{**base, **kw}))


@pytest.fixture(scope="module")
def tiny_model():
    return tiny()


@pytest.fixture(scope="module")
def small_model():
    """tests/test_decode_pipeline.py's config."""
    return build(jl.LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq_len=128, dtype=jnp.float32, param_dtype=jnp.float32, remat=False,
    ))


def engines(model, **kw):
    jcfg, jparams, tcfg, tparams = model
    return JaxBatchEngine(jcfg, jparams, **kw), BatchEngine(tcfg, tparams, device="cpu", **kw)


# ---------------------------------------------------------------------------
# forward_decode_slotted


def random_caches(jcfg, tcfg, B, T, seed):
    """The same random cache contents as a JAX and a port KVCache."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, B, T, jcfg.n_kv_heads, jcfg.head_dim)
    if jcfg.kv_quant:
        arrays = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)] + \
            [rng.uniform(1e-3, 2e-2, shape[:-1]).astype(np.float32) for _ in range(2)]
        k, v, ks, vs = arrays
        jc = jl.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.zeros((), jnp.int32),
                        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tc = tl.KVCache(*(torch.from_numpy(a.copy()) for a in (k, v)), 0,
                        *(torch.from_numpy(a.copy()) for a in (ks, vs)))
        return jc, tc
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jc = jl.KVCache(k=jnp.asarray(k, jcfg.dtype), v=jnp.asarray(v, jcfg.dtype),
                    pos=jnp.zeros((), jnp.int32))
    tc = tl.KVCache(k=torch.from_numpy(np.array(jc.k, np.float32)).to(tcfg.dtype),
                    v=torch.from_numpy(np.array(jc.v, np.float32)).to(tcfg.dtype))
    return jc, tc


def as_f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def assert_caches_match(jc, tc, pos_b, T):
    """Rows at each slot's position: close (int8: equal or 1 off, scales
    close); every other row: equal to the bit."""
    written = np.zeros((len(pos_b), T), bool)
    for b, p in enumerate(pos_b):
        if p < T:
            written[b, p] = True
    names = ("k", "v", "k_scale", "v_scale") if tc.k_scale is not None else ("k", "v")
    for name in names:
        got, want = as_f32(getattr(tc, name)), as_f32(getattr(jc, name))
        np.testing.assert_array_equal(got[:, ~written], want[:, ~written])
        if name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[:, written], want[:, written], rtol=2e-5)
        elif tc.k_scale is not None:
            assert np.abs(got[:, written] - want[:, written]).max() <= 1
        else:
            np.testing.assert_allclose(got[:, written], want[:, written], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype,kv_quant", [(jnp.float32, False), (jnp.float32, True),
                                            (jnp.bfloat16, False)])
def test_forward_decode_slotted_matches_jax_at_scattered_positions(dtype, kv_quant):
    jcfg, jparams, tcfg, tparams = tiny(dtype=dtype, kv_quant=kv_quant)
    B, T = 5, 32
    pos_b = np.array([0, 17, 31, 5, 16], np.int32)
    tokens = np.array([3, 99, 7, 42, 1], np.int32)
    jc, tc = random_caches(jcfg, tcfg, B, T, seed=1)
    jlogits, jc = jl.forward_decode_slotted(jparams, jnp.asarray(tokens), jc, jnp.asarray(pos_b),
                                            jcfg)
    tlogits, tc = tl.forward_decode_slotted(tparams, torch.from_numpy(tokens), tc,
                                            torch.from_numpy(pos_b))
    tol = LOGIT_TOL[dtype, kv_quant]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=tol, atol=tol)
    assert_caches_match(jc, tc, pos_b, T)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_decode_slotted_drops_writes_past_the_cache_like_jax(kv_quant):
    """A slot at pos_b >= T (a stale position) writes nothing, as JAX's
    scatter drops an out-of-range update, and attends to every key."""
    jcfg, jparams, tcfg, tparams = tiny(kv_quant=kv_quant)
    B, T = 3, 16
    pos_b = np.array([T, 4, T + 3], np.int32)
    tokens = np.array([8, 9, 10], np.int32)
    jc, tc = random_caches(jcfg, tcfg, B, T, seed=2)
    before = {name: getattr(tc, name).clone() for name in ("k", "v")}
    jlogits, jc = jl.forward_decode_slotted(jparams, jnp.asarray(tokens), jc, jnp.asarray(pos_b),
                                            jcfg)
    tlogits, tc = tl.forward_decode_slotted(tparams, torch.from_numpy(tokens), tc,
                                            torch.from_numpy(pos_b))
    tol = LOGIT_TOL[jnp.float32, kv_quant]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=tol, atol=tol)
    assert_caches_match(jc, tc, pos_b, T)
    for name, old in before.items():  # the dropped slots' rows, T-1 included, are untouched
        assert torch.equal(getattr(tc, name)[:, [0, 2]], old[:, [0, 2]])


# ---------------------------------------------------------------------------
# The engine: tests/test_batch_engine.py and tests/test_decode_pipeline.py


def oracle(model, prompt, n):
    """The port's dense Engine, generating one request alone."""
    _, _, tcfg, tparams = model
    engine = Engine(tcfg, tparams, batch_size=1, max_len=32, device="cpu")
    return list(engine.generate(np.asarray(prompt).reshape(1, -1), n).tokens[0])


def staggered(eng):
    a = eng.submit(np.array([5, 9, 2], np.int32), max_new_tokens=8)
    for _ in range(3):
        eng.step()
    # B joins while A is mid-decode; C joins later still.
    b = eng.submit(np.array([7, 7, 1, 4], np.int32), max_new_tokens=6)
    eng.step()
    c = eng.submit(np.array([3], np.int32), max_new_tokens=5)
    eng.run_until_drained()
    return [eng.result(i) for i in (a, b, c)]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_staggered_requests_match_isolated_decoding_and_jax(tiny_model, kv_quant):
    model = tiny(kv_quant=True) if kv_quant else tiny_model
    jax_eng, eng = engines(model, slots=3, max_len=32)
    got = staggered(eng)
    assert got == staggered(jax_eng)
    assert got == [oracle(model, [5, 9, 2], 8), oracle(model, [7, 7, 1, 4], 6),
                   oracle(model, [3], 5)]
    assert eng.active_count == 0


def test_slot_reuse_after_completion_matches_jax(tiny_model):
    def run(eng):
        a = eng.submit(np.array([5, 9, 2], np.int32), max_new_tokens=4)
        assert eng.submit(np.array([1], np.int32), max_new_tokens=2) is None  # full
        eng.run_until_drained()
        # The freed slot admits a request whose output is uncontaminated by
        # the previous occupant's cache rows.
        b = eng.submit(np.array([7, 7, 1, 4], np.int32), max_new_tokens=6)
        eng.run_until_drained()
        return [eng.result(a), eng.result(b)]

    jax_eng, eng = engines(tiny_model, slots=1, max_len=32)
    got = run(eng)
    assert got == run(jax_eng)
    assert got == [oracle(tiny_model, [5, 9, 2], 4), oracle(tiny_model, [7, 7, 1, 4], 6)]


def prompts(n, rng):
    r = np.random.RandomState(rng)
    return [r.randint(1, 255, size=r.randint(4, 40)).astype(np.int32) for _ in range(n)]


def test_batch_engine_pipelined_matches_sync(small_model):
    ps = prompts(4, rng=29)
    budgets = (12, 3, 7, 12)

    def run(make, depth):
        eng = make(slots=4, max_len=64, pipeline_depth=depth)
        ids = [eng.submit(p, max_new_tokens=m) for p, m in zip(ps, budgets)]
        eng.run_until_drained()
        return [eng.result(i) for i in ids]

    jcfg, jparams, tcfg, tparams = small_model
    port = lambda **kw: BatchEngine(tcfg, tparams, device="cpu", **kw)
    want = run(lambda **kw: JaxBatchEngine(jcfg, jparams, **kw), 0)
    assert run(port, 0) == run(port, 2) == want


def test_batch_engine_pipelined_midstream_admission(small_model):
    """A slot freed by an in-flight completion is reclaimable: submit
    flushes the ring instead of returning None."""
    ps = prompts(3, rng=31)

    def run(make, depth):
        eng = make(slots=2, max_len=64, pipeline_depth=depth)
        a = eng.submit(ps[0], max_new_tokens=3)
        b = eng.submit(ps[1], max_new_tokens=15)
        third = None
        for _ in range(60):
            eng.step()
            if third is None:
                third = eng.submit(ps[2], max_new_tokens=8)  # None until a slot frees
            if eng.active_count == 0 and third is not None:
                break
        assert third is not None
        return [eng.result(i) for i in (a, b, third)]

    jcfg, jparams, tcfg, tparams = small_model
    port = lambda **kw: BatchEngine(tcfg, tparams, device="cpu", **kw)
    want = run(lambda **kw: JaxBatchEngine(jcfg, jparams, **kw), 0)
    assert run(port, 0) == run(port, 2) == want


def test_batch_engine_refuses_missing_gpu_and_bad_requests(tiny_model):
    _, _, tcfg, tparams = tiny_model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchEngine(tcfg, tparams)
    with pytest.raises(ValueError, match="another LlamaConfig"):
        BatchEngine(dataclasses.replace(tcfg, vocab_size=100), tparams, device="cpu")
    eng = BatchEngine(tcfg, tparams, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.arange(1, 12, dtype=np.int32), 6)
    rid = eng.submit(np.array([4, 5], np.int32), 1)  # the prefill token alone finishes it
    assert eng.active_count == 0 and len(eng.result(rid)) == 1
