"""The port's model (lws_tpu_torch/models) held to lws_tpu/models on the CPU:
the same numpy inputs and the same weights (crossed by the weight bridge)
through the JAX functions and their counterparts. Configs are the f32
config of tests/test_paged_kv.py and flagship_config("smoke"); outputs are
compared at f32 summation-order tolerance (the XLA and PyTorch CPU matmuls
sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import flagship as jflagship
from lws_tpu.models import llama as jl
from lws_tpu_torch.models import flagship as tflagship
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax, params_to_numpy

TOL = 2e-5
LOGIT_TOL = 1e-4  # logits: two layers of f32 products with different summation order


def small_jax_config(**kw):
    return jl.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, max_seq_len=128, dtype=jnp.float32,
                          param_dtype=jnp.float32, remat=False, **kw)


def build(jcfg, seed=0):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(seed)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@pytest.fixture(scope="module", params=["small", "flagship_smoke"])
def models(request):
    if request.param == "small":
        return build(small_jax_config())
    return build(jflagship.flagship_config("smoke", unroll_cached_layers=False))


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(t(x), t(w), 1e-5).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
                               rtol=TOL, atol=TOL)
    xr = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    positions = rng.integers(0, 2048, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tl.rope(t(xr), t(positions), 500_000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(xr), jnp.asarray(positions), 500_000.0)),
        rtol=1e-4, atol=1e-4)  # f32 sin/cos of angles up to ~2k radians


@pytest.mark.parametrize("plen,bucket", [(16, 16), (13, 32)])
def test_forward_prefill_matches_jax(models, plen, bucket):
    """Last-token logits at the true prompt end of a padded bucket, and the
    K/V written into the cache."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(plen)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :plen] = rng.integers(1, jcfg.vocab_size, plen)
    jlogits, jcache = jax.jit(
        lambda p, tok: jl.forward_prefill(p, tok, jl.init_cache(jcfg, 1, bucket), jcfg,
                                          last_pos=plen - 1)
    )(jparams, jnp.asarray(tokens))
    tcache = tl.init_cache(tcfg, 1, bucket, "cpu")
    tlogits, tcache = tl.forward_prefill(tparams, t(tokens), tcache, last_pos=plen - 1)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=TOL, atol=TOL)
    assert tcache.pos == int(jcache.pos) == plen


def _prefilled_pools(jcfg, jparams, tcfg, tparams, block_ids, bucket, num_blocks, bs):
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, (1, bucket)).astype(np.int32)
    _, jcache = jl.forward_prefill(jparams, jnp.asarray(tokens), jl.init_cache(jcfg, 1, bucket), jcfg)
    _, tcache = tl.forward_prefill(tparams, t(tokens), tl.init_cache(tcfg, 1, bucket, "cpu"))
    jpool = jl.paged_insert(jl.init_paged_cache(jcfg, num_blocks, bs), jcache.k[:, 0],
                            jcache.v[:, 0], jnp.asarray(block_ids))
    tpool = tl.paged_insert(tl.init_paged_cache(tcfg, num_blocks, bs, "cpu"), tcache.k[:, 0],
                            tcache.v[:, 0], t(block_ids))
    return jpool, tpool


def test_paged_insert_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    block_ids = np.array([5, 2, 7, 1], np.int32)  # scrambled pool blocks
    jpool, tpool = _prefilled_pools(jcfg, jparams, tcfg, tparams, block_ids, 32, 9, 8)
    np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v), rtol=TOL, atol=TOL)
    untouched = [0, 3, 4, 6, 8]
    assert not tpool.k[:, untouched].any() and not tpool.v[:, untouched].any()


@pytest.mark.parametrize("jax_path", ["gather", "pallas_interpret"])
def test_forward_decode_paged_step_matches_jax(models, jax_path, monkeypatch):
    """One decode step over two slots (one live past the prefilled bucket,
    one released to the null row): logits and the pool after the in-place
    K/V write, against JAX's gather path and its Pallas kernel."""
    jcfg, jparams, tcfg, tparams = models
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret" if jax_path == "pallas_interpret" else "0")
    bs, num_blocks = 8, 12
    jpool, tpool = _prefilled_pools(jcfg, jparams, tcfg, tparams,
                                    np.array([3, 9, 4, 1], np.int32), 32, num_blocks, bs)
    table = np.array([[3, 9, 4, 1, 6, 0], [0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.array([32, 11], np.int32)  # slot 0 appends into its 5th block
    tokens = np.array([17, 5], np.int32)
    jlogits, jpool = jl.forward_decode_paged(jparams, jnp.asarray(tokens), jpool,
                                             jnp.asarray(table), jnp.asarray(pos), jcfg)
    tlogits, tpool = tl.forward_decode_paged(tparams, t(tokens), tpool, t(table), t(pos))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("param_dtype", [jnp.float32, jnp.bfloat16])
def test_weight_bridge_round_trips_bit_exactly(param_dtype):
    jcfg = small_jax_config()
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype, dtype=param_dtype)
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(3)))()
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_jax(tree, config_from_jax(jcfg), "cpu")
    assert model.embed.weight.dtype == getattr(torch, jnp.dtype(param_dtype).name)
    back = params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_weight_bridge_refuses_a_dtype_mismatch():
    jcfg = small_jax_config()
    tree = jax.tree.map(np.asarray, jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))())
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(tree, dataclasses.replace(config_from_jax(jcfg), param_dtype=torch.bfloat16),
                        "cpu")


@pytest.mark.parametrize("feature", [{"context_parallel": True}, {"pipeline_microbatches": 2}])
def test_config_bridge_refuses_unported_features(feature):
    """The training slice ported the ring and GPipe: the bridge now carries
    these features over instead of refusing them."""
    cfg = config_from_jax(small_jax_config(**feature))
    for name, value in feature.items():
        assert getattr(cfg, name) == value


def test_flagship_configs_match_jax():
    for scale in ("full", "smoke"):
        jcfg, tcfg = jflagship.flagship_config(scale), tflagship.flagship_config(scale)
        assert config_from_jax(jcfg) == tcfg
        assert tcfg.n_params() == jcfg.n_params()
    assert round(tflagship.flagship_config("full").n_params() / 1e9, 2) == 8.03


def test_init_params_is_seeded_and_scaled():
    cfg = tflagship.flagship_config("smoke")
    a = tl.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = tl.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    wq = a.layers[0].wq.weight
    assert wq.shape == (cfg.n_heads * cfg.head_dim, cfg.d_model)  # nn.Linear [out, in]
    assert abs(wq.std().item() - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert torch.equal(a.layers[0].attn_norm, torch.ones(cfg.d_model))


def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be observed")
    cfg = tflagship.flagship_config("smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.Llama(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_params(cfg)
