"""The port's int8 weight quantization (lws_tpu_torch/models/quant.py,
ops/int8_matmul.py, models/flagship.py, the quantized weight bridge) held to
lws_tpu/models/quant.py, lws_tpu/ops/int8_matmul.py and
lws_tpu/models/flagship.py on the CPU.

Layouts differ by design: JAX keeps a product weight as q [D, F] (x @ q),
the port as nn.Linear's q [F, D]; scales are [F] in both. Tolerances:
quantization is bit-equal (the same f32 ops, round-half-even in both);
products in f32 agree to 1e-5 of the output's magnitude (summation order);
bf16 products to 2e-2 (bf16 keeps 8 bits)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import flagship as jflagship
from lws_tpu.models import llama as jl
from lws_tpu.models import quant as jq
from lws_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from lws_tpu_torch.models import flagship as tflagship
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models import quant as tq
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax, params_to_numpy
from lws_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference


def t(a):
    return torch.from_numpy(np.array(a))


def small_jax_config(**kw):
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, dtype=jnp.float32, param_dtype=jnp.float32, remat=False)
    return jl.LlamaConfig(**{**base, **kw})


@pytest.mark.parametrize("shape", [(32, 48), (512, 256), (7, 129)])
def test_quantize_array_is_bit_equal_to_jax(shape):
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32) * 0.3
    w[:, 3] = 0.0  # an all-zero column: scale floors at 1e-8 / 127
    jqa = jq.quantize_array(jnp.asarray(w), contract_axis=-2)  # JAX [D, F]
    tqa = tq.quantize_array(t(w.T), contract_axis=-1)          # port [F, D]
    np.testing.assert_array_equal(tqa.q.numpy().T, np.asarray(jqa.q))
    np.testing.assert_array_equal(tqa.scale.numpy(), np.asarray(jqa.scale))
    assert tqa.q.dtype == torch.int8 and tqa.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.dequantize_array(tqa, torch.float32).numpy().T,
                                  np.asarray(jq.dequantize_array(jqa, jnp.float32)))
    # Per-row (embedding) quantization: the contraction axis is the last in both.
    erow = tq.quantize_array(t(w), contract_axis=-1)
    jrow = jq.quantize_array(jnp.asarray(w), contract_axis=-1)
    np.testing.assert_array_equal(erow.q.numpy(), np.asarray(jrow.q))
    np.testing.assert_array_equal(erow.scale.numpy(), np.asarray(jrow.scale))


def test_matmul_and_embed_lookup_on_quantized_weights_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    jqa = jq.quantize_array(jnp.asarray(w))
    tqa = tq.QuantizedArray(q=t(np.asarray(jqa.q)).T.contiguous(), scale=t(np.asarray(jqa.scale)))
    assert tqa.shape == (48, 32) and tqa.ndim == 2
    want = np.asarray(jq.matmul(jnp.asarray(x), jqa, jnp.float32))
    for plain in (False, True):
        got = tq.matmul(t(x), tqa, torch.float32, plain=plain).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # Plain weights keep the bf16 slice's product.
    np.testing.assert_allclose(tq.matmul(t(x), t(w.T)).numpy(), x @ w, rtol=1e-5, atol=1e-5)

    table = rng.standard_normal((16, 8)).astype(np.float32)
    jtab = jq.quantize_array(jnp.asarray(table), contract_axis=-1)
    ttab = tq.QuantizedArray(q=t(np.asarray(jtab.q)), scale=t(np.asarray(jtab.scale)))
    toks = np.array([[0, 5, 15], [3, 3, 1]], np.int32)
    np.testing.assert_allclose(tq.embed_lookup(ttab, t(toks), torch.float32).numpy(),
                               np.asarray(jq.embed_lookup(jtab, jnp.asarray(toks), jnp.float32)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [256, 512])
@pytest.mark.parametrize("D", [512, 1024])
@pytest.mark.parametrize("m", [1, 8, 24])
def test_int8_matmul_plain_matches_jax_kernel_interpret(m, D, F, dtype):
    """The kernel's plain version against the Pallas kernel in interpret mode
    at shapes JAX's `supported` takes; on CPU tensors the wrapper is the
    plain version and counts no launch."""
    rng = np.random.default_rng(m * 7 + D + F)
    x = rng.standard_normal((m, D)).astype(np.float32)
    jqa = jq.quantize_array(jnp.asarray(rng.standard_normal((D, F)).astype(np.float32)))
    q, scale = t(np.asarray(jqa.q)).T.contiguous(), t(np.asarray(jqa.scale))
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), t(x).to(getattr(torch, dtype))
    want = np.asarray(jax_int8_matmul(jx, jqa.q, jqa.scale, interpret=True).astype(jnp.float32))
    before = int8_matmul.launches
    got = int8_matmul(tx, q, scale)
    assert int8_matmul.launches == before and got.dtype == tx.dtype
    torch.testing.assert_close(got, int8_matmul_reference(tx, q, scale), rtol=0, atol=0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("param_dtype", [jnp.float32, jnp.bfloat16])
def test_quantized_bytes_equals_jax(param_dtype):
    jcfg = small_jax_config(param_dtype=param_dtype)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tcfg = config_from_jax(jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    assert tq.quantized_bytes(model) == jq.quantized_bytes(jparams)
    assert tq.quantized_bytes(tq.quantize_params(model)) == jq.quantized_bytes(
        jq.quantize_params(jparams))


def test_quantize_params_matches_jax_leaf_for_leaf():
    jcfg = small_jax_config()
    jparams = jl.init_params(jcfg, jax.random.key(1))
    tcfg = config_from_jax(jcfg)
    qmodel = tq.quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu"))
    jtree = jax.tree.map(np.asarray, jq.quantize_params(jparams))
    back = params_to_numpy(qmodel)
    assert _leaves(back).keys() == _leaves(jtree).keys()
    for key, want in _leaves(jtree).items():
        np.testing.assert_array_equal(_leaves(back)[key], want, err_msg=key)


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a params tree; QuantizedArray leaves (JAX's or
    the port's, read by attribute) give path.q and path.scale."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "q"):
        return {prefix + "q": np.asarray(tree.q), prefix + "scale": np.asarray(tree.scale)}
    return {prefix.rstrip("/"): np.asarray(tree)}


def test_init_quantized_params_has_the_structure_of_quantize_params():
    cfg = tflagship.flagship_config("smoke")
    direct = tflagship.init_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = tq.quantize_params(tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    a, b = direct.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    for name in a:
        assert a[name].shape == b[name].shape and a[name].dtype == b[name].dtype, name
    # Values uniform in [-127, 127]; flat scales fan_in**-0.5 / 73.3 with the depth damping.
    wq = direct.layers[0].wq
    assert int(wq.q.min()) >= -127 and int(wq.q.max()) <= 127 and wq.q.float().std() > 60
    rms = 254.0 / 12.0 ** 0.5
    assert torch.allclose(wq.scale, torch.full_like(wq.scale, cfg.d_model**-0.5 / rms))
    damp = (2 * cfg.n_layers) ** -0.5
    assert torch.allclose(direct.layers[1].w_down.scale,
                          torch.full((cfg.d_model,), cfg.d_ff**-0.5 * damp / rms))
    again = tflagship.init_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(direct.state_dict().values(),
                                                   again.state_dict().values()))


def test_full_scale_int8_bytes_on_meta_equal_jax_eval_shape():
    """The sizing the flagship rests on: ~8.04 GB of int8 weights, counted
    without allocating (meta device / eval_shape)."""
    jcfg = jflagship.flagship_config("full")
    jshapes = jax.eval_shape(lambda k: jflagship.init_quantized_params(jcfg, k), jax.random.key(0))
    jbytes = sum(a.size * jnp.dtype(a.dtype).itemsize for a in jax.tree.leaves(jshapes))
    model = tflagship.init_quantized_params(tflagship.flagship_config("full"), device="meta")
    assert tq.quantized_bytes(model) == jbytes
    assert 7.5e9 < jbytes < 10e9
    plan = tflagship.memory_plan(tflagship.flagship_config("full", kv_quant=True), model, 8, 2048)
    assert plan["param_gb"] == 8.04 and plan["kv_row_kb_per_token"] == 67.6


@pytest.mark.parametrize("kv_quant", [False, True])
def test_kv_row_bytes_matches_jax(kv_quant):
    for scale in ("full", "smoke"):
        assert tflagship.kv_row_bytes(tflagship.flagship_config(scale, kv_quant=kv_quant)) == \
            jflagship.kv_row_bytes(jflagship.flagship_config(scale, kv_quant=kv_quant))


@pytest.mark.parametrize("source", ["quantize_params", "init_quantized_params"])
@pytest.mark.parametrize("param_dtype", [jnp.float32, jnp.bfloat16])
def test_weight_bridge_round_trips_quantized_trees_bit_exactly(source, param_dtype):
    jcfg = dataclasses.replace(jflagship.flagship_config("smoke", kv_quant=True),
                               param_dtype=param_dtype)
    if source == "quantize_params":
        jtree = jq.quantize_params(jl.init_params(jcfg, jax.random.key(2)))
    else:
        jtree = jflagship.init_quantized_params(jcfg, jax.random.key(2))
    tree = jax.tree.map(np.asarray, jtree)
    tcfg = config_from_jax(jcfg)
    assert tcfg.kv_quant
    model = params_from_jax(tree, tcfg, "cpu")
    assert model.quantized and isinstance(model.layers[0].wq.weight, tq.QuantizedArray)
    assert model.lm_head.q.shape == (jcfg.vocab_size, jcfg.d_model)  # [V, D]: crossed transposed
    got, want = _leaves(params_to_numpy(model)), _leaves(tree)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key
