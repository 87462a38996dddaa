"""MoE serving in the port held to the JAX package on the CPU: the GShard
top-k FFN (`moe_ffn`, `expert_einsum`), the expert leaves of
`quantize_params` and the weight bridge, and the non-TP cases of
tests/test_moe_serving.py, where the port's engines must equal JAX's
stream, not just each other. Also that file's dense
test_spec_decode_with_prefix_cache.

`moe_ffn` and `expert_einsum` agree with JAX's within 1e-5 (f32 summation
order), including a capacity below S, where tokens are dropped, routed the
same way; quantized expert leaves are bit-equal; greedy streams are
token-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import llama as jl
from lws_tpu.models.quant import expert_einsum as jax_expert_einsum
from lws_tpu.models.quant import quantize_params as jax_quantize_params
from lws_tpu.serving import Engine as JaxEngine
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax, params_to_numpy
from lws_tpu_torch.models.quant import QuantizedArray, expert_einsum, quantize_params
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

TOL = 1e-5


def moe_cfg(**kw):
    return jl.LlamaConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, n_experts=4, top_k=2, max_seq_len=256,
        dtype=jnp.float32, param_dtype=jnp.float32, remat=False, **kw,
    )


def to_port(tree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, tree), tcfg, "cpu")


@pytest.fixture(scope="module")
def setup():
    """(jcfg, JAX params, JAX int8 params, port cfg, port model, port int8 model)."""
    jcfg = moe_cfg()
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    jq = jax_quantize_params(jparams)
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, jq, tcfg, to_port(jparams, tcfg), to_port(jq, tcfg)


def leaves(tree):
    """Flat (path, numpy array) pairs of a tree with QuantizedArray leaves."""
    out = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif hasattr(node, "q"):
            out.append((prefix + ".q", np.asarray(node.q)))
            out.append((prefix + ".scale", np.asarray(node.scale)))
        else:
            out.append((prefix, np.asarray(node)))

    walk("", tree)
    return out


# ---------------------------------------------------------------------------
# Config, quantization and the weight bridge


def test_config_from_jax_takes_the_expert_fields(setup):
    jcfg, _, _, tcfg, model, qmodel = setup
    assert (tcfg.n_experts, tcfg.top_k, tcfg.capacity_factor) == (4, 2, 2.0)
    assert tcfg.n_params() == jcfg.n_params() == sum(p.numel() for p in model.parameters())
    blk = qmodel.layers[0]
    assert blk.w_gate.q.shape == (4, 128, 64) and blk.w_gate.scale.shape == (4, 128)
    assert blk.w_down.q.shape == (4, 64, 128) and blk.router.dtype == torch.float32


@pytest.mark.parametrize("quantized", [False, True])
def test_bridge_round_trips_expert_and_router_leaves(setup, quantized):
    _, jparams, jq, _, model, qmodel = setup
    tree = jq if quantized else jparams
    got, want = leaves(params_to_numpy(qmodel if quantized else model)), leaves(tree)
    names = [p for p, _ in got]
    assert names == [p for p, _ in want] and "/layers/router" in names
    assert ("/layers/w_gate.scale" in names) == quantized
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_quantize_params_over_experts_equals_jax(setup):
    """The port's quantize_params on the port model gives JAX's quantized
    expert leaves bit for bit ([E, F, D] with [E, F] scales per layer); the
    router stays in param_dtype."""
    _, _, jq, tcfg, model, qmodel = setup
    ours = quantize_params(model)
    for a, b in zip(ours.buffers(), qmodel.buffers()):
        assert torch.equal(a, b)
    for blk_a, blk_b in zip(ours.layers, qmodel.layers):
        assert torch.equal(blk_a.router, blk_b.router)


# ---------------------------------------------------------------------------
# moe_ffn and expert_einsum


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("capacity_factor,S", [(2.0, 12), (0.5, 12), (2.0, 1)])
def test_moe_ffn_matches_jax(setup, quantized, capacity_factor, S):
    """Capacity 12 (every token kept), 3 (< S: tokens dropped, routed as JAX
    drops them) and the decode shape S = 1 (capacity 1)."""
    jcfg, jparams, jq, _, model, qmodel = setup
    cfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    C = tl.moe_capacity(capacity_factor, S, 2, 4)
    assert C == max(1, int(capacity_factor * S * 2 / 4))
    x = np.random.default_rng(S).standard_normal((3, S, 64)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], (jq if quantized else jparams)["layers"])
    want, _ = jl._moe_ffn(jnp.asarray(x), lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                          cfg)
    blk = (qmodel if quantized else model).layers[1]
    got = tl.moe_ffn(torch.from_numpy(x), blk.router, blk.w_gate.weight, blk.w_up.weight,
                     blk.w_down.weight, 2, capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if capacity_factor < 1:  # some token lost an expert: the output is not the uncapped one
        full = tl.moe_ffn(torch.from_numpy(x), blk.router, blk.w_gate.weight, blk.w_up.weight,
                          blk.w_down.weight, 2, 2.0)
        assert C < S and not torch.allclose(got, full)


@pytest.mark.parametrize("quantized", [False, True])
def test_expert_einsum_matches_jax(setup, quantized):
    _, jparams, jq, _, model, qmodel = setup
    x = np.random.default_rng(3).standard_normal((4, 2, 5, 64)).astype(np.float32)
    for name, spec in (("w_gate", "ebcd,edf->ebcf"), ("w_down", "ebcf,efd->ebcd")):
        leaf = (jq if quantized else jparams)["layers"][name]
        leaf = jax.tree.map(lambda a: a[0], leaf)
        w = getattr((qmodel if quantized else model).layers[0], name).weight
        xin = x if name == "w_gate" else \
            np.random.default_rng(4).standard_normal((4, 2, 5, 128)).astype(np.float32)
        want = jax_expert_einsum(spec, jnp.asarray(xin), leaf)
        got = expert_einsum(torch.from_numpy(xin), w)
        assert isinstance(w, QuantizedArray) == quantized
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        if quantized:  # the plain flag is the CPU route here
            assert torch.equal(expert_einsum(torch.from_numpy(xin), w, plain=True), got)


# ---------------------------------------------------------------------------
# Serving (tests/test_moe_serving.py:53, :67, :81, :110)


def jax_paged_results(jcfg, jparams, prompts, max_new=12, **kw):
    return paged_results(lambda **k: JaxPagedBatchEngine(jcfg, jparams, **k), prompts,
                         max_new, **kw)


def port_paged_results(tcfg, tparams, prompts, max_new=12, **kw):
    return paged_results(lambda **k: PagedBatchEngine(tcfg, tparams, device="cpu", **k),
                         prompts, max_new, **kw)


def paged_results(make, prompts, max_new=12, **kw):
    spec = kw.pop("speculative", False)
    eng = make(slots=4, max_len=256, block_size=16, **kw)
    rids = []
    for p in prompts:
        rids.append(eng.submit(p, max_new_tokens=max_new))
        eng.step_n(2)
    if spec:
        eng.run_until_drained_speculative(gamma=4)
    else:
        eng.run_until_drained()
    return [eng.result(r) for r in rids]


def test_moe_engines_agree_with_jax(setup):
    """The port's Engine and PagedBatchEngine give JAX's greedy stream."""
    jcfg, jparams, _, tcfg, model, _ = setup
    prompt = np.random.RandomState(0).randint(1, 120, size=12).astype(np.int32)
    want = np.asarray(JaxEngine(jcfg, jparams, batch_size=1, max_len=256).generate(
        prompt.reshape(1, -1), max_new_tokens=12).tokens)[0]
    dense = Engine(tcfg, model, batch_size=1, max_len=256, device="cpu").generate(
        prompt.reshape(1, -1), max_new_tokens=12).tokens[0]
    assert list(dense) == list(want)
    assert port_paged_results(tcfg, model, [prompt])[0] == list(want)


def test_moe_chunked_and_speculative_compose_like_jax(setup):
    jcfg, jparams, _, tcfg, model, _ = setup
    rng = np.random.RandomState(1)
    pat = rng.randint(1, 120, size=8).astype(np.int32)
    prompts = [np.tile(pat, 6), rng.randint(1, 120, size=40).astype(np.int32)]
    base = port_paged_results(tcfg, model, prompts)
    chunked_spec = port_paged_results(tcfg, model, prompts, prefill_chunk=16, interleave_steps=2,
                                      speculative=True)
    # JAX's own test holds its chunked speculative stream to its base one.
    assert base == chunked_spec == jax_paged_results(jcfg, jparams, prompts)


def test_moe_int8_weights_serve_like_jax(setup):
    jcfg, _, jq, tcfg, _, qmodel = setup
    prompt = np.random.RandomState(2).randint(1, 120, size=10).astype(np.int32)
    want = np.asarray(JaxEngine(jcfg, jq, batch_size=1, max_len=256).generate(
        prompt.reshape(1, -1), max_new_tokens=8).tokens)[0]
    dense = Engine(tcfg, qmodel, batch_size=1, max_len=256, device="cpu").generate(
        prompt.reshape(1, -1), max_new_tokens=8).tokens[0]
    assert list(dense) == list(want)
    assert port_paged_results(tcfg, qmodel, [prompt], max_new=8)[0] == list(want)


def test_moe_dense_speculative_and_chunked_like_jax(setup):
    """The dense Engine's chunked prefill and speculative generation on the
    MoE model, route for route with JAX's (chunked and one-shot prefill
    route differently once the capacity is below S, so each is compared
    with JAX's own)."""
    jcfg, jparams, _, tcfg, model, _ = setup
    prompt = np.tile(np.random.RandomState(5).randint(1, 120, size=6), 4)[None].astype(np.int32)
    jeng = JaxEngine(jcfg, jparams, batch_size=1, max_len=256)
    eng = Engine(tcfg, model, batch_size=1, max_len=256, device="cpu")
    got = eng.generate_speculative(prompt, max_new_tokens=16, gamma=4)
    want = jeng.generate_speculative(jnp.asarray(prompt), max_new_tokens=16, gamma=4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.spec_stats == want.spec_stats
    t, _ = eng.prefill_chunked(prompt, chunk_size=8)
    jt, _ = jeng.prefill_chunked(jnp.asarray(prompt), chunk_size=8)
    assert t.tolist() == np.asarray(jt).tolist()


def test_spec_decode_with_prefix_cache():
    """Speculative drain on a prefix-cache engine: draft K/V writes land in
    private blocks, so the shared prefix blocks come through byte-stable;
    the port's streams equal its non-speculative engine's and JAX's."""
    jcfg = jl.LlamaConfig(
        vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, dtype=jnp.float32, param_dtype=jnp.float32,
        remat=False,
    )
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    model = to_port(jparams, tcfg)
    rng = np.random.RandomState(4)
    base = rng.randint(1, 60, size=48).astype(np.int32)
    prompts = [np.concatenate([base, rng.randint(1, 60, size=5).astype(np.int32)])
               for _ in range(3)]

    def run(make, spec):
        eng = make(slots=4, max_len=256, block_size=16, prefix_cache=True)
        rids = []
        for p in prompts:
            rids.append(eng.submit(p, max_new_tokens=16))
            eng.step_n(2)
        if spec:
            eng.run_until_drained_speculative(gamma=4)
        else:
            eng.run_until_drained()
        return [eng.result(r) for r in rids], dict(eng.stats_prefix)

    port = lambda **kw: PagedBatchEngine(tcfg, model, device="cpu", **kw)
    want, p0 = run(port, False)
    got, p1 = run(port, True)
    assert want == got
    assert p1["hit_tokens"] == p0["hit_tokens"] > 0
    jwant, jp = run(lambda **kw: JaxPagedBatchEngine(jcfg, jparams, **kw), True)
    assert got == jwant and p1["hit_tokens"] == jp["hit_tokens"]
