"""Tensor-parallel dense serving of the port against the JAX package: gloo
ranks run the port's `Engine(mesh=...)` on JAX's full weights (the engine
shards them itself, through shard_params_for_serving), as in
tests/test_torch_tp_serving.py, whose member machinery this file reuses.
Rank 0's greedy tokens must equal JAX's Engine on the same mesh shape and
JAX's single-device Engine token for token, every rank's tokens must be
identical, each rank's cache holds batch/dp rows and Hkv/tp heads, and at
tp = 4 every rank's shards equal JAX's. f32 tiny configs throughout.

The cases mirror tests/test_serving_tp.py: tp in {2, 4}, decode_n staying
sharded, the dp axis, int8 KV, speculative decoding exact, indivisible
heads refused. The JAX-only case has no counterpart:
test_tp_engine_warm_compile_donates checks JAX's ahead-of-time compile and
buffer donation, and the port compiles nothing ahead of time (its cache is
updated in place).
"""

import numpy as np
import pytest

from tests.test_torch_tp_serving import (
    _params,
    _shards,
    assert_shards_equal_jax,
    jax_mesh,
    jax_shards,
    port_tree,
    run_refused,
    spawn_cases,
    tiny_cfg,
)

MAX_LEN = 64


def run_dense(case, mesh) -> dict:
    """Engine(mesh=...) on the full weights: generate, decode_n after a
    prefill, or generate_speculative; then the cache shapes of a prefill."""
    from lws_tpu_torch.serving.engine import Engine

    eng = Engine(case["cfg"], _params(case), batch_size=case["batch"], max_len=MAX_LEN,
                 mesh=mesh, device="cpu")
    p, n = case["prompt"], case["max_new"]
    if case["mode"] == "generate":
        tokens = eng.generate(p, max_new_tokens=n).tokens
    elif case["mode"] == "speculative":
        tokens = eng.generate_speculative(p, max_new_tokens=n, gamma=6, ngram=3).tokens
    else:
        token, cache = eng.prefill(p)
        _, cache, toks = eng.decode_n(token, cache, n)
        tokens = toks.numpy()
    _, cache = eng.prefill(p)
    return {"tokens": np.asarray(tokens).tolist(),
            "cache": [tuple(t.shape) for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                      if t is not None],
            "shards": _shards(eng.params) if case.get("shards") else None}


RUNNERS = {"dense": run_dense, "refused": run_refused}


def dense_cfg(**kw):
    import jax.numpy as jnp

    from lws_tpu.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
                       d_ff=128, max_seq_len=128, dtype=jnp.float32, param_dtype=jnp.float32,
                       remat=False, **kw)


@pytest.fixture(scope="module")
def setups():
    import jax

    from lws_tpu.models.llama import init_params
    from lws_tpu_torch.models.convert import config_from_jax

    out = {}
    for name, jcfg in (("plain", dense_cfg()), ("kv8", dense_cfg(kv_quant=True)),
                       ("small_kv", tiny_cfg())):
        jp = jax.jit(lambda c=jcfg: init_params(c, jax.random.key(0)))()
        out[name] = dict(jcfg=jcfg, jparams=jp, cfg=config_from_jax(jcfg), tree=port_tree(jp))
    prompt = np.asarray(jax.random.randint(jax.random.key(1), (2, 24), 0, 256), np.int32)
    spec_prompt = np.asarray([[5, 9, 2, 11] * 4], np.int32)
    return out, prompt, spec_prompt


def case(setup, name, dp, tp, mode="generate", batch=2, prompt=None, max_new=16, **kw):
    return {"name": name, "dp": dp, "tp": tp, "run": kw.pop("run", "dense"), "cfg": setup["cfg"],
            "tree": setup["tree"], "mode": mode, "batch": batch, "prompt": prompt,
            "max_new": max_new, **kw}


@pytest.fixture(scope="module")
def world2(setups, tmp_path_factory):
    s, p, sp = setups
    cases = [case(s["plain"], "tp2", 1, 2, prompt=p),
             case(s["kv8"], "kv8", 1, 2, prompt=p, max_new=8),
             case(s["plain"], "spec", 1, 2, mode="speculative", batch=1, prompt=sp, max_new=20)]
    return spawn_cases(2, cases, tmp_path_factory.mktemp("dense2"), __name__)


@pytest.fixture(scope="module")
def world4(setups, tmp_path_factory):
    s, p, _ = setups
    cases = [case(s["plain"], "tp4", 1, 4, prompt=p, shards=True),
             case(s["plain"], "decode_n", 1, 4, mode="decode_n", prompt=p, max_new=8),
             case(s["plain"], "dp2_tp2", 2, 2, prompt=p, max_new=8),
             case(s["small_kv"], "refused", 1, 4, run="refused", engine_cls="dense",
                  engine={"batch_size": 2, "max_len": MAX_LEN})]
    return spawn_cases(4, cases, tmp_path_factory.mktemp("dense4"), __name__)


def jax_generate(setup, prompt, n, mesh=None, batch=2, speculative=False):
    from lws_tpu.serving import Engine

    eng = Engine(setup["jcfg"], setup["jparams"], batch_size=batch, max_len=MAX_LEN, mesh=mesh)
    if speculative:
        return np.asarray(eng.generate_speculative(prompt, max_new_tokens=n, gamma=6,
                                                   ngram=3).tokens).tolist()
    return np.asarray(eng.generate(prompt, max_new_tokens=n).tokens).tolist()


def check_ranks(results, name, want, cfg, dp, tp, batch=2):
    for r, res in enumerate(results):
        got = res[name]
        assert got["tokens"] == want, (r, got["tokens"], want)
        for shape in got["cache"]:  # [L, B/dp, T, Hkv/tp(, hd)] on every rank
            assert (shape[1], shape[3]) == (batch // dp, cfg.n_kv_heads // tp), (r, shape)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_matches_jax_and_single_device(setups, world2, world4, tp):
    s, p, _ = setups
    want = jax_generate(s["plain"], p, 16)
    assert jax_generate(s["plain"], p, 16, mesh=jax_mesh(1, tp)) == want
    check_ranks(world2 if tp == 2 else world4, f"tp{tp}", want, s["plain"]["cfg"], 1, tp)


def test_tp_engine_decode_n_stays_sharded(setups, world4):
    """decode_n keeps every rank's cache on its Hkv/tp heads across the
    steps, and its tokens are JAX's single-device decode_n's."""
    from lws_tpu.serving import Engine

    s, p, _ = setups
    eng = Engine(s["plain"]["jcfg"], s["plain"]["jparams"], batch_size=2, max_len=MAX_LEN)
    token, cache = eng.prefill(p)
    _, _, toks = eng.decode_n(token, cache, 8)
    check_ranks(world4, "decode_n", np.asarray(toks).tolist(), s["plain"]["cfg"], 1, 4)
    assert np.asarray(world4[0]["decode_n"]["tokens"]).shape == (2, 8)


def test_tp_engine_dp_axis(setups, world4):
    """(dp=2, tp=2): the batch splits over dp (one row per dp rank), heads
    over tp; the tokens gathered back are JAX's."""
    s, p, _ = setups
    want = jax_generate(s["plain"], p, 8)
    assert jax_generate(s["plain"], p, 8, mesh=jax_mesh(2, 2)) == want
    check_ranks(world4, "dp2_tp2", want, s["plain"]["cfg"], 2, 2)


def test_tp_engine_rejects_indivisible_heads(setups, world4):
    from lws_tpu.serving import Engine

    s, _, _ = setups
    with pytest.raises(ValueError, match="n_kv_heads"):
        Engine(s["plain"]["jcfg"], s["plain"]["jparams"], batch_size=2, max_len=MAX_LEN,
               mesh=jax_mesh(1, 8))
    for res in world4:
        assert res["refused"] == "n_kv_heads=2 not divisible by tp=4"


def test_tp_engine_kv_quant(setups, world2):
    """int8 KV under tp: the scale caches shard with their values."""
    s, p, _ = setups
    want = jax_generate(s["kv8"], p, 8)
    assert jax_generate(s["kv8"], p, 8, mesh=jax_mesh(1, 2)) == want
    check_ranks(world2, "kv8", want, s["kv8"]["cfg"], 1, 2)
    assert len(world2[0]["kv8"]["cache"]) == 4


def test_tp_engine_speculative_decoding_exact(setups, world2):
    """generate_speculative under tp equals the single-device greedy
    generate, as JAX's sharded speculative run does."""
    s, _, sp = setups
    want = jax_generate(s["plain"], sp, 20, batch=1)
    assert jax_generate(s["plain"], sp, 20, mesh=jax_mesh(1, 2), batch=1,
                        speculative=True) == want
    check_ranks(world2, "spec", want, s["plain"]["cfg"], 1, 2, batch=1)


def test_every_rank_holds_jax_shard_at_tp4(setups, world4):
    s, _, _ = setups
    mesh = jax_mesh(1, 4)
    for r, res in enumerate(world4):
        assert_shards_equal_jax(res["tp4"]["shards"],
                                jax_shards(s["plain"]["jcfg"], s["plain"]["jparams"], mesh, r))


def test_ranks_agree(world2, world4):
    for results in (world2, world4):
        for res in results[1:]:
            for name, got in res.items():
                want = results[0][name]
                if isinstance(got, str):
                    assert got == want, name
                else:
                    assert got["tokens"] == want["tokens"], name

