"""The port's speculative decoding in the PagedBatchEngine
(lws_tpu_torch/serving/paged_engine.py: step_speculative, its host-loop
oracle step_speculative_sync, run_until_drained_speculative) and its model
functions (forward_verify_paged, ngram_draft, speculative_accept) held to the
JAX package on the CPU, case by case after tests/test_paged_speculative.py;
its TP-mesh case runs in tests/test_torch_tp_serving.py's world-2 spawn.

Both engines run the same converted f32 weights and prompts, the JAX one on
its Pallas paged kernel in interpret mode. Greedy streams must be
token-identical to JAX's and to the port's own non-speculative engine, and
the device-resident loop's to the sync oracle's; dispatch and acceptance
counts must equal JAX's. Sampled and mixed batches are held inside the port
(the frameworks' generators differ): the same seed gives the same stream,
speculative or not, device loop or oracle. The verify pass's logits are held
to JAX's at 1e-4 and its K/V writes at 2e-5 (f32 summation order, as
tests/test_torch_model.py); drafts and acceptance exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models import llama as jl
from lws_tpu.serving.engine import Engine as JaxEngine
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

TOL = 2e-5
LOGIT_TOL = 1e-4
KW = dict(slots=4, max_len=256, block_size=16)
SAMPLED = dict(temperature=0.8, seed=7, top_k=10)


def build(jcfg):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def model():
    """tests/test_paged_speculative.py's model."""
    return build(jl.LlamaConfig(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=128, max_seq_len=256, dtype=jnp.float32,
                                param_dtype=jnp.float32, remat=False))


@pytest.fixture(scope="module")
def model_int8(model):
    jcfg, jparams, tcfg, tparams = model
    tq = tl.Llama(dataclasses.replace(tcfg, kv_quant=True), "cpu")
    tq.load_state_dict(tparams.state_dict())
    return dataclasses.replace(jcfg, kv_quant=True), jparams, tq.cfg, tq


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")


def jax_engine(model, **kw):
    return JaxPagedBatchEngine(model[0], model[1], **kw)


def port_engine(model, **kw):
    return PagedBatchEngine(model[2], model[3], device="cpu", **kw)


def prompts():
    rng = np.random.RandomState(0)
    pat = rng.randint(1, 60, size=8).astype(np.int32)
    return [np.tile(pat, 6), rng.randint(1, 60, size=20).astype(np.int32)]


PAT = np.tile(np.arange(1, 9, dtype=np.int32), 6)


def run(engine, spec, sampled_second=False, sync=False):
    p1, p2 = prompts()
    kw = SAMPLED if sampled_second else {}
    rids = [engine.submit(p1, max_new_tokens=24), engine.submit(p2, max_new_tokens=16, **kw)]
    if spec:
        engine.run_until_drained_speculative(gamma=4, ngram=3, sync=sync)
    else:
        engine.run_until_drained()
    return [engine.result(r) for r in rids]


def spec_counts(engine) -> dict:
    return {k: engine.stats.get(k, 0) for k in
            ("spec_dispatches", "spec_drafted", "spec_accepted", "spec_fallback_dispatches")}


# ---------------------------------------------------------------------------
# Engine cases


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32_kv", "int8_kv"])
def test_greedy_spec_matches_jax_oracle_and_plain(model, model_int8, jax_kernel, kv_quant):
    """The device loop against the JAX engine's, the port's sync oracle and
    its plain engine: equal streams, equal counts, fewer dispatches than
    sequential decode (23 + 15 steps), drafts accepted."""
    m = model_int8 if kv_quant else model
    jeng, teng = jax_engine(m, **KW), port_engine(m, **KW)
    want = run(jeng, spec=True)
    assert run(teng, spec=True) == want
    oracle = port_engine(m, **KW)
    assert run(oracle, spec=True, sync=True) == want
    assert run(port_engine(m, **KW), spec=False) == want
    counts = spec_counts(teng)
    assert counts == spec_counts(jeng)
    assert counts["spec_accepted"] == oracle.stats["spec_accepted"] > 0
    assert counts["spec_dispatches"] < 38
    assert counts["spec_drafted"] >= counts["spec_accepted"]
    assert teng.pool_accounting() == jeng.pool_accounting()


@pytest.mark.parametrize("depth", [0, 2])
def test_mixed_sampled_greedy_batch_is_exact(model, depth):
    """A greedy and a seeded sampled slot: the device loop (ring depth 0 and
    2), the sync oracle and the plain engine give the same streams."""
    want = run(port_engine(model, **KW), spec=False, sampled_second=True)
    eng = port_engine(model, pipeline_depth=depth, **KW)
    assert run(eng, spec=True, sampled_second=True) == want
    assert run(port_engine(model, **KW), spec=True, sampled_second=True, sync=True) == want
    assert eng.stats["spec_dispatches"] > 0


def test_near_max_len_falls_back_like_jax(model, jax_kernel):
    """A slot within gamma + 1 of max_len refuses the wide verify and drains
    by single steps, exactly."""

    def go(engine):
        rid = engine.submit(np.arange(1, 50, dtype=np.int32), max_new_tokens=14)
        assert engine.step_speculative(gamma=20) is False
        engine.run_until_drained_speculative(gamma=8)
        return engine.result(rid), spec_counts(engine)

    kw = dict(slots=2, max_len=64, block_size=16)
    got = go(port_engine(model, **kw))
    assert got == go(jax_engine(model, **kw))
    plain = port_engine(model, **kw)
    rid = plain.submit(np.arange(1, 50, dtype=np.int32), max_new_tokens=14)
    plain.run_until_drained()
    assert got[0] == plain.result(rid)


def test_device_loop_on_the_ring_equals_sync_oracle_and_jax(model, jax_kernel):
    """Ring depth 2 against the depth-0 host-loop oracle: identical streams
    and acceptance, no more dispatches; the JAX device loop agrees."""
    oracle = port_engine(model, pipeline_depth=0, **KW)
    want = run(oracle, spec=True, sync=True)
    eng = port_engine(model, pipeline_depth=2, **KW)
    assert run(eng, spec=True) == want
    jeng = jax_engine(model, pipeline_depth=2, donate_steps=False, **KW)
    assert run(jeng, spec=True) == want
    s, p = oracle.stats, eng.stats
    assert p["spec_accepted"] == s["spec_accepted"]
    assert (p["spec_dispatches"] + p["spec_fallback_dispatches"]
            <= s["spec_dispatches"] + s["spec_fallback_dispatches"])
    assert spec_counts(eng) == spec_counts(jeng)


def test_no_steady_state_flushes(model):
    """Ten ring-riding dispatches against deep budgets never flush the ring
    (speculation entry finds it empty and does not count)."""
    eng = port_engine(model, slots=2, max_len=256, block_size=16, pipeline_depth=2)
    assert eng.submit(prompts()[0], max_new_tokens=128) is not None
    for _ in range(10):
        assert eng.step_speculative(gamma=4, ngram=3) is True
    assert eng._pipeline.stats["flushes"] == 0
    assert eng._pipeline.stats["max_inflight"] == 2
    eng.run_until_drained_speculative(gamma=4, ngram=3)
    plain = port_engine(model, slots=2, max_len=256, block_size=16)
    assert eng.result(0) == drain_plain(plain, [prompts()[0]], [128])[0]


def drain_plain(engine, ps, budgets):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in zip(ps, budgets)]
    engine.run_until_drained()
    return [engine.result(r) for r in rids]


def test_mid_stream_admission_during_inflight_spec_matches_jax(model, jax_kernel):
    """An admission while speculative chunks are in flight seeds the new
    slot's device state without a flush; every stream matches the plain
    engine and the JAX engine's."""
    p1, p2 = prompts()

    def go(engine):
        r1 = engine.submit(p1, max_new_tokens=32)
        for _ in range(3):
            assert engine.step_speculative(gamma=4, ngram=3) is True
        flushes = engine._pipeline.stats["flushes"]
        r2 = engine.submit(p2, max_new_tokens=16)
        assert engine._pipeline.stats["flushes"] == flushes
        assert engine.step_speculative(gamma=4, ngram=3) is True
        engine.run_until_drained_speculative(gamma=4, ngram=3)
        return [engine.result(r1), engine.result(r2)], spec_counts(engine)

    teng = port_engine(model, pipeline_depth=2, **KW)
    got = go(teng)
    assert got == go(jax_engine(model, pipeline_depth=2, donate_steps=False, **KW))
    assert got[0] == drain_plain(port_engine(model, **KW), [p1, p2], [32, 16])


def test_early_retire_and_eviction_during_inflight_spec_match_jax(model, jax_kernel):
    """Uneven budgets retire a request inside in-flight chunks and a tight
    prefix-cache pool forces LRU eviction (whose allocator flushes the
    ring); streams, counts and pool state match JAX's and the plain
    engine."""
    kw = dict(slots=3, max_len=128, block_size=16, prefix_cache=True, num_blocks=17)
    p1, p2 = prompts()
    p3 = PAT

    def go(engine):
        r1 = engine.submit(p1, max_new_tokens=40)
        r2 = engine.submit(p2, max_new_tokens=6)
        for _ in range(4):
            engine.step_speculative(gamma=4, ngram=3)
        r3 = engine.submit(p3, max_new_tokens=12)
        assert r3 is not None
        engine.run_until_drained_speculative(gamma=4, ngram=3)
        return [engine.result(r) for r in (r1, r2, r3)], spec_counts(engine)

    teng = port_engine(model, pipeline_depth=2, **kw)
    jeng = jax_engine(model, pipeline_depth=2, donate_steps=False, **kw)
    got = go(teng)
    assert got == go(jeng)
    assert teng.stats_prefix["evictions"] == jeng.stats_prefix["evictions"]
    assert teng.pool_accounting() == jeng.pool_accounting()
    oracle = port_engine(model, **kw)
    want = drain_plain(oracle, [p1, p2], [40, 6]) + drain_plain(oracle, [p3], [12])
    assert got[0] == want


def test_step_n_between_spec_dispatches_refreshes_state(model, jax_kernel):
    """step_n stales the device history and budgets; the next speculative
    entry rebuilds them from host truth, exactly."""

    def go(engine):
        rid = engine.submit(prompts()[0], max_new_tokens=30)
        engine.step_speculative(gamma=4, ngram=3)
        engine.step_n(2)
        engine.step_speculative(gamma=4, ngram=3)
        engine.run_until_drained_speculative(gamma=4, ngram=3)
        return engine.result(rid), spec_counts(engine)

    kw = dict(slots=2, max_len=256, block_size=16)
    got = go(port_engine(model, pipeline_depth=2, **kw))
    assert got == go(jax_engine(model, pipeline_depth=2, donate_steps=False, **kw))
    assert got[0] == drain_plain(port_engine(model, **kw), [prompts()[0]], [30])[0]


def test_failed_push_rolls_back_to_host_truth(model):
    """A push that raises (the consume of the oldest chunk failing) drops
    everything in flight and restores positions and tokens from host truth;
    the drain then still gives the plain engine's stream."""
    kw = dict(slots=2, max_len=256, block_size=16)
    eng = port_engine(model, pipeline_depth=2, **kw)
    rid = eng.submit(prompts()[0], max_new_tokens=24)
    assert eng.step_speculative(gamma=4, ngram=3) is True  # one chunk in flight
    push = eng._pipeline.push

    def failing_push(*args):
        eng._pipeline.push = push  # fail once
        raise RuntimeError("injected dispatch failure")

    eng._pipeline.push = failing_push
    with pytest.raises(RuntimeError, match="injected"):
        eng.step_speculative(gamma=4, ngram=3)
    assert len(eng._pipeline) == 0 and eng._pipeline.stats["discarded"] == 1
    assert eng._spec_fresh is False
    eng.run_until_drained_speculative(gamma=4, ngram=3)
    assert eng.result(rid) == drain_plain(port_engine(model, **kw), [prompts()[0]], [24])[0]


def test_sampled_rows_never_extend_acceptance(model):
    """A sampled slot rides the wide verify but advances exactly one token
    per dispatch, even on maximally repetitive content; an all-sampled
    batch refuses the wide verify."""
    eng = port_engine(model, slots=2, max_len=256, block_size=16)
    rg = eng.submit(PAT, max_new_tokens=40)
    rs = eng.submit(PAT, max_new_tokens=40, temperature=0.8, seed=3)
    by_id = {r.request_id: r for r in eng._active.values()}
    for _ in range(10):
        before = len(by_id[rs].tokens)
        assert eng.step_speculative(gamma=4, ngram=3) is True
        eng._pipeline.flush()
        assert len(by_id[rs].tokens) - before == 1
    eng.run_until_drained_speculative(gamma=4, ngram=3)
    assert eng.stats["spec_accepted"] > 0
    assert len(eng.result(rg)) == len(eng.result(rs)) == 40
    plain = port_engine(model, slots=2, max_len=256, block_size=16)
    g = plain.submit(PAT, max_new_tokens=40)
    s = plain.submit(PAT, max_new_tokens=40, temperature=0.8, seed=3)
    plain.run_until_drained()
    assert [eng.result(rg), eng.result(rs)] == [plain.result(g), plain.result(s)]
    eng2 = port_engine(model, slots=2, max_len=256, block_size=16)
    eng2.submit(PAT, max_new_tokens=8, temperature=0.8, seed=1)
    assert eng2.step_speculative(gamma=4) is False


def test_ring_wrap_spec_history_matches_jax(model, jax_kernel):
    """A 16-token history window, smaller than the context, still drains
    exactly and keeps accepting on content whose period fits it."""

    def go(engine):
        rid = engine.submit(PAT, max_new_tokens=24)
        engine.run_until_drained_speculative(gamma=4, ngram=3)
        return engine.result(rid), spec_counts(engine)

    kw = dict(slots=2, max_len=256, block_size=16, spec_history=16)
    got = go(port_engine(model, **kw))
    assert got == go(jax_engine(model, **kw))
    assert got[1]["spec_accepted"] > 0
    plain = port_engine(model, slots=2, max_len=256, block_size=16)
    assert got[0] == drain_plain(plain, [PAT], [24])[0]


# ---------------------------------------------------------------------------
# Model functions


def contexts(rng):
    out = []
    for n in (5, 9, 17, 40, 63):
        pat = rng.randint(1, 60, size=max(2, n // 4))
        out.append([int(t) for t in np.tile(pat, 8)[:n]])  # repetitive: matches exist
        out.append([int(t) for t in rng.randint(1, 60, size=n)])  # random: mostly none
    return out


@pytest.mark.parametrize("ngram,gamma", [(2, 1), (2, 4), (3, 1), (3, 4)])
def test_ngram_draft_matches_host_drafter_and_jax(ngram, gamma):
    """Batched over slots: equal to Engine._draft_ngram (the port's and
    JAX's) when the window holds the whole context, and to JAX's
    ngram_draft on every history, ring wrap included (H = 16 < context)."""
    rng = np.random.RandomState(3)
    ctxs = contexts(rng)
    jdraft = jax.jit(jax.vmap(lambda h, n: jl.ngram_draft(h, n, ngram, gamma)))
    for H in (64, 16):
        hist = np.zeros((len(ctxs), H), np.int32)
        lens = np.array([len(c) for c in ctxs], np.int32)
        for b, c in enumerate(ctxs):
            W = min(len(c), H)
            hist[b, np.arange(len(c) - W, len(c)) % H] = c[-W:]
        got = tl.ngram_draft(torch.from_numpy(hist), torch.from_numpy(lens), ngram, gamma)
        assert got.dtype == torch.int32 and got.shape == (len(ctxs), gamma)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdraft(hist, lens)))
        if H == 64:
            for b, c in enumerate(ctxs):
                want = Engine._draft_ngram(list(c), ngram, gamma)
                assert want == JaxEngine._draft_ngram(list(c), ngram, gamma)
                assert got[b].tolist() == want, (c, ngram, gamma)


def test_speculative_accept_matches_jax():
    rng = np.random.RandomState(4)
    B, gamma = 64, 4
    greedy = rng.randint(0, 4, size=(B, gamma + 1)).astype(np.int32)
    drafts = np.where(rng.rand(B, gamma) < 0.7, greedy[:, :gamma],
                      rng.randint(0, 4, size=(B, gamma))).astype(np.int32)
    rem = rng.randint(0, gamma + 3, size=B).astype(np.int32)
    take, out = tl.speculative_accept(torch.from_numpy(drafts), torch.from_numpy(greedy),
                                      torch.from_numpy(rem))
    jtake, jout = jl.speculative_accept(jnp.asarray(drafts), jnp.asarray(greedy),
                                        jnp.asarray(rem))
    assert take.dtype == torch.int32
    np.testing.assert_array_equal(take.numpy(), np.asarray(jtake))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert len(set(take.tolist())) > 3  # accepted prefixes of several lengths


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32_kv", "int8_kv"])
def test_forward_verify_paged_matches_jax(model, model_int8, kv_quant):
    """Three slots (one released, on the null row) verify 5 tokens each at
    block-boundary and mid-block positions of a scrambled table: logits
    [B, S, V] and the pool after the scatter against JAX's."""
    jcfg, jparams, tcfg, tparams = model_int8 if kv_quant else model
    bs, nb, mb = 16, 12, 4
    rng = np.random.default_rng(5)
    table = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [9, 2, 5, 11]], np.int32)
    pos = np.array([15, 40, 30], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (3, 5)).astype(np.int32)
    # A pool of random K/V rows (quantized for int8) for both sides.
    kv = rng.standard_normal((2, jcfg.n_layers, nb, bs, jcfg.n_kv_heads, jcfg.head_dim),
                             dtype=np.float32)
    jpool = jl.init_paged_cache(jcfg, nb, bs)
    if kv_quant:
        (kq, ks), (vq, vs) = (jl._quantize_kv(jnp.asarray(a)) for a in kv)
        jpool = dataclasses.replace(jpool, k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        jpool = dataclasses.replace(jpool, k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
    tpool = tl.PagedKVCache(*(None if a is None else torch.from_numpy(np.array(a))
                              for a in (jpool.k, jpool.v, jpool.k_scale, jpool.v_scale)))
    verify = jax.jit(lambda p, t, c, tb, ps: jl.forward_verify_paged(p, t, c, tb, ps, jcfg))
    jlogits, jpool = verify(jparams, jnp.asarray(tokens), jpool, jnp.asarray(table),
                            jnp.asarray(pos))
    tlogits, tpool = tl.forward_verify_paged(tparams, torch.from_numpy(tokens), tpool,
                                             torch.from_numpy(table), torch.from_numpy(pos))
    assert tlogits.shape == (3, 5, jcfg.vocab_size) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    written = np.zeros((nb, bs), bool)  # the released slot's rows land in the null block
    for b in range(3):
        for p in range(pos[b], pos[b] + 5):
            written[table[b, p // bs], p % bs] = True
    assert written[0].sum() == 5 and written.sum() == 15
    for name, before in (("k", kv[0]), ("v", kv[1])):
        got, want = getattr(tpool, name).numpy(), np.asarray(getattr(jpool, name))
        if kv_quant:  # int8 values may differ by 1 at rounding ties
            diff = got.astype(int) - want.astype(int)
            assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
            np.testing.assert_allclose(getattr(tpool, name + "_scale").numpy(),
                                       np.asarray(getattr(jpool, name + "_scale")), rtol=TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(got[:, ~written], before[:, ~written])
