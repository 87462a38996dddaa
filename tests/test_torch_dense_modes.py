"""The port's dense Engine modes held to the JAX Engine on the CPU: chunked
prefill, the streamed chunked prefill and n-gram speculative decoding, on
the same converted weights and prompts (the cases of tests/test_serving.py
and tests/test_decode_pipeline.py's test_speculative_flushes_pipeline).

Greedy streams and first tokens must be token-identical to JAX's. The
streamed prefill's arrays must equal the port's own final cache rows byte
for byte, and JAX's arrays in keys, row ranges, shapes, dtypes and token
bytes; their K/V values agree within 1e-5 (f32), 2e-2 (bf16), or equal up
to a 1-off int8 value with scales within 2e-5, since the two frameworks'
f32 sums differ in the last bits: the port's computed arrays are not
byte-identical to JAX's. test_stream_bytes_equal_jax_given_the_same_cache
holds only the wire format: with JAX's rows written into the port's cache
as each chunk lands, the port emits JAX's arrays byte for byte (its
slicing and host conversion, not the values it computes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lws_tpu_torch.serving.engine as tengine
from lws_tpu.models import llama as jl
from lws_tpu.serving import Engine as JaxEngine
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.engine import Engine
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine


def build(jcfg):
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def tiny(**kw):
    """tests/test_serving.py's config."""
    base = dict(vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, dtype=jnp.float32, remat=False)
    return build(jl.LlamaConfig(**{**base, **kw}))


@pytest.fixture(scope="module")
def model():
    return tiny()


def engines(model, **kw):
    jcfg, jparams, tcfg, tparams = model
    return JaxEngine(jcfg, jparams, **kw), Engine(tcfg, tparams, device="cpu", **kw)


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Chunked prefill (tests/test_serving.py:157-197)


@pytest.mark.parametrize("S", [32, 40])  # an exact multiple of the chunk, and a padded tail
def test_chunked_prefill_matches_full_prefill_and_jax(model, S):
    jax_eng, eng = engines(model, batch_size=2, max_len=64)
    prompt = np.asarray(jax.random.randint(jax.random.key(S), (2, S), 0, 101), np.int32)
    t_full, c_full = eng.prefill(prompt)
    t_chunk, c_chunk = eng.prefill_chunked(prompt, chunk_size=16)
    j_tok, j_cache = jax_eng.prefill_chunked(jnp.asarray(prompt), chunk_size=16)
    assert torch.equal(t_full, t_chunk) and host(t_chunk).tolist() == host(j_tok).tolist()
    assert c_chunk.pos == int(j_cache.pos) == S
    np.testing.assert_allclose(c_chunk.k[:, :, :S].numpy(), np.asarray(j_cache.k)[:, :, :S],
                               rtol=1e-5, atol=1e-5)
    # Decode trajectories stay identical for several steps, and equal JAX's.
    for _ in range(6):
        t_full, c_full = eng.decode(t_full, c_full)
        t_chunk, c_chunk = eng.decode(t_chunk, c_chunk)
        j_tok, j_cache = jax_eng.decode(j_tok, j_cache)
        assert torch.equal(t_full, t_chunk) and host(t_chunk).tolist() == host(j_tok).tolist()


def test_chunked_prefill_short_prompt_delegates(model):
    _, eng = engines(model, batch_size=1, max_len=64)
    t, cache = eng.prefill_chunked(np.ones((1, 8), np.int32), chunk_size=16)
    assert cache.pos == 8 and t.shape == (1,)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.prefill_chunked(np.ones((1, 50), np.int32), chunk_size=48)  # pads to 96


def test_chunked_prefill_int8_cache_matches_jax():
    int8_model = tiny(kv_quant=True)
    jax_eng, eng = engines(int8_model, batch_size=1, max_len=64)
    prompt = np.asarray(jax.random.randint(jax.random.key(7), (1, 40), 0, 101), np.int32)
    t_chunk, c = eng.prefill_chunked(prompt, chunk_size=16)
    t_full, _ = eng.prefill(prompt)
    j_tok, _ = jax_eng.prefill_chunked(jnp.asarray(prompt), chunk_size=16)
    assert torch.equal(t_chunk, t_full) and host(t_chunk).tolist() == host(j_tok).tolist()
    assert c.k_scale is not None and c.k.dtype == torch.int8


# ---------------------------------------------------------------------------
# The streamed chunked prefill


STREAM_CONFIGS = {"f32": {}, "bf16": {"dtype": jnp.bfloat16},
                  "int8": {"kv_quant": True}}


@pytest.fixture(scope="module", params=list(STREAM_CONFIGS))
def stream_model(request, model):
    return (request.param, model if request.param == "f32"
            else tiny(**STREAM_CONFIGS[request.param]))


def stream(engine, prompt, chunk, **kw):
    out = []
    token, cache, stats = engine.prefill_chunked_stream(
        prompt, chunk, emit=lambda lo, hi, arrays: out.append((lo, hi, arrays)), **kw)
    return host(token), cache, stats, out


def assert_same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


def wire_name(a) -> str:
    """The dtype name an array goes on the KV wire under: the port's bf16
    (uint16 bits tagged BF16) and JAX's ml_dtypes bf16 are both "bfloat16"."""
    return "bfloat16" if kt.is_bfloat16(a) else a.dtype.name


def as_f32(a) -> np.ndarray:
    return (kt.to_tensor(a, torch.device("cpu")).float().numpy() if kt.is_bfloat16(a)
            else a.astype(np.float32))


def jax_stream(stream_model, prompt, chunk):
    _, (jcfg, jparams, _, _) = stream_model
    return stream(JaxEngine(jcfg, jparams, batch_size=1, max_len=64), jnp.asarray(prompt), chunk)


PROMPT = np.random.default_rng(11).integers(1, 101, (1, 21)).astype(np.int32)


def test_stream_emits_the_final_cache_rows_and_matches_prefill_chunked(stream_model):
    name, (_, _, tcfg, tparams) = stream_model
    eng = Engine(tcfg, tparams, batch_size=1, max_len=64, device="cpu")
    token, cache, stats, out = stream(eng, PROMPT, 8)
    assert stats["chunks"] == 3 and stats["gather_s"] >= 0
    assert [x[:2] for x in out] == [(0, 8), (8, 16), (16, 21)]
    assert cache.pos == 21
    keys = ("k", "v", "k_scale", "v_scale", "tokens") if name == "int8" else ("k", "v", "tokens")
    for lo, hi, arrays in out:
        assert sorted(arrays) == sorted(keys)
        for key in keys[:-1]:
            assert_same_bytes(arrays[key], kt.host_array(getattr(cache, key)[:, :, lo:hi]))
        assert_same_bytes(arrays["tokens"], PROMPT[:, lo:hi])
    t_chunk, c_chunk = Engine(tcfg, tparams, batch_size=1, max_len=64,
                              device="cpu").prefill_chunked(PROMPT, chunk_size=8)
    assert token.tolist() == host(t_chunk).tolist() and c_chunk.pos == cache.pos
    assert torch.equal(c_chunk.k, cache.k) and torch.equal(c_chunk.v, cache.v)
    # The serial ring emits the same chunks.
    _, _, _, serial = stream(Engine(tcfg, tparams, batch_size=1, max_len=64, device="cpu"),
                             PROMPT, 8, ring_depth=0)
    for (lo, hi, a), (lo2, hi2, b) in zip(out, serial):
        assert (lo, hi) == (lo2, hi2)
        assert_same_bytes(a["k"], b["k"])


def test_stream_matches_jax_arrays(stream_model):
    name, (jcfg, jparams, tcfg, tparams) = stream_model
    j_token, j_cache, j_stats, want = jax_stream(stream_model, PROMPT, 8)
    token, cache, stats, got = stream(Engine(tcfg, tparams, batch_size=1, max_len=64,
                                             device="cpu"), PROMPT, 8)
    assert token.tolist() == j_token.tolist()
    assert stats["chunks"] == j_stats["chunks"] == 3 and cache.pos == int(j_cache.pos)
    for (lo, hi, a), (jlo, jhi, b) in zip(got, want):
        assert (lo, hi) == (jlo, jhi) and sorted(a) == sorted(b)
        assert_same_bytes(a["tokens"], b["tokens"])
        for key in ("k", "v"):
            assert wire_name(a[key]) == wire_name(b[key]) and a[key].shape == b[key].shape
            x, y = as_f32(a[key]), as_f32(b[key])
            if name == "int8":
                assert np.abs(x - y).max() <= 1
                np.testing.assert_allclose(a[key + "_scale"], b[key + "_scale"], rtol=2e-5)
            else:
                tol = 2e-2 if name == "bf16" else 1e-5
                np.testing.assert_allclose(x, y, rtol=tol, atol=tol)


def test_stream_bytes_equal_jax_given_the_same_cache(stream_model, monkeypatch):
    """The wire format only: JAX's final cache rows are written into the
    port's cache as each chunk lands, and the port then emits JAX's arrays
    byte for byte. The values the port computes are held to JAX's within
    tolerance by test_stream_matches_jax_arrays."""
    _, (jcfg, jparams, tcfg, tparams) = stream_model
    _, j_cache, _, want = jax_stream(stream_model, PROMPT, 8)
    jax_rows = {}
    for key in ("k", "v", "k_scale", "v_scale"):
        a = getattr(j_cache, key)
        if a is not None:
            a = np.asarray(a)
            jax_rows[key] = (torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
                             if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy()))
    real = tengine.forward_prefill_chunk

    def with_jax_rows(params, tokens, cache, *args, **kw):
        lo = cache.pos
        hidden, cache = real(params, tokens, cache, *args, **kw)
        for key, rows in jax_rows.items():
            getattr(cache, key)[:, :, lo:cache.pos] = rows[:, :, lo:cache.pos]
        return hidden, cache

    monkeypatch.setattr(tengine, "forward_prefill_chunk", with_jax_rows)
    _, _, _, got = stream(Engine(tcfg, tparams, batch_size=1, max_len=64, device="cpu"),
                          PROMPT, 8)
    assert len(got) == len(want) == 3
    for (lo, hi, a), (jlo, jhi, b) in zip(got, want):
        assert (lo, hi) == (jlo, jhi) and sorted(a) == sorted(b)
        for key in a:  # same dtype name, shape and bytes on the wire
            assert kt.arrays_to_bytes(x=a[key]) == kt.arrays_to_bytes(x=b[key]), key


def test_stream_refuses_an_empty_or_oversized_prompt(model):
    _, eng = engines(model, batch_size=1, max_len=64)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill_chunked_stream(np.zeros((1, 0), np.int32), 8, emit=lambda *a: None)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.prefill_chunked_stream(np.ones((1, 50), np.int32), 48, emit=lambda *a: None)


# ---------------------------------------------------------------------------
# Speculative decoding (tests/test_serving.py:299-390)


REPETITIVE = np.asarray([[5, 9, 2, 11] * 4], np.int32)  # 16 tokens


def test_speculative_decoding_exact_and_accepting(model):
    jax_eng, eng = engines(model, batch_size=1, max_len=64)
    want = eng.generate(REPETITIVE, max_new_tokens=24)
    got = eng.generate_speculative(REPETITIVE, max_new_tokens=24, gamma=6, ngram=3)
    jgot = jax_eng.generate_speculative(jnp.asarray(REPETITIVE), max_new_tokens=24, gamma=6,
                                        ngram=3)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.tokens, host(jgot.tokens))
    assert got.spec_stats == jgot.spec_stats
    assert got.spec_stats["dispatches"] < 23 and got.spec_stats["accepted"] > 0

    # A non-repetitive prompt: still exact (drafts mostly rejected).
    prompt2 = np.asarray(jax.random.randint(jax.random.key(7), (1, 12), 0, 101), np.int32)
    want2 = eng.generate(prompt2, max_new_tokens=16)
    got2 = eng.generate_speculative(prompt2, max_new_tokens=16, gamma=4, ngram=2)
    jgot2 = jax_eng.generate_speculative(jnp.asarray(prompt2), max_new_tokens=16, gamma=4,
                                         ngram=2)
    np.testing.assert_array_equal(got2.tokens, want2.tokens)
    np.testing.assert_array_equal(got2.tokens, host(jgot2.tokens))


def test_speculative_decoding_near_max_len(model):
    """The verify run never overruns max_len: near the boundary the engine
    finishes with single decode steps, still exact."""
    jax_eng, eng = engines(model, batch_size=1, max_len=32)
    prompt = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6] * 2], np.int32)
    want = eng.generate(prompt, max_new_tokens=16)
    got = eng.generate_speculative(prompt, max_new_tokens=16, gamma=8, ngram=3)
    jgot = jax_eng.generate_speculative(jnp.asarray(prompt), max_new_tokens=16, gamma=8, ngram=3)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.tokens, host(jgot.tokens))
    assert got.spec_stats == jgot.spec_stats


def test_speculative_decoding_sync_loop_exact(model):
    """pipeline_depth=0 emits the stream of the overlapped loop."""
    _, _, tcfg, tparams = model
    e_sync = Engine(tcfg, tparams, batch_size=1, max_len=64, pipeline_depth=0, device="cpu")
    e_pipe = Engine(tcfg, tparams, batch_size=1, max_len=64, pipeline_depth=2, device="cpu")
    want = e_sync.generate_speculative(REPETITIVE, max_new_tokens=24, gamma=6)
    got = e_pipe.generate_speculative(REPETITIVE, max_new_tokens=24, gamma=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.spec_stats["accepted"] == want.spec_stats["accepted"]


def test_decode_speculative_matches_decode_n(model):
    """decode_speculative continues a prefilled cache as decode_n does, with
    and without the prompt seeding the drafting history, and as JAX's."""
    jax_eng, eng = engines(model, batch_size=1, max_len=64)
    steps = 24
    token, cache = eng.prefill(REPETITIVE)
    _, _, want = eng.decode_n(token, cache, steps)
    for context in (REPETITIVE[0], None):
        token2, cache2 = eng.prefill(REPETITIVE)
        _, cache2, got = eng.decode_speculative(token2, cache2, steps, gamma=4, ngram=3,
                                                pos=16, context=context)
        np.testing.assert_array_equal(got, want.numpy())
        assert cache2.pos == 16 + steps
        j_token, j_cache = jax_eng.prefill(jnp.asarray(REPETITIVE))
        _, _, jgot = jax_eng.decode_speculative(
            j_token, j_cache, steps, gamma=4, ngram=3, pos=16,
            context=None if context is None else jnp.asarray(context))
        np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_decode_speculative_near_max_len_exact_count(model, pipeline_depth):
    """The pipelined single-step tail produces exactly `steps` tokens and
    never appends K/V past max_len."""
    _, _, tcfg, tparams = model
    eng = Engine(tcfg, tparams, batch_size=1, max_len=32, pipeline_depth=pipeline_depth,
                 device="cpu")
    prompt = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6] * 3], np.int32)  # 24 tokens
    token, cache = eng.prefill(prompt)
    _, _, want = eng.decode_n(token, cache, 7)
    token2, cache2 = eng.prefill(prompt)
    _, cache2, got = eng.decode_speculative(token2, cache2, 7, gamma=4, ngram=3, pos=24,
                                            context=prompt[0])
    assert got.shape == (1, 7)
    assert cache2.pos <= 32
    np.testing.assert_array_equal(got, want.numpy())


def test_speculative_refuses_sampling_and_batches(model):
    _, _, tcfg, tparams = model
    from lws_tpu_torch.serving.engine import SamplingParams

    hot = Engine(tcfg, tparams, batch_size=1, max_len=64, device="cpu",
                 sampling=SamplingParams(temperature=1.0))
    with pytest.raises(NotImplementedError, match="greedy-only"):
        hot.generate_speculative(REPETITIVE, 4)
    wide = Engine(tcfg, tparams, batch_size=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="B=1"):
        wide.generate_speculative(np.tile(REPETITIVE, (2, 1)), 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        Engine(tcfg, tparams, batch_size=1, max_len=32, device="cpu").generate_speculative(
            REPETITIVE, 20)


def test_speculative_flushes_pipeline():
    """tests/test_decode_pipeline.py:304 on the port's paged engine: a chunk
    in flight before the speculative drain, the streams of the plain
    synchronous engine, and JAX's."""
    jcfg, jparams, tcfg, tparams = build(jl.LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq_len=128, dtype=jnp.float32, param_dtype=jnp.float32, remat=False))
    r = np.random.RandomState(41)
    ps = [r.randint(1, 255, size=r.randint(4, 40)).astype(np.int32) for _ in range(2)]

    def plain(make):
        eng = make(pipeline_depth=0)
        ids = [eng.submit(p, max_new_tokens=10) for p in ps]
        eng.run_until_drained()
        return [eng.result(i) for i in ids]

    kw = dict(slots=2, max_len=64, block_size=8)
    port = lambda **extra: PagedBatchEngine(tcfg, tparams, device="cpu", **kw, **extra)
    eng = port(pipeline_depth=2)
    ids = [eng.submit(p, max_new_tokens=10) for p in ps]
    eng.step_n(1)  # a chunk in flight before the speculative dispatch
    assert len(eng._pipeline) == 1
    eng.run_until_drained_speculative()
    assert not eng._pipeline
    got = [eng.result(i) for i in ids]
    assert got == plain(port) == plain(lambda **extra: JaxPagedBatchEngine(jcfg, jparams, **kw,
                                                                          **extra))
