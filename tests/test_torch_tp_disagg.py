"""The disaggregated handoff under a tensor-parallel mesh, in process: gloo
ranks (one spawn of world 2, as tests/test_torch_tp_serving.py runs its
cases) drive the port's device seams and worker legs on a tp = 2 mesh, and
the tests hold what they made to the JAX package's single-device engine.

  * The twin of tests/test_serving.py:265: a tp = 2 prefill's cache is
    gathered into one bundle (`cache_to_bundle(..., mesh=)`, on tp rank 0),
    resharded onto a tp = 2 decode (`disagg_worker._decode_bundle`, which
    scatters the heads from rank 0), and the decoded tokens equal JAX's
    single-device `Engine.generate` exactly (f32). The bundle is the
    single-device engine's: the same spec, the same byte length, pos and
    token exact, K/V within the frameworks' f32 tolerance; given the same
    rows (f32, bf16, int8 with its scales), the gather's bytes equal JAX's
    single-device `cache_to_bundle` byte for byte.
  * Streamed under a mesh: `prefill_chunked_stream` gathers each chunk's
    heads on every rank and emits on rank 0 only; the chunks equal JAX's
    within the f32 tolerance, and the stream, assembled on the host and
    resharded, decodes JAX's tokens exactly.
  * Mixed frameworks: a JAX-made bundle decodes on the port's tp = 2
    decode side; each rank's cache holds exactly its heads of JAX's rows.
  * The prefix tiers at tp = 2 (tests/test_torch_prefix_hierarchy.py's
    scenarios): spill, host restore and HBM hit give JAX's single-device
    stats, pool accounting and streams; the spilled block's arena bytes
    equal the port's single-device engine's; a tp = 2 engine fetches from a
    single-device sibling's arena over the KV wire and a single-device
    engine from the tp = 2 engine's, each with JAX's stream.

The members import only the port; JAX runs in the test process."""

import numpy as np
import pytest

from tests.test_torch_tp_serving import port_tree, spawn_cases

STEPS = 6
MAX_LEN = 32
CHUNK = 4
TOL = 1e-5  # f32 K/V rows computed by the two frameworks
PREFIX_PROMPT = np.arange(1, 25, dtype=np.int32)  # 24 tokens: 1 shareable block
STATS = ("hit_tokens", "hit_blocks", "evictions", "spills", "host_hits", "remote_hits")


# ---------------------------------------------------------------------------
# Member side (port only)


def _model(case):
    from lws_tpu_torch.models.convert import params_from_jax

    return params_from_jax(case["tree"], case["cfg"], "cpu")


def run_handoff(case, mesh) -> dict:
    """The monolithic and streamed handoffs between two tp = 2 engines, and
    a JAX-made bundle decoded on the tp = 2 side."""
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt
    from lws_tpu_torch.serving.engine import Engine

    params = _model(case)
    pre, dec = (Engine(case["cfg"], params, batch_size=1, max_len=MAX_LEN, device="cpu",
                       mesh=mesh) for _ in range(2))
    rank0 = mesh.tp_rank == 0
    prompt = case["prompt"]
    out = {}
    token, cache = pre.prefill(prompt)
    out["bundle"] = kt.cache_to_bundle(cache, token, mesh=mesh)
    out["mono"], out["mono_stats"], out["mono_spans"] = dw._decode_bundle(dec, out["bundle"],
                                                                          STEPS)
    chunks = []
    emit = (lambda lo, hi, a: chunks.append((lo, hi, a))) if rank0 else None
    stoken, _, pstats = pre.prefill_chunked_stream(prompt, CHUNK, emit=emit)
    out["chunks"], out["stream_stats"] = chunks, pstats
    asm = None
    if rank0:  # the decode worker's host assembly of the stream
        asm = kt.CacheAssembler(max_len=MAX_LEN, device=False)
        for i, (lo, hi, arrays) in enumerate(chunks):
            asm.chunk({"chunk": i, "pos_range": [lo, hi]}, arrays)
        asm.finish({}, {"token": stoken.numpy(), "pos": np.asarray(prompt.shape[1], np.int32)})
    out["streamed"], out["streamed_stats"], _ = dw._decode_bundle(dec, asm, STEPS)
    jbundle = case["jax_bundle"] if rank0 else None
    jcache, _ = kt.bundle_to_cache(jbundle, max_len=MAX_LEN, device="cpu", mesh=mesh)
    out["jax_local"] = {n: getattr(jcache, n).numpy().copy() for n in ("k", "v")}
    out["jax_tokens"], _, _ = dw._decode_bundle(dec, jbundle, STEPS)
    return out


def run_gather(case, mesh) -> dict:
    """Each rank holds its heads of the given rows; the bundle gathered over
    tp (on rank 0) for each row kind."""
    import torch

    from lws_tpu_torch.models.llama import KVCache
    from lws_tpu_torch.serving import kv_transport as kt

    out = {}
    for kind, (rows, pos, token) in case["rows"].items():
        h = rows["k"].shape[3] // mesh.tp
        mine = {n: kt.to_tensor(np.ascontiguousarray(a[:, :, :, mesh.tp_rank * h:
                                                        (mesh.tp_rank + 1) * h]), "cpu")
                for n, a in rows.items()}
        cache = KVCache(k=mine["k"], v=mine["v"], pos=pos, k_scale=mine.get("k_scale"),
                        v_scale=mine.get("v_scale"))
        out[kind] = kt.cache_to_bundle(cache, torch.tensor(token, dtype=torch.int32), mesh=mesh)
    return out


def park_then_evict(engine, log) -> list:
    """tests/test_torch_prefix_hierarchy.py's spill sequence: park the
    prompt's shareable block, fill the pool, then a 1-block admission
    evicts (and spills) it. Returns the prompt's stream."""
    r = engine.submit(PREFIX_PROMPT, 8)
    engine.run_until_drained()
    oracle = engine.result(r)
    f1 = engine.submit(np.full((24,), 9, np.int32), 40)
    f2 = engine.submit(np.full((24,), 11, np.int32), 40)
    g = engine.submit(np.arange(30, 38, dtype=np.int32), 8)
    assert None not in (r, f1, f2, g)
    snapshot(engine, log, "evicting")
    engine.run_until_drained()
    snapshot(engine, log, "evicted")
    log.append(("oracle", oracle))
    return oracle


def snapshot(engine, log, label) -> None:
    log.append((label, {k: engine.stats_prefix[k] for k in STATS}, engine.pool_accounting()))


def submit_and_drain(engine, log, label) -> list:
    r = engine.submit(PREFIX_PROMPT, 8)
    assert r is not None
    snapshot(engine, log, f"{label}: admitted")
    engine.run_until_drained()
    snapshot(engine, log, f"{label}: drained")
    log.append((label, engine.result(r)))
    return engine.result(r)


def run_tiers(case, mesh) -> dict:
    """The prefix tiers beside a tp = 2 mesh: spill, host hit and HBM hit on
    engine A; a tp = 2 engine B warmed from a single-device sibling's arena,
    and a single-device engine C warmed from A's arena (rank 0's), each
    over the KV wire."""
    from lws_tpu_torch.parallel.collectives import broadcast_object
    from lws_tpu_torch.serving import kv_transport as kt
    from lws_tpu_torch.serving.kv_host_arena import KVHostArena
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    params = _model(case)
    rank0 = mesh.tp_rank == 0

    def engine(mesh_=mesh, **kw):
        return PagedBatchEngine(case["cfg"], params, max_len=64, block_size=16, device="cpu",
                                slots=4, num_blocks=10, prefix_cache=True, mesh=mesh_, **kw)

    out = {"log": []}
    arena_a = KVHostArena(64 << 20)
    a = engine(host_arena=arena_a)
    park_then_evict(a, out["log"])
    digest, = arena_a.digests()
    out["arena_blob"] = arena_a._entries[digest]
    submit_and_drain(a, out["log"], "host hit")
    submit_and_drain(a, out["log"], "hbm hit")
    servers = []
    sibling_port = None
    if rank0:
        # A single-device sibling spills the same block into its own arena.
        arena_s = KVHostArena(64 << 20)
        park_then_evict(engine(mesh_=None, host_arena=arena_s), [])
        servers = [kt.KVServer(port=0, host="127.0.0.1") for _ in range(2)]
        servers[0].serve_prefixes(arena_s.get)
        servers[1].serve_prefixes(arena_a.get)
        sibling_port = servers[0].port
        out["sibling_blob"] = arena_s._entries[digest]
    # Every rank sets the remote tier; only rank 0 dials it.
    sibling_port = broadcast_object(sibling_port, mesh.tp_group)
    b = engine(remote_prefix=kt.RemotePrefixSource(endpoints=[("127.0.0.1", sibling_port)]))
    out["b_log"] = []
    submit_and_drain(b, out["b_log"], "remote hit")
    if rank0:
        c = engine(mesh_=None, remote_prefix=kt.RemotePrefixSource(
            endpoints=[("127.0.0.1", servers[1].port)]))
        out["c_log"] = []
        submit_and_drain(c, out["c_log"], "remote hit")
        for server in servers:
            server.close()
    return out


RUNNERS = {"handoff": run_handoff, "gather": run_gather, "tiers": run_tiers}


# ---------------------------------------------------------------------------
# JAX side


@pytest.fixture(scope="module", autouse=True)
def jax_metrics_restored():
    """This module drives JAX's wire (the tier oracle's remote fetch): the
    JAX package's process-global metrics registry is left as it was found
    (tests/test_torch_kv_transport.py's rule)."""
    import copy

    from lws_tpu.core import metrics as jmetrics

    reg = jmetrics.REGISTRY
    with reg._lock:
        saved = copy.deepcopy((reg._label_sets, reg._counters, reg._gauges, reg._histograms))
    yield
    with reg._lock:
        reg._label_sets, reg._counters, reg._gauges, reg._histograms = saved


def _tiny_cfg(**kw):
    import jax.numpy as jnp

    from lws_tpu.models.llama import LlamaConfig

    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, dtype=jnp.float32, remat=False)
    base.update(kw)
    return LlamaConfig(**base)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's single-device oracles: tests/test_serving.py:265's model,
    prompt and tokens, its bundle and streamed chunks; bundles of given rows
    in f32, bf16 and int8; the prefix-tier scenarios' logs."""
    import jax
    import jax.numpy as jnp

    from lws_tpu.models.llama import init_params
    from lws_tpu.serving import kv_transport as jkt
    from lws_tpu.serving.engine import Engine as JaxEngine
    from lws_tpu_torch.models.convert import config_from_jax
    from lws_tpu_torch.serving import kv_transport as kt

    jcfg = _tiny_cfg()
    jparams = jax.jit(lambda: init_params(jcfg, jax.random.key(0)))()
    prompt = np.asarray(jax.random.randint(jax.random.key(3), (1, 9), 0, jcfg.vocab_size),
                        np.int32)
    single = JaxEngine(jcfg, jparams, batch_size=1, max_len=MAX_LEN)
    want = np.asarray(single.generate(jnp.asarray(prompt), max_new_tokens=STEPS + 1).tokens)
    jtoken, jcache = single.prefill(jnp.asarray(prompt))
    jbundle = jkt.cache_to_bundle(jcache, jtoken)
    jchunks = []
    single.prefill_chunked_stream(jnp.asarray(prompt), CHUNK,
                                  emit=lambda lo, hi, a: jchunks.append((lo, hi, a)))
    # Given rows, each kind: JAX's bundle of them.
    from tests.test_torch_kv_stream import jax_rows

    rows, row_bundles = {}, {}
    for kind in ("f32", "bf16", "int8"):
        rcache, kv, scales = jax_rows(kind, rows=24, pos=13)
        arrays = {"k": kv[0], "v": kv[1]}
        if scales[0] is not None:
            arrays.update(k_scale=scales[0], v_scale=scales[1])
        if kind == "bf16":  # the port's bf16 host view: uint16 bits tagged bfloat16
            arrays = {n: a.view(np.uint16).view(kt.BF16) for n, a in arrays.items()}
        rows[kind] = (arrays, 13, [42])
        row_bundles[kind] = jkt.cache_to_bundle(rcache, jnp.asarray([42], jnp.int32))
    # The prefix tiers' model and scenario, on JAX's single-device engines.
    tcfg_j = _tiny_cfg(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
                       d_ff=64, param_dtype=jnp.float32)
    tparams_j = jax.jit(lambda: init_params(tcfg_j, jax.random.key(0)))()
    tiers = jax_tiers(tcfg_j, tparams_j)
    return dict(jcfg=jcfg, cfg=config_from_jax(jcfg), tree=port_tree(jparams), prompt=prompt,
                want=want, jbundle=jbundle, jchunks=jchunks, rows=rows, row_bundles=row_bundles,
                tiers_cfg=config_from_jax(tcfg_j), tiers_tree=port_tree(tparams_j), tiers=tiers)


def jax_tiers(jcfg, jparams) -> dict:
    from lws_tpu.serving import kv_host_arena as jarena
    from lws_tpu.serving import kv_transport as jkt
    from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPaged

    def engine(**kw):
        return JaxPaged(jcfg, jparams, max_len=64, block_size=16, slots=4, num_blocks=10,
                        prefix_cache=True, **kw)

    log, b_log = [], []
    arena = jarena.KVHostArena(64 << 20)
    a = engine(host_arena=arena)
    park_then_evict(a, log)
    submit_and_drain(a, log, "host hit")
    submit_and_drain(a, log, "hbm hit")
    server = jkt.KVServer(port=0, host="127.0.0.1")
    try:
        server.serve_prefixes(arena.get)
        b = engine(remote_prefix=jkt.RemotePrefixSource(endpoints=[("127.0.0.1", server.port)]))
        submit_and_drain(b, b_log, "remote hit")
    finally:
        server.close()
    return {"log": log, "b_log": b_log}


@pytest.fixture(scope="module")
def world2(jax_side, tmp_path_factory):
    j = jax_side
    base = {"dp": 1, "tp": 2, "cfg": j["cfg"], "tree": j["tree"]}
    cases = [
        {**base, "name": "handoff", "run": "handoff", "prompt": j["prompt"],
         "jax_bundle": j["jbundle"]},
        {**base, "name": "gather", "run": "gather", "rows": j["rows"]},
        {**base, "name": "tiers", "run": "tiers", "cfg": j["tiers_cfg"], "tree": j["tiers_tree"]},
    ]
    return spawn_cases(2, cases, tmp_path_factory.mktemp("tp_disagg"), __name__)


def _spec(data) -> tuple:
    from lws_tpu_torch.serving import kv_transport as kt

    arrays = kt.bytes_to_arrays(data)
    return [(n, a.shape, kt._wire_dtype(a)) for n, a in arrays.items()], arrays


# ---------------------------------------------------------------------------


def test_sharded_prefill_bundle_to_sharded_decode(jax_side, world2):
    """tests/test_serving.py:265's twin: tp = 2 prefill -> pos-truncated
    host bundle gathered over tp -> resharded tp = 2 decode: tokens equal
    JAX's single-device engine exactly, on both ranks."""
    want = jax_side["want"]
    for res in world2:
        np.testing.assert_array_equal(res["handoff"]["mono"], want)
    got = world2[0]["handoff"]["bundle"]
    assert world2[1]["handoff"]["bundle"] is None  # the bytes live on tp rank 0
    jspec, jarrays = _spec(jax_side["jbundle"])
    spec, arrays = _spec(got)
    assert spec == jspec and len(got) == len(jax_side["jbundle"])
    for name in ("pos", "token"):
        np.testing.assert_array_equal(arrays[name], jarrays[name])
    for name in ("k", "v"):
        np.testing.assert_allclose(arrays[name], jarrays[name], rtol=TOL, atol=TOL)
    stats = world2[0]["handoff"]["mono_stats"]
    assert stats["bundle_bytes"] == len(got) and "reshard_s" in stats
    names = [s["name"] for s in world2[0]["handoff"]["mono_spans"]]
    assert names == ["kv.deserialize", "kv.reshard", "serve.decode_dispatch"]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_head_gather_bytes_equal_single_device_bundle(jax_side, world2, kind):
    """Given the same rows, the bundle gathered from the ranks' head shards
    is JAX's single-device bundle byte for byte (int8 scales gathered with
    their values)."""
    assert world2[0]["gather"][kind] == jax_side["row_bundles"][kind]
    assert world2[1]["gather"][kind] is None


def test_streamed_handoff_under_mesh(jax_side, world2):
    """prefill_chunked_stream at tp = 2: rank 0 emits JAX's chunk ranges
    and arrays (K/V within the f32 tolerance, tokens exact), rank 1 emits
    nothing; the stream decodes JAX's tokens exactly."""
    jchunks = jax_side["jchunks"]
    got = world2[0]["handoff"]["chunks"]
    assert world2[1]["handoff"]["chunks"] == []
    assert [c[:2] for c in got] == [c[:2] for c in jchunks]
    from lws_tpu_torch.serving import kv_transport as kt

    for (_, _, g), (_, _, w) in zip(got, jchunks):
        assert list(g) == list(w)
        for name in w:
            assert g[name].shape == w[name].shape and kt._wire_dtype(g[name]) == w[name].dtype.name
            if name in ("k", "v"):
                np.testing.assert_allclose(g[name], w[name], rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(g[name], w[name])
    for res in world2:
        assert res["handoff"]["stream_stats"]["chunks"] == len(jchunks)
        np.testing.assert_array_equal(res["handoff"]["streamed"], jax_side["want"])
    assert world2[0]["handoff"]["streamed_stats"]["streamed"] is True


def test_jax_bundle_decodes_on_port_tp2(jax_side, world2):
    """A JAX-made bundle decodes on the port's tp = 2 decode side: each rank
    places exactly its KV heads of JAX's rows, and the tokens are JAX's."""
    from lws_tpu_torch.serving import kv_transport as kt

    jrows = kt.bytes_to_arrays(jax_side["jbundle"])
    S = jax_side["prompt"].shape[1]
    h = jax_side["cfg"].n_kv_heads // 2
    for r, res in enumerate(world2):
        np.testing.assert_array_equal(res["handoff"]["jax_tokens"], jax_side["want"])
        for name in ("k", "v"):
            local = res["handoff"]["jax_local"][name]
            assert local.shape[2:4] == (MAX_LEN, h)
            np.testing.assert_array_equal(local[:, :, :S], jrows[name][:, :, :, r * h:(r + 1) * h])
            assert not local[:, :, S:].any()


def test_prefix_tiers_at_tp2_match_jax(jax_side, world2):
    """Spill on eviction, host restore and HBM hit at tp = 2 give JAX's
    single-device stats, pool accounting and streams on both ranks; the
    spilled block's arena bytes equal the single-device engine's, on both
    ranks' arenas."""
    for res in world2:
        assert res["tiers"]["log"] == jax_side["tiers"]["log"]
        assert res["tiers"]["arena_blob"] == world2[0]["tiers"]["sibling_blob"]
    stats = {e[0]: e[1] for e in jax_side["tiers"]["log"] if len(e) == 3}
    assert stats["host hit: drained"]["host_hits"] == 1 and stats["evicted"]["spills"] == 1


def test_prefix_remote_tier_between_tp2_and_single_device_siblings(jax_side, world2):
    """A tp = 2 engine warmed from a single-device sibling's arena, and a
    single-device engine from the tp = 2 engine's, over the KV wire: each
    admission is a remote-tier hit with JAX's stats and stream."""
    want = jax_side["tiers"]["b_log"]
    assert want[-2][1]["remote_hits"] == 1
    for res in world2:
        assert res["tiers"]["b_log"] == want
    assert world2[0]["tiers"]["c_log"] == want
