"""The port's hierarchical prefix cache held to the JAX engine's on the CPU:
the host-arena spill tier and the remote (sibling fetch) tier of
PagedBatchEngine, lws_tpu_torch/serving/kv_host_arena.py, and the
fetch_prefix leg of the KV wire.

Each case is the port counterpart of a non-chaos, non-fleet case of
tests/test_prefix_hierarchy.py. Every scenario runs on the JAX engine and
on the port's, on the same converted f32 weights: the greedy streams, the
prefix statistics (hits, evictions, spills, host and remote hits) and the
pool accounting after every step must be equal, and the pool must be
conserved (free, parked and request-held blocks partition the pool). The
arena and the fetch leg are held to JAX's arena and wire the same way.
Everything is exact."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lws_tpu.models import llama as jl
from lws_tpu.serving import kv_host_arena as jarena
from lws_tpu.serving import kv_transport as jkt
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving import kv_host_arena
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.kv_host_arena import KVHostArena
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine
from tests.test_torch_kv_transport import jax_metrics_restored  # noqa: F401 — autouse

PROMPT = np.arange(1, 25, dtype=np.int32)  # 24 tokens: 1 shareable block
STATS = ("hit_tokens", "hit_blocks", "evictions", "spills", "host_hits", "remote_hits")


@pytest.fixture(scope="module")
def model():
    """tests/test_prefix_hierarchy.py's model, and its port conversion."""
    jcfg = jl.LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
                          d_ff=64, max_seq_len=64, dtype=jnp.float32, param_dtype=jnp.float32,
                          remat=False)
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


# The two sides of every scenario: its engine factory, arena module and wire.
Side = collections.namedtuple("Side", "engine arena kt")


def sides(model):
    jcfg, jparams, tcfg, tparams = model
    return {
        "jax": Side(lambda **kw: JaxPagedBatchEngine(jcfg, jparams, max_len=64, block_size=16,
                                                     **kw), jarena, jkt),
        "port": Side(lambda **kw: PagedBatchEngine(tcfg, tparams, max_len=64, block_size=16,
                                                   device="cpu", **kw), kv_host_arena, kt),
    }


def run_both(model, scenario):
    """`scenario(side, log)` on both engines; their logs must be equal."""
    logs = {}
    for name, side in sides(model).items():
        logs[name] = []
        scenario(side, logs[name])
    assert logs["port"] == logs["jax"]
    return logs["port"]


def snapshot(engine, log, label) -> None:
    """Record the engine's prefix stats and pool accounting, after checking
    that free, parked and request-held blocks partition the pool."""
    free, parked = set(engine._free_blocks), set(engine._lru)
    live = set()
    for req in engine._active.values():
        live |= set(req.blocks)
    assert not free & parked and not free & live and not parked & live, label
    assert free | parked | live == set(range(1, engine.num_blocks)), label
    log.append((label, {k: engine.stats_prefix[k] for k in STATS}, engine.pool_accounting()))


def park_then_evict(engine, log):
    """The canonical spill sequence: park PROMPT's shareable block, fill the
    pool with two 4-block requests, then a 1-block admission evicts (and,
    with an arena, spills) the parked block. Returns PROMPT's stream."""
    r = engine.submit(PROMPT, 8)
    assert r is not None
    engine.run_until_drained()
    oracle = engine.result(r)
    assert engine.pool_accounting()["parked"] == 1
    f1 = engine.submit(np.full((24,), 9, np.int32), 40)
    f2 = engine.submit(np.full((24,), 11, np.int32), 40)
    g = engine.submit(np.arange(30, 38, dtype=np.int32), 8)
    assert None not in (f1, f2, g)
    snapshot(engine, log, "evicting")
    engine.run_until_drained()
    snapshot(engine, log, "evicted")
    log.append(("oracle", oracle))
    return oracle


def submit_and_drain(engine, log, label, prompt=PROMPT, new=8):
    r = engine.submit(prompt, new)
    assert r is not None
    snapshot(engine, log, f"{label}: admitted")
    engine.run_until_drained()
    snapshot(engine, log, f"{label}: drained")
    log.append((label, engine.result(r)))
    return engine.result(r)


# ---------------------------------------------------------------------------


def test_free_block_pool_is_fifo_deque(model):
    def scenario(side, log):
        engine = side.engine(slots=2, num_blocks=10)
        assert isinstance(engine._free_blocks, collections.deque)
        log.append(list(engine._free_blocks))
        log.append(engine._alloc_blocks(3))
        log.append(list(engine._free_blocks))
        log.append(engine._alloc_blocks(7))  # refused up front: order kept
        log.append(list(engine._free_blocks))
        assert engine.submit(np.arange(1, 9, dtype=np.int32), 8) is not None
        engine.run_until_drained()
        log.append(list(engine._free_blocks))  # released blocks recycle at the tail

    log = run_both(model, scenario)
    assert log == [list(range(1, 10)), [1, 2, 3], [4, 5, 6, 7, 8, 9], None,
                   [4, 5, 6, 7, 8, 9], [5, 6, 7, 8, 9, 4]]


def test_arena_lru_capacity_oversize_and_roundtrip():
    def scenario(mod):
        a8 = {"k": np.arange(8, dtype=np.float32)}
        probe = mod.KVHostArena(1 << 20)
        probe.put(b"probe", a8)
        unit = probe.nbytes
        arena = mod.KVHostArena(2 * unit)
        out = [unit, arena.put(b"a", a8), arena.put(b"b", a8)]
        got = arena.get(b"a")
        np.testing.assert_array_equal(got["k"], a8["k"])
        out += [arena.put(b"c", a8), b"a" in arena, b"b" in arena, arena.digests()]
        out += [arena.put(b"huge", {"k": np.zeros(4 * unit, dtype=np.float32)}),
                arena.stats(), len(arena), arena.put(b"a", a8), arena.nbytes,
                arena.get(b"missing")]
        with pytest.raises(ValueError):
            mod.KVHostArena(0)
        return out

    got = scenario(kv_host_arena)
    assert got == scenario(jarena)
    assert got[-2] == 2 * got[0] and got[6] == [b"a", b"c"] and got[8]["drops"] == 1


def test_arena_from_env(monkeypatch):
    for mod in (kv_host_arena, jarena):
        monkeypatch.delenv(mod.ARENA_MB_ENV, raising=False)
        assert mod.from_env() is None
        monkeypatch.setenv(mod.ARENA_MB_ENV, "0")
        assert mod.from_env() is None
        monkeypatch.setenv(mod.ARENA_MB_ENV, "2")
        arena = mod.from_env()
        assert arena is not None and arena.capacity == 2_000_000
    assert kv_host_arena.ARENA_MB_ENV == jarena.ARENA_MB_ENV


def test_spill_on_evict_then_host_restore_hits_and_conserves(model):
    def scenario(side, log):
        arena = side.arena.KVHostArena(64 << 20)
        engine = side.engine(slots=4, num_blocks=10, prefix_cache=True, host_arena=arena)
        oracle = park_then_evict(engine, log)
        log.append(("arena", len(arena)))
        digest, = arena.digests()
        spilled = {n: np.array(a) for n, a in arena.get(digest).items()}
        # Resubmit: the prefix map misses but the arena restores (a host-tier
        # hit), and the restored block holds the spilled bytes.
        assert submit_and_drain(engine, log, "host hit") == oracle
        blk = engine._prefix_map[digest]
        for name, rows in spilled.items():
            np.testing.assert_array_equal(np.asarray(getattr(engine.cache, name)[:, blk]), rows)
        # The restored block is mapped again: a third submit hits in HBM.
        assert submit_and_drain(engine, log, "hbm hit") == oracle

    log = run_both(model, scenario)
    stats = {label: s for label, s, *_ in [e for e in log if len(e) == 3]}
    assert stats["host hit: drained"]["host_hits"] == 1
    assert stats["evicted"]["spills"] == stats["evicted"]["evictions"] == 1


def test_backpressure_rollback_parks_restored_block_and_conserves(model):
    def scenario(side, log):
        arena = side.arena.KVHostArena(64 << 20)
        engine = side.engine(slots=6, num_blocks=10, prefix_cache=True, host_arena=arena)
        oracle = park_then_evict(engine, log)
        h = [engine.submit(np.full((24,), 21, np.int32), 40),
             engine.submit(np.arange(40, 48, dtype=np.int32), 24),
             engine.submit(np.arange(50, 58, dtype=np.int32), 8)]
        assert None not in h and engine.pool_accounting()["free"] == 0
        snapshot(engine, log, "full")
        # PROMPT needs 4 blocks: the walk restores its block from the arena,
        # then the suffix allocation fails: full rollback, refused.
        assert engine.submit(PROMPT, 40) is None
        snapshot(engine, log, "refused")
        assert engine.pool_accounting()["parked"] >= 1
        engine.run_until_drained()
        snapshot(engine, log, "drained")
        # The restored block survived PARKED and mapped: an HBM hit now.
        assert submit_and_drain(engine, log, "hbm hit") == oracle

    log = run_both(model, scenario)
    final = log[-2][1]
    assert final["host_hits"] == 0 and final["hit_blocks"] >= 1


def test_arena_full_drop_degrades_to_recompute_and_conserves(model):
    def scenario(side, log):
        arena = side.arena.KVHostArena(64)  # smaller than any block payload
        engine = side.engine(slots=4, num_blocks=10, prefix_cache=True, host_arena=arena)
        oracle = park_then_evict(engine, log)
        log.append(("arena", arena.stats()["drops"], len(arena)))
        assert submit_and_drain(engine, log, "recompute") == oracle

    log = run_both(model, scenario)
    assert ("arena", 1, 0) in log
    assert log[-2][1]["spills"] == 0 and log[-2][1]["host_hits"] == 0


def synth_blocks(n: int) -> dict:
    out = {}
    for i in range(n):
        rng = np.random.default_rng(i)
        out[bytes([i]) * 16] = {"k": rng.standard_normal((1, 16, 2, 16)).astype(np.float32),
                                "v": rng.standard_normal((1, 16, 2, 16)).astype(np.float32)}
    return out


@pytest.mark.parametrize("server_mod", [kt, jkt], ids=["port_server", "jax_server"])
def test_fetch_prefix_roundtrip_and_contiguity(server_mod):
    """The port's fetch_prefix against a port and a JAX sibling."""
    entries = synth_blocks(3)
    arena = (kv_host_arena if server_mod is kt else jarena).KVHostArena(64 << 20)
    for d, arrays in entries.items():
        assert arena.put(d, arrays)
    server = server_mod.KVServer(port=0, host="127.0.0.1")
    try:
        server.serve_prefixes(arena.get)
        ep = ("127.0.0.1", server.port)
        d0, d1, d2 = entries
        got = kt.fetch_prefix(ep, [d0, d1, d2])
        assert list(got) == [d0, d1, d2]
        for d in got:
            for name in ("k", "v"):
                np.testing.assert_array_equal(got[d][name], entries[d][name])
        assert set(kt.fetch_prefix(ep, [d0, b"\x77" * 16, d2])) == {d0}
        assert kt.fetch_prefix(ep, [b"\x55" * 16]) == {}
    finally:
        server.close()


def test_fetch_prefix_without_provider_is_empty():
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        assert kt.fetch_prefix(("127.0.0.1", server.port), [b"\x01" * 16]) == {}
        assert jkt.fetch_prefix(("127.0.0.1", server.port), [b"\x01" * 16]) == {}
    finally:
        server.close()


def test_remote_source_skips_dead_peer_and_opens_breaker():
    (digest, arrays), = synth_blocks(1).items()
    arena = KVHostArena(64 << 20)
    arena.put(digest, arrays)
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        server.serve_prefixes(arena.get)
        src = kt.RemotePrefixSource(endpoints=[("127.0.0.1", 1), ("127.0.0.1", server.port)],
                                    timeout=0.2, failure_threshold=1)
        assert set(src.fetch([digest])) == {digest}
        # threshold 1: the dead peer's breaker opened on its first failure.
        assert not src._breakers["127.0.0.1:1"].allow()
        assert set(src.fetch([digest])) == {digest}
        assert src.fetch([]) == {}
    finally:
        server.close()


def test_remote_fetch_tier_restores_and_matches_oracle(model):
    """Sibling A spills into its arena and serves it over the KV wire;
    engine B (no arena) admits the same prompt through a remote-tier hit.
    The port's B also fetches from the JAX A, whose blocks are the same."""
    served = {}

    def scenario(side, log):
        arena_a = side.arena.KVHostArena(64 << 20)
        a = side.engine(slots=4, num_blocks=10, prefix_cache=True, host_arena=arena_a)
        oracle = park_then_evict(a, log)
        server = side.kt.KVServer(port=0, host="127.0.0.1")
        served[side.kt] = server
        server.serve_prefixes(arena_a.get)
        src = side.kt.RemotePrefixSource(endpoints=[("127.0.0.1", server.port)])
        b = side.engine(slots=4, num_blocks=10, prefix_cache=True, remote_prefix=src)
        assert submit_and_drain(b, log, "remote hit") == oracle
        digest, = arena_a.digests()
        blk = b._prefix_map[digest]
        for name, rows in arena_a.get(digest).items():
            np.testing.assert_array_equal(np.asarray(getattr(b.cache, name)[:, blk]), rows)

    try:
        log = run_both(model, scenario)
        assert log[-2][1]["remote_hits"] == 1
        # Cross-framework: a port engine warmed from the JAX sibling's arena.
        _, _, tcfg, tparams = model
        c = PagedBatchEngine(tcfg, tparams, max_len=64, block_size=16, device="cpu", slots=4,
                             num_blocks=10, prefix_cache=True,
                             remote_prefix=kt.RemotePrefixSource(
                                 endpoints=[("127.0.0.1", served[jkt].port)]))
        cross = []
        assert submit_and_drain(c, cross, "remote hit") == log[-1][1]
        assert cross[-2][1]["remote_hits"] == 1
    finally:
        for server in served.values():
            server.close()
