"""Contract pins: the port's KV wire and disaggregated workers name every
metric family, fault point, flight-recorder event and transfer site that
the JAX package's do, read out of both packages' sources
(serving/kv_transport.py and serving/disagg_worker.py), and the port's
fault schedules are JAX's: the same modes, the same cooperative points and
the modes each honors, the same env variable and grammar."""

import re
from pathlib import Path

import pytest

from lws_tpu.core import faults as jfaults
from lws_tpu_torch.core import faults

ROOT = Path(__file__).resolve().parent.parent
MODULES = ("serving/kv_transport.py", "serving/disagg_worker.py")
PATTERNS = {
    "metric": r"metrics\.(?:inc|observe|set)\(\s*\"([a-z_]+)\"",
    "fault point": r"faults\.fire\(\s*\"([a-z_.]+)\"",
    "flight-recorder event": r"flightrecorder\.record\(\s*\"([a-z_]+)\"",
    "transfer site": r"record_transfer\(\s*\"([a-z_.]+)\"",
}


def names(package: str, module: str, kind: str) -> set[str]:
    return set(re.findall(PATTERNS[kind], (ROOT / package / module).read_text()))


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("kind", sorted(PATTERNS))
def test_port_names_every_jax_name(module, kind):
    want = names("lws_tpu", module, kind)
    got = names("lws_tpu_torch", module, kind)
    if module.endswith("kv_transport.py") or kind in ("metric", "fault point"):
        assert want, f"no {kind} found in lws_tpu/{module}: the pattern is stale"
    assert want <= got, f"{module}: {kind}s missing from the port: {sorted(want - got)}"


def test_the_wire_names_the_issue_lists():
    """The five metric families and nine fault points of JAX's wire, and
    the workers' two, by name."""
    metrics = names("lws_tpu_torch", MODULES[0], "metric")
    assert {"serving_kv_copy_bytes_total", "serving_kv_stream_inflight_chunks",
            "serving_kv_connection_errors_total", "serving_kv_transfer_bytes_total",
            "serving_kv_transfer_seconds"} <= metrics
    assert names("lws_tpu_torch", MODULES[0], "fault point") == {
        "kv.server.recv", "kv.server.send_bundle", "kv.server.send_result",
        "kv.stream.send_chunk", "kv.client.connect", "kv.client.recv", "kv.stream.recv_chunk",
        "kv.ack", "kv.prefix.fetch"}
    assert names("lws_tpu_torch", MODULES[1], "fault point") == {
        "disagg.prefill.handoff", "disagg.decode.process"}
    assert {"serving_kv_handoffs_total", "serving_kv_handoff_bytes_total"} <= \
        names("lws_tpu_torch", MODULES[1], "metric")


def test_fault_schedule_contract_equals_jax():
    assert faults.MODES == jfaults.MODES
    assert faults.COOPERATIVE_POINTS == jfaults.COOPERATIVE_POINTS
    assert faults._COOPERATIVE_MODES == jfaults._COOPERATIVE_MODES
    assert faults._RAISING_MODES == jfaults._RAISING_MODES
    assert faults.FAULTS_ENV == jfaults.FAULTS_ENV == "LWS_TPU_FAULTS"
    assert set(faults._EXCEPTIONS) == set(jfaults._EXCEPTIONS)
    for point, modes in jfaults.COOPERATIVE_POINTS.items():
        for mode in sorted(modes):
            spec = {"drop": "drop:2", "partial_write": "partial_write:8:1",
                    "pace": "pace:10"}[mode]
            port, jax = faults.FaultInjector(env=""), jfaults.FaultInjector(env="")
            port.arm(point, spec)
            jax.arm(point, spec)
            fired = [(port.fire(point), jax.fire(point)) for _ in range(3)]
            assert [(p and (p.point, p.mode, p.arg)) for p, _ in fired] == \
                [(j and (j.point, j.mode, j.arg)) for _, j in fired]
            assert port.snapshot() == jax.snapshot()


def test_resilience_mechanisms_and_kill_switch_equal_jax(monkeypatch):
    from lws_tpu.core import resilience as jres
    from lws_tpu_torch.core import resilience as res

    assert res.MECHANISMS == jres.MECHANISMS and res.DISABLE_ENV == jres.DISABLE_ENV
    for value in ("", "retry", "deadline, dedup", "breaker,drain,x"):
        monkeypatch.setenv(res.DISABLE_ENV, value)
        assert [res.disabled(m) for m in res.MECHANISMS] == \
            [jres.disabled(m) for m in jres.MECHANISMS]


def test_debug_prefixes_match_jax(monkeypatch):
    """The prefix advertisement (the body the JAX package's telemetry server
    serves at /debug/prefixes) from the same registrations: live sources'
    digests as hex, capped per list, dead sources pruned, the fetch port;
    and a port engine with the prefix cache registers itself."""
    import numpy as np

    from lws_tpu.serving import kv_host_arena as jarena
    from lws_tpu_torch.models.llama import LlamaConfig, init_params
    from lws_tpu_torch.serving import kv_host_arena as arena
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    snap = {"block_size": 16, "digests": [b"\x01" * 16, b"\x02" * 16],
            "arena_digests": [b"\x03" * 16]}
    for mod in (arena, jarena):
        monkeypatch.setattr(mod, "_PREFIX_SOURCES", {})
        monkeypatch.setattr(mod, "_FETCH_PORT", None)
        mod.register_fetch_port(4321)
        mod.register_prefix_source("live", lambda: snap)
        mod.register_prefix_source("dead", lambda: None)
    assert arena.debug_prefixes(limit=1) == jarena.debug_prefixes(limit=1)
    assert arena.debug_prefixes() == jarena.debug_prefixes() == {
        "digests": ["01" * 16, "02" * 16], "arena_digests": ["03" * 16], "count": 3,
        "kv_port": 4321}
    assert list(arena._PREFIX_SOURCES) == ["live"]  # the dead source was pruned
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64,
                      max_seq_len=64)
    engine = PagedBatchEngine(cfg, init_params(cfg, None, device="cpu"), slots=2, max_len=64,
                              block_size=16, prefix_cache=True, device="cpu")
    engine.submit(np.arange(1, 25, dtype=np.int32), 4)
    engine.run_until_drained()
    got = arena.debug_prefixes()
    assert set(got["digests"]) == {"01" * 16, "02" * 16} | {d.hex() for d in engine._prefix_map}
    assert len(engine._prefix_map) == 1
