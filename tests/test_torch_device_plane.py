"""The port's device plane (lws_tpu_torch/obs/device.py,
core/profile.py:record_device_memory, the compile ledger's feed from
ops/_ext.py:build): the cases of tests/test_device_plane.py run on the
port, each beside the JAX package's module where the two must agree, plus
the port's own feed (an nvcc build records one ledger entry per compiled
source, a cached library none) and the CUDA-context guard (a process that
never used the card reads no device memory and creates no context)."""

import json
import subprocess
import sys

import pytest
import torch

from lws_tpu.core import metrics as jmetrics
from lws_tpu.core.flightrecorder import FlightRecorder as JaxFlightRecorder
from lws_tpu.obs import device as jdevice
from lws_tpu_torch.core import metrics, profile
from lws_tpu_torch.core.flightrecorder import FlightRecorder, Watchdog, default_rules
from lws_tpu_torch.obs import device
from lws_tpu_torch.obs.device import CompileLedger, compile_site
from lws_tpu_torch.ops import _ext

T0 = 1000.0


def make_ledger(**kw):
    kw.setdefault("recorder", FlightRecorder())
    kw.setdefault("storm_n", 3)
    kw.setdefault("storm_window_s", 60.0)
    return CompileLedger(**kw)


class _pool_registry:
    """Save/clear/restore the process pool registry around a test (the host
    arena registers its arena_restore provider at import)."""

    def __enter__(self):
        with device._POOL_LOCK:
            self._bytes = dict(device._POOL_BYTES)
            self._providers = dict(device._POOL_PROVIDERS)
        device.clear_pools()
        return self

    def __exit__(self, *exc):
        with device._POOL_LOCK:
            device._POOL_BYTES.clear()
            device._POOL_BYTES.update(self._bytes)
            device._POOL_PROVIDERS.clear()
            device._POOL_PROVIDERS.update(self._providers)


def _ledger_feed(led):
    led.observe(0.5, executable="paged.step_n", engine="paged", shape="n4", now=T0, unix=1.0)
    led.observe(0.3, executable="paged.step_n", engine="paged", shape="n8", now=T0 + 1,
                unix=2.0)
    for i in range(6):
        led.observe(0.1, executable=f"exe{i % 2}", engine="batch", now=T0 + 2 + i,
                    unix=3.0 + i)
    snap = led.snapshot()
    for r in snap["records"]:
        r.pop("trace")
    return snap


def test_ledger_matches_jax_ledger_record_for_record():
    snap = _ledger_feed(make_ledger(ring=5))
    jsnap = _ledger_feed(jdevice.CompileLedger(recorder=JaxFlightRecorder(), ring=5,
                                               storm_n=3, storm_window_s=60.0))
    jsnap["armed"] = snap["armed"]  # JAX's armed state follows jax.monitoring
    assert snap == jsnap


def test_ledger_first_then_recompile_kinds_counts_and_metrics():
    led = make_ledger()
    reg = metrics.REGISTRY
    first = {"engine": "paged", "kind": "first"}
    re = {"engine": "paged", "kind": "recompile"}
    before_first = reg.counter_value("serving_compiles_total", first)
    before_re = reg.counter_value("serving_compiles_total", re)
    j_before = jmetrics.REGISTRY.counter_value("serving_compiles_total", first)
    r1 = led.observe(0.5, executable="paged.step_n", engine="paged", shape="n4", now=T0, unix=1.0)
    r2 = led.observe(0.3, executable="paged.step_n", engine="paged", shape="n8", now=T0 + 1,
                     unix=2.0)
    assert r1["kind"] == "first" and r2["kind"] == "recompile"
    counts = led.snapshot()["executables"]["paged.step_n"]
    assert counts["first"] == 1 and counts["recompiles"] == 1
    assert counts["seconds"] == pytest.approx(0.8)
    assert reg.counter_value("serving_compiles_total", first) == before_first + 1
    assert reg.counter_value("serving_compiles_total", re) == before_re + 1
    # The port's ledger reports into the port's registry only.
    assert jmetrics.REGISTRY.counter_value("serving_compiles_total", first) == j_before
    recs = led.records()
    assert [r["shape"] for r in recs] == ["n4", "n8"] and recs[0]["seq"] < recs[1]["seq"]
    json.dumps(led.snapshot())


def test_ledger_ring_bound_and_executable_filter():
    led = make_ledger(ring=4)
    for i in range(6):
        led.observe(0.1, executable=f"exe{i % 2}", engine="paged", now=T0 + i, unix=float(i))
    recs = led.records()
    assert len(recs) == 4 and recs[0]["unix"] == 2.0
    only0 = led.records(executable="exe0")
    assert only0 and all(r["executable"] == "exe0" for r in only0)
    assert len(led.records(limit=2)) == 2


def test_ambient_site_attribution_nesting_and_explicit_override():
    led = make_ledger()
    with compile_site("paged.prefill", engine="paged", shape="b64", request_id="r-outer"):
        with compile_site("paged.prefill_suffix", engine="paged", shape="b64/s16",
                          request_id="r-inner"):
            rec = led.observe(0.2, now=T0, unix=1.0)
        rec2 = led.observe(0.2, now=T0 + 1, unix=2.0)
        rec3 = led.observe(0.2, executable="explicit", engine="batch", now=T0 + 2, unix=3.0)
    rec4 = led.observe(0.2, now=T0 + 3, unix=4.0)
    assert rec["executable"] == "paged.prefill_suffix"  # innermost wins
    assert rec["shape"] == "b64/s16" and rec["request_id"] == "r-inner"
    assert rec2["executable"] == "paged.prefill"
    assert rec3["executable"] == "explicit" and rec3["engine"] == "batch"
    assert rec4["executable"] == "unattributed"


def test_disarmed_ledger_records_nothing_and_arm_reenables():
    led = make_ledger()
    led.disarm()
    assert led.observe(0.5, executable="x", now=T0, unix=1.0) is None
    assert led.records() == [] and led.armed is False
    # No jax.monitoring in the port: arming only (re)enables the feed.
    assert led.arm() is True and led.armed is True
    assert led.observe(0.5, executable="x", now=T0, unix=1.0)["kind"] == "first"


def test_arm_from_env_honors_the_kill_switch(monkeypatch):
    monkeypatch.setattr(device, "LEDGER", make_ledger())
    monkeypatch.setenv("LWS_TPU_COMPILE_LEDGER", "0")
    assert device.arm_from_env() is False and not device.LEDGER.armed
    monkeypatch.setenv("LWS_TPU_COMPILE_LEDGER", "1")
    assert device.arm_from_env() is True and device.debug_compile(limit=4)["armed"] is True


class _FakeNvcc:
    """Stands in for subprocess.Popen of nvcc: writes the output library and
    exits 0."""

    calls: list = []

    def __init__(self, cmd, **kw):
        self.cmd = cmd
        self.returncode = None
        _FakeNvcc.calls.append(cmd)

    def communicate(self):
        out = self.cmd[self.cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")
        self.returncode = 0
        return "ptxas info    : Used 32 registers", None


def test_build_records_one_ledger_entry_per_compiled_source(monkeypatch, tmp_path):
    led = make_ledger()
    monkeypatch.setattr(device, "LEDGER", led)
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_ext, "_nvcc", lambda: "/bin/nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.calls = []
    sources = sorted(p.stem for p in _ext.CSRC_DIR.glob("*.cu"))
    with compile_site("paged.step_n", engine="paged", shape="n8"):
        reports = _ext.build(sources)
    assert sorted(reports) == sources and len(_FakeNvcc.calls) == len(sources)
    recs = led.records()
    assert sorted(r["executable"] for r in recs) == sources
    assert all(r["kind"] == "first" and r["seconds"] >= 0 and r["engine"] == "paged"
               and r["shape"] == "n8" for r in recs)
    # The libraries now exist under their digests: a cache hit compiles and
    # records nothing, as a persistent compile-cache hit records nothing in JAX.
    assert _ext.build(sources) == {}
    assert len(led.records()) == len(sources) and len(_FakeNvcc.calls) == len(sources)


def test_compile_storm_fires_once_per_episode():
    fr = FlightRecorder()
    wd = Watchdog(recorder=fr, rules=default_rules())
    led = make_ledger(recorder=fr)
    led.observe(0.4, executable="paged.prefill", engine="paged", now=T0, unix=1.0)
    assert "compile_storm" not in wd.check_now(now=T0)
    for i in range(1, 4):
        led.observe(0.4, executable="paged.prefill", engine="paged", now=T0 + i, unix=1.0 + i)
    firing = wd.check_now(now=T0 + 3)
    assert firing["compile_storm"][0]["source"] == "compile_storm:paged.prefill"
    dump1 = wd.last_dump
    assert dump1["alert"]["watchdog"] == "compile_storm"
    assert "compiles" in dump1  # the process ledger's window rides every dump
    assert "compile_storm" in wd.check_now(now=T0 + 4) and wd.last_dump is dump1
    led.observe(0.4, executable="paged.prefill", engine="paged", now=T0 + 300, unix=400.0)
    assert "compile_storm" not in wd.check_now(now=T0 + 300)
    for i in range(3):
        led.observe(0.4, executable="paged.prefill", engine="paged", now=T0 + 400 + i,
                    unix=500.0 + i)
    assert "compile_storm" in wd.check_now(now=T0 + 403)
    assert wd.last_dump is not dump1


def _refresh(dev_mod, reg, recorder, stats):
    dev_mod.set_pool_bytes("weights", 4e9)
    dev_mod.set_pool_bytes("kv", 3e9)
    dev_mod.register_pool_provider("arena_restore", lambda: 1e9)
    n = dev_mod.refresh_device_memory(stats=stats, recorder=recorder, now=T0)
    g = reg.gauge_value
    return n, {
        "in_use": g("serving_hbm_bytes_in_use", {"device": "gpu:0"}),
        "limit": g("serving_hbm_bytes_limit", {"device": "gpu:0"}),
        "peak": g("serving_hbm_peak_bytes", {"device": "gpu:0"}),
        "frag": g("serving_hbm_fragmentation", {"device": "gpu:0"}),
        **{p: g("serving_hbm_pool_bytes", {"pool": p})
           for p in ("weights", "kv", "arena_restore", "workspace")},
    }


def test_refresh_injected_stats_pools_fragmentation_and_pressure(monkeypatch):
    stats = [{"device": "gpu:0", "in_use": 9.3e9, "limit": 10e9, "peak": 9.8e9}]
    with _pool_registry():
        fr = FlightRecorder()
        wd = Watchdog(recorder=fr, rules=default_rules())
        n, got = _refresh(device, metrics.REGISTRY, fr, [dict(s) for s in stats])
        assert n == 1
        assert got["workspace"] == pytest.approx(9.3e9 - 4e9 - 3e9)  # arena is host-resident
        assert got["frag"] == pytest.approx((9.8e9 - 9.3e9) / 9.8e9)
        firing = wd.check_now(now=T0 + 1)
        assert firing["hbm_pressure"][0]["source"] == "hbm_pressure:gpu:0"
        dump1 = wd.last_dump
        device.refresh_device_memory(stats=stats, recorder=fr, now=T0 + 5)
        assert "hbm_pressure" in wd.check_now(now=T0 + 5) and wd.last_dump is dump1
        stats[0]["in_use"] = 5e9
        device.refresh_device_memory(stats=stats, recorder=fr, now=T0 + 10)
        assert "hbm_pressure" not in wd.check_now(now=T0 + 10)
    # The JAX helper on the same stats sets the same gauges in its registry.
    jsaved = (dict(jdevice._POOL_BYTES), dict(jdevice._POOL_PROVIDERS))
    try:
        jdevice.clear_pools()
        stats[0]["in_use"] = 9.3e9
        jn, jgot = _refresh(jdevice, jmetrics.REGISTRY, JaxFlightRecorder(), stats)
    finally:
        jdevice.clear_pools()
        jdevice._POOL_BYTES.update(jsaved[0])
        jdevice._POOL_PROVIDERS.update(jsaved[1])
    assert (jn, jgot) == (n, got)


def test_refresh_swallows_broken_pool_provider():
    with _pool_registry():
        device.set_pool_bytes("weights", 2e9)
        device.register_pool_provider(
            "arena_restore", lambda: (_ for _ in ()).throw(RuntimeError("x")))
        stats = [{"device": "gpu:0", "in_use": 3e9, "limit": 10e9, "peak": 3e9}]
        assert device.refresh_device_memory(stats=stats, recorder=FlightRecorder(),
                                            now=T0) == 1
        assert metrics.REGISTRY.gauge_value("serving_hbm_pool_bytes", {"pool": "weights"}) == 2e9


def test_transfer_accounting_counts_bytes_and_seconds():
    labels = {"site": "test.site", "direction": "h2d"}
    before = metrics.REGISTRY.counter_value("serving_transfer_bytes_total", labels)
    device.record_transfer("test.site", 1024)
    with device.transfer("test.site", 2048):
        pass
    assert metrics.REGISTRY.counter_value("serving_transfer_bytes_total", labels) == before + 3072
    fams = metrics.parse_exposition(metrics.REGISTRY.render())
    counts = [v for n, lab, v, _ in fams["serving_transfer_seconds"]["samples"]
              if n.endswith("_count") and lab.get("site") == "test.site"]
    assert counts and counts[0] >= 1


def _no_cuda(monkeypatch):
    """Make any CUDA initialization or allocator read in this test fail."""
    def refuse(*a, **kw):
        raise AssertionError("touched CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "init", refuse)


def test_record_device_memory_never_creates_a_cuda_context(monkeypatch):
    _no_cuda(monkeypatch)
    assert not torch.cuda.is_initialized()
    assert profile.record_device_memory() == []
    # The live refresh path is CPU-safe too, and reports only host pools.
    with _pool_registry():
        assert device.refresh_device_memory(recorder=FlightRecorder()) == 0
    assert not torch.cuda.is_initialized()


def test_record_device_memory_reads_the_allocator_once_initialized(monkeypatch):
    """The allocator keys and the label, on a stand-in for an initialized
    card (the real read runs on the card, in chip_smoke.py)."""
    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 5 * 2**30, "allocated_bytes.all.peak": 7 * 2**30})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    got = profile.record_device_memory()
    assert got == [{"device": "gpu:0", "in_use": 5 * 2**30, "limit": 80 * 2**30,
                    "peak": 7 * 2**30}]
    assert metrics.REGISTRY.gauge_value("serving_hbm_bytes_limit", {"device": "gpu:0"}) == \
        80 * 2**30


def test_importing_the_device_plane_creates_no_cuda_context():
    code = ("import torch, lws_tpu_torch.obs.device, lws_tpu_torch.core.profile as p; "
            "assert p.record_device_memory() == []; "
            "assert not torch.cuda.is_initialized(); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(_ext._PKG.parent))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
