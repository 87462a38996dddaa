"""The port's read commands (`python -m lws_tpu_torch top|monitor|explain|
rollout|why|profile|devices|faults`, lws_tpu_torch/cli.py) and their render
helpers against the JAX package's (`lws_tpu.cli`), on the CPU.

- The render helpers on the JAX package's canned inputs (its
  tests/test_decision_plane.py records, tests/test_profile_plane.py
  stacks, tests/test_device_plane.py exposition) and on folds of equal
  fleet expositions and history rings: the frames are equal, character for
  character. One divergence: a burn row whose window has no data yet
  (`short_burn` None) makes the JAX package's `render_why` raise; the
  port's prints "-" (held below on its own).
- Each command in-process (`main(argv)`, capsys) against a JAX ApiServer
  and a port ApiServer holding identical state (tests/test_torch_fleet.py's
  servers: the same workers' telemetry servers, equal process planes): the
  exit codes and the output are equal. The rows (and `--json` entries)
  of the instance "control-plane" are each package's own process
  registries and ledgers and are left out of the comparison; wall clocks
  printed as times of day and ages, and the clocks of ledger entries in
  `--json` output, are normalized.
"""

from __future__ import annotations

import copy
import json
import re

import pytest

from lws_tpu import cli as jcli
from lws_tpu.core import metrics as jmetrics
from lws_tpu.obs.history import HistoryRing as JRing
from lws_tpu_torch import cli as pcli
from lws_tpu_torch.core import metrics as pmetrics
from lws_tpu_torch.obs.history import HistoryRing as PRing
from tests.test_decision_plane import _canned_records
from tests.test_device_plane import DEVICE_EXPOSITION
from tests.test_profile_plane import PROFILE_SNAP
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_fleet import (  # noqa: F401
    DECISION_CLOCK,
    JAX,
    PORT,
    WALL_KEYS,
    normalize,
    port_planes_restored,
    servers,
    workers,
)

# Every test here leaves the port's process planes as it found them
# (tests/test_torch_fleet.py:port_planes_restored).
pytestmark = pytest.mark.usefixtures("port_planes_restored")

SIDES = (("jax", jcli, jmetrics, JRing), ("port", pcli, pmetrics, PRing))


@pytest.fixture(autouse=True)
def no_cli_credentials(monkeypatch):
    for c in (pcli, jcli):
        monkeypatch.setattr(c, "_TOKEN", None)
        monkeypatch.setattr(c, "_TLS_CONTEXT", None)


def fleet_fams(m):
    """A fleet exposition's families: two workers' series merged the way
    /metrics/fleet merges them (package m's merge and parser)."""
    sources = []
    for i, role in enumerate(("prefill", "decode")):
        reg = m.MetricsRegistry()
        reg.inc("serving_requests_total", {"engine": "disagg", "klass": "chat"}, 10.0 + i)
        reg.inc("serving_tokens_total", {"engine": "disagg", "klass": "chat"}, 100.0 * (i + 1))
        reg.inc("serving_goodput_tokens_total", {"engine": "disagg", "klass": "chat"},
                80.0 * (i + 1))
        reg.set("serving_slo_attainment", 0.5 + 0.25 * i, {"engine": "disagg", "klass": "chat"})
        reg.set("serving_active_slots", 1.0 + i, {"engine": "disagg"})
        reg.inc("serving_prefix_cache_hits_total", {"engine": "disagg", "tier": "hbm"}, 3.0)
        reg.inc("serving_prefix_cache_misses_total", {"engine": "disagg"}, 1.0)
        reg.observe("serving_ttft_seconds", 0.02 * (i + 1), {"engine": "disagg",
                                                            "klass": "chat"})
        reg.observe("serving_itl_seconds", 0.004 * (i + 1), {"engine": "disagg",
                                                            "klass": "chat"})
        reg.set("serving_slo_burn_rate", 20.0 * i, {"engine": "disagg", "klass": "chat",
                                                     "window": "fast"})
        reg.set("serving_scale_recommendation", 1.0 + i, {"role": role})
        reg.set("serving_hbm_pool_bytes", 4.2e9, {"pool": "weights"})
        sources.append(({"instance": f"w{i}", "role": role, "revision": "r1"}, reg.render()))
    fleet = m.MetricsRegistry()
    fleet.set("lws_fleet_instances", 2.0)
    sources.insert(0, ({"instance": "control-plane"}, fleet.render()))
    return m.parse_exposition(m.merge_expositions(sources))


def ring_snapshot(Ring, m):
    ring = Ring(interval_s=0.0, retention_s=600.0)
    for t, v in ((0.0, 0.001), (10.0, 100.0), (20.0, 400.0)):
        cum = m.MetricsRegistry()
        cum.inc("serving_tokens_total", {"engine": "paged"}, v)
        cum.set("serving_active_slots", t / 10.0, {"engine": "paged"})
        ring.ingest(cum.render(), now=t)
    return ring.snapshot()


JOURNEY = {
    "id": "req1", "trace_id": "t" * 32, "outcome": "breached", "flags": ["breached", "slowest"],
    "connected": True,
    "legs": [{"labels": {"instance": "w0", "role": "prefill"}},
             {"labels": {"instance": "w1", "role": "decode"}}],
    "spans": [
        {"name": "serve.prefill", "span_id": "a", "parent_id": None, "trace_id": "t",
         "start_unix": 10.0, "duration_s": 0.5, "instance": "w0"},
        {"name": "kv.gather", "span_id": "b", "parent_id": "a", "trace_id": "t",
         "start_unix": 10.3, "duration_s": 0.1, "instance": "w0"},
        {"name": "kv.deserialize", "span_id": "c", "parent_id": "a", "trace_id": "t",
         "start_unix": 10.6, "duration_s": 0.05, "instance": "w1", "status": "error"},
        {"name": "serve.decode_dispatch", "span_id": "d", "parent_id": "c", "trace_id": "t",
         "start_unix": 10.7, "duration_s": 0.4, "instance": "w1"},
    ],
    "annotations": {"chunks": [{"t_s": 0.1, "bytes": 100}, {"t_s": 0.2, "bytes": 50}],
                    "compiles": [{"kind": "first", "executable": "flash_attention",
                                  "shape": "s1024", "seconds": 1.5}]},
    "events": [{"kind": "retry", "site": "kv.pull", "attempt": 1, "ts": 10.65}],
    "timeline": {"ttft_s": 0.6},
}
INDEX_ROWS = [{"id": "req1", "outcome": "breached", "klass": "chat", "engine": "disagg",
               "ttft_s": 0.6, "total_s": 1.1, "spans": 4, "revision": "r1", "instance": "w0"},
              {"id": "req2", "outcome": "errored", "ttft_s": None, "total_s": None,
               "spans": 0, "instance": "w1"}]
LEDGER_ENTRIES = [
    {"at": 1.0, "unix": 0.0, "kind": "revision_flip", "object": "default/web",
     "revision": "r2", "detail": {"from": "r1"}},
    {"at": 2.0, "unix": 0.0, "kind": "partition_move", "object": "default/web",
     "revision": "r2", "detail": {"partition": 1}},
]
DEVICE_BODY = {
    "instances": [{"labels": {"instance": "w0"}, "compile": {
        "records": [{"unix": 2.0, "executable": "paged.prefill", "kind": "recompile",
                     "shape": "b128", "seconds": 0.61}],
        "storms": {"paged.prefill": 3}}}],
    "executables": {"paged.prefill": {"first": 1, "recompiles": 3, "seconds": 2.4,
                                      "instances": 1},
                    "paged.step_n": {"first": 1, "recompiles": 0, "seconds": 0.8,
                                     "instances": 1}},
}


def render(case: str, cli, m, Ring) -> str:
    records = _canned_records()
    if case.startswith("top"):
        fams = fleet_fams(m)
        kw = {"top": {}, "top_by_class": {"by_class": True, "rows": cli._top_rows(
            fams, by_class=True)}, "top_by_tier": {"by_tier": True},
              "top_k1": {"top_k": 1}}[case]
        return cli.render_top(fams, alerts={"burn_rate": [{"source": "burn_rate:disagg/chat"}]},
                              **kw)
    if case == "monitor":
        return cli.render_monitor(ring_snapshot(Ring, m), fleet_fams(m),
                                  alerts={"burn_rate": [{"source": "burn_rate:disagg/chat"}]},
                                  now=20.0, decisions=records)
    if case == "request_index":
        return cli.render_request_index(copy.deepcopy(INDEX_ROWS))
    if case == "request_index_empty":
        return cli.render_request_index([])
    if case == "explain":
        return cli.render_explain(copy.deepcopy(JOURNEY))
    if case == "rollout":
        return cli.render_rollout(copy.deepcopy(LEDGER_ENTRIES), fleet_fams(m),
                                  {"canary_regression": [{"source": "canary:default/web"}]},
                                  decisions=records, now=100.0)
    if case.startswith("why"):
        rec = records[int(case[-1])]
        if case.startswith("why_fail"):
            rec["guards"][1] = {"name": "kill_switch", "passed": False,
                                "detail": "scale,rollout"}
        return cli.render_why(rec, now=100.0)
    if case == "act_lines":
        return "\n".join(cli._act_lines(records, now=100.0))
    if case == "profile":
        return cli.render_profile([("w0", PROFILE_SNAP), ("w1", PROFILE_SNAP)], top_n=5)
    assert case == "devices", case
    return cli.render_devices(copy.deepcopy(DEVICE_BODY),
                              pools=cli._pool_rows(m.parse_exposition(DEVICE_EXPOSITION)))


RENDER_CASES = ["top", "top_by_class", "top_by_tier", "top_k1", "monitor", "request_index",
                "request_index_empty", "explain", "rollout", "why0", "why1", "why2",
                "why_fail1", "act_lines", "profile", "devices"]


@pytest.mark.parametrize("case", RENDER_CASES)
def test_every_render_helper_draws_jax_s_frame(case):
    frames = {name: render(case, cli, m, Ring) for name, cli, m, Ring in SIDES}
    assert frames["port"] == frames["jax"]
    assert frames["port"].strip()


def test_why_renders_a_burn_row_without_data_where_jax_s_raises():
    rec = _canned_records()[1]
    rec["inputs"]["burns"][0].update(short_burn=None, long_burn=None)
    with pytest.raises(TypeError):
        jcli.render_why(copy.deepcopy(rec), now=100.0)
    row = next(ln for ln in pcli.render_why(rec, now=100.0).splitlines() if "paged/chat@w0" in ln)
    assert row.split()[1:5] == ["fast", "-", "-", "14.4x"]


# ---------------------------------------------------------------------------
# The commands against the two API servers

CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b|\b\d+(\.\d+)?s ago\b")


def run_both(capsys, servers, *argv) -> dict:
    """{"jax"|"port": (rc, stdout, stderr)} of `argv --server <its server>`."""
    out = {}
    for (name, cli, _, _), url in zip(SIDES, servers.urls):
        try:
            rc = cli.main([*argv, "--server", url.removeprefix("http://")])
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else str(e.code)
        got = capsys.readouterr()
        out[name] = (rc, CLOCK.sub("<t>", got.out), CLOCK.sub("<t>", got.err))
    return out


def without_control_plane(text: str) -> str:
    """A frame without the rows of the instance "control-plane", which are
    each package's own process registries."""
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("control-plane"))


@pytest.mark.parametrize("argv", [
    ("top",), ("top", "--by-class"), ("top", "--by-tier", "--top-k", "2"),
    ("monitor",), ("monitor", "serving_tokens", "--top", "4"),
    ("explain", "--errored"), ("explain", "req-none"), ("explain",),
    ("rollout",), ("rollout", "--timeline-only"), ("rollout", "--json"),
    ("why", "last"), ("why", "last:scale"), ("why", "scale-000001", "--json"),
    ("why", "scale-999999"),
    ("profile",), ("profile", "--fleet"), ("profile", "--collapsed"),
    ("devices",), ("devices", "--json"),
    ("faults",), ("faults", "kv.ack=drop:1"), ("faults", "--clear"), ("faults", "bad"),
    ("faults", "--drain"),
], ids=lambda a: " ".join(a))
def test_every_read_command_answers_as_jax_s(argv, capsys, servers):
    got = run_both(capsys, servers, *argv)
    (jrc, jout, jerr), (prc, pout, perr) = got["jax"], got["port"]
    assert prc == jrc and perr == jerr
    if argv[0] in ("top", "devices") or argv[:2] == ("profile", "--fleet"):
        if "--json" in argv:
            body = {k: [e for e in v if (e.get("labels") or {}).get("instance") != "control-plane"]
                    if k == "instances" else v for k, v in json.loads(pout).items()}
            jbody = {k: [e for e in v if (e.get("labels") or {}).get("instance")
                         != "control-plane"] if k == "instances" else v
                     for k, v in json.loads(jout).items()}
            assert body["instances"] == jbody["instances"]
        else:
            assert without_control_plane(pout) == without_control_plane(jout)
    elif "--json" in argv:
        # Ledger entries the store feeds carry each server's clocks.
        keys = WALL_KEYS | DECISION_CLOCK
        assert normalize(json.loads(pout), keys) == normalize(json.loads(jout), keys)
    else:
        assert pout == jout
    if argv[0] == "faults" and jrc == 0:
        for side in (JAX, PORT):
            side.faults.INJECTOR.disarm()
