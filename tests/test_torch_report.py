"""The port's copies of the report plane pinned to the JAX package's: the
derived signals (lws_tpu_torch/obs/signals.py), the scale recommender's
evaluation (obs/recommend.py), the revision folds and canary analyzer
(obs/rollout.py), and the loadgen report (loadgen/report.py: the four
folds and `render_report`). The same seeded point series, the same
expositions ingested into each package's HistoryRing at the same `now`
values, and the same canned summaries give equal results: equal floats
(`==`, the same operations in the same order), equal dicts and the same
text byte for byte. The canned cases are the JAX tests' own
(tests/test_loadgen.py, tests/test_rollout_plane.py,
tests/test_decision_plane.py)."""

import dataclasses

import numpy as np
import pytest

from lws_tpu import loadgen as jloadgen
from lws_tpu.core import flightrecorder as jfr
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import slo as jslo
from lws_tpu.obs import history as jhistory
from lws_tpu.obs import recommend as jrecommend
from lws_tpu.obs import rollout as jrollout
from lws_tpu.obs import signals as jsignals
from lws_tpu_torch import loadgen
from lws_tpu_torch.core import flightrecorder, metrics, slo
from lws_tpu_torch.obs import history, recommend, rollout, signals

PORT = dict(loadgen=loadgen, fr=flightrecorder, metrics=metrics, slo=slo, history=history,
            recommend=recommend, rollout=rollout, signals=signals)
JAX = dict(loadgen=jloadgen, fr=jfr, metrics=jmetrics, slo=jslo, history=jhistory,
           recommend=jrecommend, rollout=jrollout, signals=jsignals)


def plain(x):
    """Results made comparable across packages: dataclasses (BurnVerdict,
    BurnWindow) become their fields, plus `firing` where they have it."""
    if dataclasses.is_dataclass(x):
        out = dataclasses.asdict(x)
        if hasattr(x, "firing"):
            out["firing"] = x.firing
        return out
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def windows(pkg, scale: float = 0.05):
    """Second-scale twins of the SRE burn windows, as the JAX tests use."""
    return tuple(w.scaled(scale) for w in pkg["signals"].DEFAULT_BURN_WINDOWS)


def targets(pkg, spec: dict) -> dict:
    return {k: pkg["slo"].SLOTargets(**v) for k, v in spec.items()}


# ---------------------------------------------------------------------------
# Signals: pure folds over seeded point series


def series(seed: int, n: int = 14, counter: bool = True, start: float = 0.0) -> list:
    rng = np.random.default_rng(seed)
    t = start + np.cumsum(rng.uniform(0.5, 20.0, n))
    v = np.cumsum(rng.uniform(0.0, 50.0, n)) if counter else rng.uniform(0.0, 1.0, n)
    return [(float(a), float(b)) for a, b in zip(t, v)]


def good_of(total: list, seed: int, drop_every: int = 0) -> list:
    """A goodput counter beside `total`: a seeded share of each step, with
    every `drop_every`-th sample missing (the carried-forward path)."""
    rng = np.random.default_rng(seed)
    out, acc, prev = [], 0.0, 0.0
    for i, (t, v) in enumerate(total):
        acc += (v - prev) * float(rng.uniform(0.3, 1.0))
        prev = v
        if not drop_every or i % drop_every:
            out.append((t, acc))
    return out


def buckets(seed: int, n: int = 10) -> dict:
    """{le: cumulative count points}: a histogram's bucket series."""
    rng = np.random.default_rng(seed)
    les = ["0.001", "0.01", "0.1", "0.5", "1.0", "5.0", "+Inf"]
    ts = np.cumsum(rng.uniform(1.0, 15.0, n))
    counts = np.cumsum(rng.integers(0, 6, (n, len(les))), axis=0)
    cum = np.cumsum(counts, axis=1)
    return {le: [(float(t), float(c)) for t, c in zip(ts, cum[:, j])]
            for j, le in enumerate(les)}


TOTAL, GAUGE, HIST = series(1), series(2, counter=False), buckets(3)
GOOD, GOOD_SPARSE = good_of(TOTAL, 4), good_of(TOTAL, 5, drop_every=3)
NOW = TOTAL[-1][0]
CUM = [(le, pts[-1][1]) for le, pts in HIST.items()]
CUM_F = [(float("inf") if le == "+Inf" else float(le), c) for le, c in CUM]

SIGNAL_CASES = {
    "clip": lambda s: s.clip(TOTAL, 60.0, NOW),
    "clip-unbounded": lambda s: s.clip(TOTAL, None, NOW),
    "last": lambda s: (s.last(TOTAL), s.last([])),
    "increase": lambda s: (s.increase(TOTAL), s.increase(TOTAL, 60.0, NOW),
                           s.increase(TOTAL[:1]), s.increase(TOTAL, 1e-3, NOW)),
    "rate": lambda s: (s.rate(TOTAL), s.rate(TOTAL, 90.0, NOW), s.rate([(1.0, 2.0), (1.0, 3.0)])),
    "mean": lambda s: (s.mean(GAUGE), s.mean(GAUGE, 50.0, GAUGE[-1][0]), s.mean(GAUGE[:1]),
                       s.mean([(2.0, 1.0), (2.0, 3.0)])),
    "ewma": lambda s: (s.ewma(GAUGE, 30.0), s.ewma(GAUGE, 0.0), s.ewma(GAUGE, 5.0, 60.0,
                                                                       GAUGE[-1][0])),
    "slope": lambda s: (s.slope(GAUGE), s.slope(GAUGE, 40.0, GAUGE[-1][0]), s.slope(GAUGE[:1])),
    "error_series": lambda s: (s.error_series(GOOD, TOTAL), s.error_series(GOOD_SPARSE, TOTAL),
                               s.error_series([], TOTAL)),
    "histogram_quantile": lambda s: [s.histogram_quantile(CUM_F, q)
                                     for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
                                    + [s.histogram_quantile([], 0.5)],
    "quantile_over_window": lambda s: [s.quantile_over_window(HIST, q, w, NOW)
                                       for q in (0.5, 0.95) for w in (None, 40.0, 1e-3)],
    "breach_fraction": lambda s: [s.breach_fraction(HIST, target, w, NOW)
                                  for target in (0.005, 0.1, 0.7, 50.0) for w in (None, 40.0)],
    "burn_windows": lambda s: (s.burn_windows(), s.burn_windows(0.05), s.burn_windows(1.0)),
    "burn_rate_from_counters": lambda s: [
        s.burn_rate_from_counters(g, TOTAL, target, w, NOW)
        for g in (GOOD, GOOD_SPARSE, []) for target in (0.99, 0.9, 1.0) for w in (30.0, 300.0)],
    "burn_rate_from_gauge": lambda s: [
        s.burn_rate_from_gauge(GAUGE, target, w, GAUGE[-1][0])
        for target in (0.99, 0.5, 1.0) for w in (30.0, 3600.0)],
    "multiwindow_burn": lambda s: [
        s.multiwindow_burn(g, TOTAL, 0.99, ws, NOW)
        for g in (GOOD, []) for ws in (None, tuple(w.scaled(0.05)
                                                   for w in s.DEFAULT_BURN_WINDOWS))],
}


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
@pytest.mark.parametrize("scale_env", [None, "0.01", "bad"], ids=["env-unset", "env-0.01",
                                                                   "env-bad"])
def test_signals_equal_jax(monkeypatch, case, scale_env):
    if scale_env is None:
        monkeypatch.delenv(signals.BURN_WINDOW_SCALE_ENV, raising=False)
    else:
        monkeypatch.setenv(signals.BURN_WINDOW_SCALE_ENV, scale_env)
    fn = SIGNAL_CASES[case]
    assert plain(fn(signals)) == plain(fn(jsignals))


# ---------------------------------------------------------------------------
# Rings fed the same expositions


def feed(case: str) -> list:
    """[(now, exposition text)]: cumulative registries rendered at each
    sample time, seeded, for one ring shape."""
    out = []
    rng = np.random.default_rng(sum(map(ord, case)))
    acc: dict = {}

    def add(key, v):
        acc[key] = acc.get(key, 0.0) + v
        return acc[key]

    if case == "canary":  # tests/test_rollout_plane.py::_canary_ring
        tot = 0.0
        for t in (0.0, 90.0, 180.0, 195.0):
            tot += 500.0
            reg = metrics.MetricsRegistry()
            reg.inc("serving_tokens_total", {"engine": "paged", "revision": "r1"}, tot * 2)
            reg.inc("serving_goodput_tokens_total", {"engine": "paged", "revision": "r1"},
                    tot * 2)
            reg.inc("serving_tokens_total", {"engine": "paged", "revision": "r2"}, tot)
            out.append((t, reg.render()))
        return out
    if case == "revisions":  # tests/test_rollout_plane.py:181
        for t, tok, good in ((0.0, 100.0, 80.0), (60.0, 200.0, 160.0)):
            reg = metrics.MetricsRegistry()
            la = {"engine": "paged", "revision": "rA"}
            reg.inc("serving_tokens_total", la, tok)
            reg.inc("serving_goodput_tokens_total", la, good)
            reg.inc("serving_tokens_total", {"engine": "paged", "revision": "rB"}, tok / 2)
            reg.set("serving_slo_attainment", 0.9 if t else 0.95, la)
            reg.inc("serving_spec_tokens_total", {**la, "kind": "drafted"}, tok)
            reg.inc("serving_spec_tokens_total", {**la, "kind": "accepted"}, good)
            reg.inc("serving_prefix_cache_hits_total", la, 30.0 * (1 + (t > 0)))
            reg.inc("serving_prefix_cache_misses_total", la, 10.0 * (1 + (t > 0)))
            reg.observe("serving_ttft_seconds", 3.0, la)
            if t:
                reg.observe("serving_ttft_seconds", 0.2, la)
            out.append((t, reg.render()))
        return out
    if case == "stub_fleet":  # tests/test_loadgen.py:576-627's /metrics/fleet
        for n in range(1, 7):
            reg = metrics.MetricsRegistry()
            labels = {"engine": "disagg", "klass": "chat", "instance": "w0"}
            reg.inc("serving_tokens_total", labels, 100.0 * n)
            reg.inc("serving_goodput_tokens_total", labels, 90.0 * n)
            out.append((0.5 * n, reg.render()))
        return out
    if case == "actuations":  # tests/test_decision_plane.py:609
        steps = [(0.0, {"scale/scale_out/applied": 1.0}, {}),
                 (30.0, {"scale/scale_out/applied": 1.0, "scale/scale_in/applied": 1.0}, {}),
                 (60.0, {"scale/scale_out/applied": 2.0, "scale/scale_in/applied": 1.0},
                  {"scale": 1.0})]
        for t, acts, flaps in steps:
            reg = metrics.MetricsRegistry()
            for key, v in acts.items():
                plane, action, outcome = key.split("/")
                reg.inc("serving_actuations_total",
                        {"plane": plane, "action": action, "outcome": outcome}, v)
            for plane, v in flaps.items():
                reg.inc("serving_actuation_flaps_total", {"plane": plane}, v)
            out.append((t, reg.render()))
        return out
    # "phases" / "calm" / "kv" / "instances": the recommender's full input set —
    # per-class token ledgers, TTFT/queue-wait/ITL histograms and the KV
    # pool's block states, over seeded steps.
    instances = ("w0", "w1") if case == "instances" else ("",)
    t = 0.0
    for step in range(12):
        t += float(rng.uniform(2.0, 12.0))
        reg = metrics.MetricsRegistry()
        for inst in instances:
            base = {"instance": inst} if inst else {}
            hot = case not in ("calm", "kv") and inst != "w0"
            for klass in ("chat", "batch"):
                labels = {**base, "engine": "paged", "klass": klass}
                tok = float(rng.integers(10, 60))
                share = float(rng.uniform(0.1, 0.6) if hot and step > 4 else 1.0)
                reg.inc("serving_tokens_total", labels, add(("tok", inst, klass), tok))
                reg.inc("serving_goodput_tokens_total", labels,
                        add(("good", inst, klass), tok * share))
                for name, scale in (("serving_ttft_seconds", 2.0 if hot else 0.05),
                                    ("serving_queue_wait_seconds", 1.0 if hot else 0.01),
                                    ("serving_itl_seconds", 0.3 if hot else 0.005)):
                    draws = acc.setdefault((name, inst, klass), [])
                    draws.extend(float(x) for x in rng.exponential(scale, 4))
                    for x in draws:
                        reg.observe(name, x, labels)
            live = {"calm": 5.0, "kv": 58.0}.get(case, float(min(60, 5 + step * 5)))
            for state, v in (("live", live), ("free", 64.0 - live), ("parked", 2.0)):
                reg.set("serving_kv_pool_blocks", v, {**base, "engine": "paged", "state": state})
        out.append((t, reg.render()))
    return out


def ring(pkg, case: str):
    r = pkg["history"].HistoryRing(interval_s=0.0, retention_s=3600.0,
                                   metrics_registry=pkg["metrics"].MetricsRegistry())
    for t, text in feed(case):
        r.ingest(text, now=t)
    return r


def registry_samples(pkg, reg) -> list:
    fams = pkg["metrics"].parse_exposition(reg.render())
    return sorted((name, sorted(labels.items()), v)
                  for fam in fams.values() for name, labels, v, _ in fam["samples"])


def recorder_state(fr) -> tuple:
    beats = {k: dataclasses.asdict(v) for k, v in fr.snapshot_beats().items()}
    events = [{k: v for k, v in e.items() if k != "ts"} for e in fr.events()]
    return beats, events


CLASS_TARGETS = {"chat": {"ttft_s": 0.5, "itl_s": 0.05, "queue_wait_s": 0.2},
                 "batch": {"ttft_s": 5.0, "itl_s": 1.0, "queue_wait_s": 5.0}}


def _recommend(pkg, case: str, current):
    r = ring(pkg, case)
    reg, fr = pkg["metrics"].MetricsRegistry(), pkg["fr"].FlightRecorder()
    rec = pkg["recommend"].ScaleRecommender(
        r, targets=pkg["slo"].SLOTargets(ttft_s=1.0, itl_s=0.1, queue_wait_s=0.5),
        class_targets=targets(pkg, CLASS_TARGETS), attainment_target=0.99,
        windows=windows(pkg), current=current, registry=reg, recorder=fr)
    times = sorted({t for _, _, _, pts, _ in r.series() for t, _ in pts})
    verdicts = [rec.evaluate(now=t).to_dict() for t in times + [times[-1] + 400.0]]
    return verdicts, registry_samples(pkg, reg), recorder_state(fr)


@pytest.mark.parametrize("case,current", [
    ("phases", None), ("calm", {"prefill": 3, "decode": 2}), ("kv", None),
    ("instances", {"decode": 2}), ("canary", None), ("stub_fleet", {"prefill": 1, "decode": 4}),
])
def test_scale_recommender_evaluates_alike(case, current):
    got, want = _recommend(PORT, case, current), _recommend(JAX, case, current)
    assert got == want
    # The cases reach each branch of the policy, not only "no signal".
    reasons = {r for v in got[0] for r in v["reasons"].values()}
    branch = {"phases": "burn ", "instances": "burn ", "calm": "calm: ",
              "kv": "kv occupancy "}.get(case, "no signal")
    assert any(r.startswith(branch) for r in reasons), reasons


def _canary(pkg, case: str, kw: dict):
    r = ring(pkg, case)
    reg, fr = pkg["metrics"].MetricsRegistry(), pkg["fr"].FlightRecorder()
    an = pkg["rollout"].CanaryAnalyzer(r, lws="default/sample", registry=reg, recorder=fr,
                                       **({**kw, "windows": windows(pkg)} if kw else {}))
    times = sorted({t for _, _, _, pts, _ in r.series("serving_tokens_total") for t, _ in pts})
    reports = [an.evaluate(now=t).to_dict() for t in times + [times[-1] + 5.0]]
    folds = [(rev, pkg["rollout"].revision_good_fraction(r, rev),
              pkg["rollout"].revision_spec_fraction(r, rev),
              pkg["rollout"].revision_prefix_fraction(r, rev),
              pkg["rollout"].revision_attainment(r, rev),
              pkg["rollout"].revision_quantile(r, "serving_ttft_seconds_bucket", 0.5, rev),
              pkg["rollout"].revision_samples(r, rev),
              plain(pkg["rollout"].revision_burn(r, rev, 0.99, windows(pkg), times[-1])))
             for rev in pkg["rollout"].revision_values(r) + ["rZ"]]
    return reports, folds, registry_samples(pkg, reg), recorder_state(fr)


GUARDS = dict(attainment_target=0.99, min_samples=100.0, min_duration_s=50.0, delta=2.0)


@pytest.mark.parametrize("case,kw", [("canary", GUARDS), ("canary", {}), ("revisions", GUARDS),
                                     ("revisions", {}), ("phases", GUARDS)],
                         ids=["canary-guards", "canary-env", "revisions-guards", "revisions-env",
                              "no-revisions"])
def test_canary_analyzer_evaluates_alike(case, kw):
    got, want = _canary(PORT, case, kw), _canary(JAX, case, kw)
    assert got == want
    if case == "canary" and kw:
        final = got[0][-2]["verdicts"]  # at the ring's last sample, t = 195
        assert final["r2"]["verdict"] == "rollback" and final["r1"]["verdict"] == "promote"


# ---------------------------------------------------------------------------
# The report's folds and its text frame


FLEET_TEXT = (  # tests/test_loadgen.py:437
    "# HELP serving_tokens_total x\n# TYPE serving_tokens_total counter\n"
    'serving_tokens_total{engine="paged",klass="chat"} 60.0\n'
    "# HELP serving_goodput_tokens_total x\n"
    "# TYPE serving_goodput_tokens_total counter\n"
    'serving_goodput_tokens_total{engine="paged",klass="chat"} 48.0\n'
    "# HELP serving_prefix_cache_hits_total x\n"
    "# TYPE serving_prefix_cache_hits_total counter\n"
    "serving_prefix_cache_hits_total 30.0\n"
    "# HELP serving_prefix_cache_misses_total x\n"
    "# TYPE serving_prefix_cache_misses_total counter\n"
    "serving_prefix_cache_misses_total 10.0\n"
)
FLEET_FULL = FLEET_TEXT + (
    "# HELP serving_spec_tokens_total x\n# TYPE serving_spec_tokens_total counter\n"
    'serving_spec_tokens_total{kind="drafted"} 40.0\n'
    'serving_spec_tokens_total{kind="accepted"} 13.0\n'
    "# HELP serving_kv_pool_blocks x\n# TYPE serving_kv_pool_blocks gauge\n"
    'serving_kv_pool_blocks{instance="w0",state="live"} 12.0\n'
    'serving_kv_pool_blocks{instance="w0",state="free"} 40.0\n'
    'serving_kv_pool_blocks{instance="w1",state="parked"} 3.0\n'
    'serving_kv_pool_blocks{instance="w1",state="live"} 9.0\n'
)
FLEETS = {"loadgen-437": FLEET_TEXT, "full": FLEET_FULL, "empty": ""}


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fold_fleet_equals_jax(case):
    got = loadgen.fold_fleet(metrics.parse_exposition(FLEETS[case]))
    assert got == jloadgen.fold_fleet(jmetrics.parse_exposition(FLEETS[case]))
    if case == "loadgen-437":
        assert got["goodput"] == 0.8 and got["pfx"] == 0.75 and got["spec"] is None


@pytest.mark.parametrize("case,kw", [
    ("phases", {"targets": True, "windows": True}), ("phases", {}),
    ("instances", {"targets": True, "windows": True, "current": {"decode": 3}}),
    ("stub_fleet", {"targets": True}), ("stub_fleet", {"windows": True, "max_steps": 2}),
    ("canary", {"windows": True}), ("actuations", {}),
])
def test_fold_history_equals_jax(case, kw):
    def fold(pkg):
        return pkg["loadgen"].fold_history(
            ring(pkg, case), targets(pkg, CLASS_TARGETS) if kw.get("targets") else None,
            windows=windows(pkg) if kw.get("windows") else None, current=kw.get("current"),
            max_steps=kw.get("max_steps", 64))

    got = fold(PORT)
    assert got == fold(JAX)
    if case == "stub_fleet":
        assert set(got["classes"]) == {"disagg/chat"} and got["recommendation"]


@pytest.mark.parametrize("case,kw", [("canary", GUARDS), ("canary", {}), ("revisions", {}),
                                     ("revisions", GUARDS), ("phases", {}), ("empty", {})],
                         ids=["canary-guards", "canary-env", "revisions-env",
                              "revisions-guards", "no-revisions", "empty"])
def test_fold_canary_equals_jax(case, kw):
    def fold(pkg):
        r = (pkg["history"].HistoryRing(interval_s=0.0, retention_s=60.0) if case == "empty"
             else ring(pkg, case))
        return pkg["loadgen"].fold_canary(
            r, lws="default/sample", **({**kw, "windows": windows(pkg)} if kw else {}))

    got = fold(PORT)
    assert got == fold(JAX)
    if case in ("phases", "empty"):
        assert got is None
    elif case == "canary" and kw:  # tests/test_rollout_plane.py:602
        assert got["baseline"] == "r1" and got["trace"][0]["t"] == 0.0
        assert got["trace"][-1]["verdicts"]["r2"] == "rollback"


@pytest.mark.parametrize("case", ["actuations", "phases", "empty"])
def test_fold_actuations_equals_jax(case):
    def fold(pkg):
        r = (pkg["history"].HistoryRing(interval_s=0.0, retention_s=60.0) if case == "empty"
             else ring(pkg, case))
        return pkg["loadgen"].fold_actuations(r)

    got = fold(PORT)
    assert got == fold(JAX)
    if case == "actuations":  # tests/test_decision_plane.py:609
        assert got["actuations"] == {"scale/scale_out/applied": 2.0,
                                     "scale/scale_in/applied": 1.0}
        assert got["flaps"] == {"scale": 1.0}
    else:
        assert got is None


ALL = {"count": 10, "completed": 10, "attainment": 0.9, "goodput_fraction": 0.8, "tokens": 60,
       "good_tokens": 48, "ttft_p50": 0.01, "ttft_p95": 0.05, "ttft_p99": 0.06,
       "itl_p50": 0.001, "itl_p95": 0.002, "itl_p99": 0.003}
BASE = {"scenario": "steady_poisson", "seed": 1, "horizon_s": 1.5, "wall_s": 1.6,
        "offered_rps": 12.0, "achieved_rps": 11.5, "classes": {}, "all": ALL}
REPORTS = {
    "loadgen-437": {**BASE, "classes": {"chat": {**ALL, "queue_p95": 0.004}}},
    "rollout-621": {**BASE, "scenario": "rolling_update", "canary": {
        "baseline": "r1",
        "revisions": {
            "r1": {"verdict": "promote", "short_burn": 0.0, "samples": 3000.0,
                   "duration_s": 195.0, "reason": "within budget (fast burn 0.00x)"},
            "r2": {"verdict": "rollback", "short_burn": 100.0, "samples": 1500.0,
                   "duration_s": 195.0, "reason": "fast burn 100.0x vs baseline 0.0x"}},
        "trace": [{"t": 0.0, "baseline": "", "verdicts": {"r1": "hold", "r2": "hold"}},
                  {"t": 195.0, "baseline": "r1",
                   "verdicts": {"r1": "promote", "r2": "rollback"}}]}},
    "decision-closed-loop": {**BASE, "scenario": "flash_crowd", "seed": 7, "actuations": {
        "actuations": {"scale/scale_out/applied": 1.0, "scale/scale_in/applied": 1.0},
        "flaps": {}, "trace": [{"t": 0.5, "what": "scale/scale_out/applied", "count": 1.0}]}},
    "history-worst": {**BASE, "seed": None, "wall_s": None, "classes": {
        "chat": {**ALL, "attainment": None, "ttft_p99": None, "queue_p95": None, "worst": [
            {"id": "#3", "ttft_s": 2.5, "total_s": 3.0, "completed": True, "attained": False},
            {"id": "#1", "completed": False}]},
        "batch": {"count": 2, "completed": 1, "tokens": 9}},
        "history": {"classes": {"disagg/chat": {"peak_fast_burn": 14.5, "final_fast_burn": 0.0},
                                "disagg": {"peak_fast_burn": None, "final_fast_burn": None}},
                    "recommendation": [{"t": 0.0, "desired": {"prefill": 1, "decode": 1}},
                                       {"t": 1.25, "desired": {"prefill": 2, "decode": 1}}]},
        "actuations": {"actuations": {"rollout/rollback/applied": 1.0},
                       "flaps": {"scale": 2.0}, "trace": []}},
}


@pytest.mark.parametrize("case,fleet", [("loadgen-437", "loadgen-437"), ("loadgen-437", None),
                                        ("rollout-621", None), ("decision-closed-loop", None),
                                        ("history-worst", "full"), ("history-worst", "empty")])
def test_render_report_equals_jax(case, fleet):
    def render(pkg):
        parsed = None if fleet is None else pkg["metrics"].parse_exposition(FLEETS[fleet])
        return pkg["loadgen"].render_report(REPORTS[case], parsed)

    got = render(PORT)
    assert got == render(JAX)
    if fleet == "loadgen-437":
        assert "GOODPUT%=80%" in got and "PFX%=75%" in got
    if case == "rollout-621":
        assert "canary @195.00s: r1=promote r2=rollback" in got
