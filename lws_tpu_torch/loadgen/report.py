"""Scenario report rendering: the port's copy of lws_tpu/loadgen/report.py,
whole — pure functions of the summary (and an optional parsed fleet
exposition), so tests drive them from canned data.

The report answers the capacity questions in the order an operator asks
them: did the service keep up (offered vs achieved load), did it keep its
promises (per-class attainment + latency quantiles), and did the work it
did count (goodput fraction — tokens on time / tokens delivered). The
optional fleet block folds the server-side capacity columns `lws-tpu top`
shows (PFX% / SPEC% / KV% / GOODPUT%) out of the same /metrics/fleet
surface, so the client-side and server-side views sit in one frame.
"""

from __future__ import annotations

from typing import Optional


def fold_fleet(fams: dict) -> dict:
    """Parsed fleet families (core.metrics.parse_exposition shape) ->
    {pfx, spec, kv, goodput} fractions (None where the feeding series are
    absent). The same folds `lws-tpu top` derives its columns from."""

    def total(family: str, want: Optional[dict] = None) -> float:
        acc = 0.0
        for name, labels, value, _ in fams.get(family, {}).get("samples", []):
            if name != family:
                continue
            if want and any(labels.get(k) != v for k, v in want.items()):
                continue
            acc += value
        return acc

    out: dict = {}
    hits = total("serving_prefix_cache_hits_total")
    misses = total("serving_prefix_cache_misses_total")
    out["pfx"] = hits / (hits + misses) if (hits + misses) > 0 else None
    drafted = total("serving_spec_tokens_total", {"kind": "drafted"})
    accepted = total("serving_spec_tokens_total", {"kind": "accepted"})
    out["spec"] = accepted / drafted if drafted > 0 else None
    live = total("serving_kv_pool_blocks", {"state": "live"})
    pool = live + total("serving_kv_pool_blocks", {"state": "free"}) \
        + total("serving_kv_pool_blocks", {"state": "parked"})
    out["kv"] = live / pool if pool > 0 else None
    tokens = total("serving_tokens_total")
    good = total("serving_goodput_tokens_total")
    out["goodput"] = good / tokens if tokens > 0 else None
    return out


def fold_history(ring, targets_by_class: Optional[dict] = None,
                 attainment_target: Optional[float] = None,
                 windows: Optional[tuple] = None,
                 current: Optional[dict] = None,
                 max_steps: int = 64) -> dict:
    """Fold a HistoryRing sampled DURING the run (`lws-tpu loadgen
    --server`) into the report's history block: per-class peak/final
    fast-window burn over the run, plus the recommendation trace —
    a throwaway ScaleRecommender replayed at each retained sample time,
    recording every point the desired-replica verdict changed. Pure
    function of the ring (private registry/recorder), so it never leaks
    gauges or alerts into the driving process."""
    from lws_tpu_torch.core.flightrecorder import FlightRecorder
    from lws_tpu_torch.core.metrics import MetricsRegistry
    from lws_tpu_torch.obs import signals
    from lws_tpu_torch.obs.recommend import (
        DEFAULT_ATTAINMENT_TARGET,
        ScaleRecommender,
    )

    if attainment_target is None:
        attainment_target = DEFAULT_ATTAINMENT_TARGET
    windows = windows if windows is not None else signals.burn_windows()
    fast = windows[0]
    goods = {
        tuple(sorted(labels.items())): pts
        for _, labels, _, pts, _ in ring.series("serving_goodput_tokens_total")
    }
    classes: dict = {}
    times: set = set()
    for _, labels, _, total, _ in ring.series("serving_tokens_total"):
        good = goods.get(tuple(sorted(labels.items())), [])
        key = labels.get("engine", "-")
        if labels.get("klass"):
            key += "/" + labels["klass"]
        peak = final = None
        for t, _v in total:
            burn = signals.burn_rate_from_counters(
                good, total, attainment_target, fast.short_s, now=t)
            if burn is None:
                continue
            final = burn
            if peak is None or burn > peak:
                peak = burn
        # A fleet-fed ring holds the same (engine, klass) once per
        # instance: both columns fold as the WORST instance (independent
        # maxes — a calm survivor must not mask the peak, and the peak
        # winner's stale tail must not pin the FINAL column).
        slot = classes.setdefault(key, {"peak_fast_burn": None,
                                        "final_fast_burn": None})
        if peak is not None and (slot["peak_fast_burn"] is None
                                 or peak > slot["peak_fast_burn"]):
            slot["peak_fast_burn"] = peak
        if final is not None and (slot["final_fast_burn"] is None
                                  or final > slot["final_fast_burn"]):
            slot["final_fast_burn"] = final
        times.update(t for t, _v in total)
    rec = ScaleRecommender(
        ring, class_targets=targets_by_class or {},
        attainment_target=attainment_target, windows=windows,
        current=current, registry=MetricsRegistry(),
        recorder=FlightRecorder(),
    )
    trace: list = []
    last_desired: Optional[dict] = None
    t0 = min(times) if times else 0.0  # trace times are RUN-relative
    for t in sorted(times)[-max_steps:]:
        verdict = rec.evaluate(now=t)
        if verdict.desired != last_desired:
            trace.append({
                "t": round(t - t0, 3),
                "desired": dict(verdict.desired),
                "reasons": dict(verdict.reasons),
            })
            last_desired = dict(verdict.desired)
    return {"classes": classes, "recommendation": trace}


def fold_canary(ring, lws: str = "-",
                attainment_target: Optional[float] = None,
                windows: Optional[tuple] = None,
                min_samples: Optional[float] = None,
                min_duration_s: Optional[float] = None,
                delta: Optional[float] = None,
                max_steps: int = 64) -> Optional[dict]:
    """Fold a run-sampled HistoryRing into the report's canary block: the
    verdict trace a throwaway CanaryAnalyzer produces when replayed
    at each retained sample time (every point any revision's verdict
    changed, run-relative), plus the final per-revision verdict table.
    Pure function of the ring — private registry/recorder, no ledger — so
    it never leaks gauges or alerts into the driving process. None when the
    ring carries no revision-labelled serving series (nothing to compare)."""
    from lws_tpu_torch.core.flightrecorder import FlightRecorder
    from lws_tpu_torch.core.metrics import MetricsRegistry
    from lws_tpu_torch.obs import rollout

    if not rollout.revision_values(ring):
        return None
    analyzer = rollout.CanaryAnalyzer(
        ring, lws=lws, attainment_target=attainment_target,
        windows=windows, min_samples=min_samples,
        min_duration_s=min_duration_s, delta=delta,
        registry=MetricsRegistry(), recorder=FlightRecorder(),
    )
    times: set = set()
    for _, _labels, _, pts, _ in ring.series("serving_tokens_total"):
        times.update(t for t, _v in pts)
    if not times:
        return None
    t0 = min(times)  # trace times are RUN-relative
    trace: list = []
    last: Optional[dict] = None
    report = None
    for t in sorted(times)[-max_steps:]:
        report = analyzer.evaluate(now=t)
        verdicts = {r: v.verdict for r, v in report.verdicts.items()}
        if verdicts != last:
            trace.append({"t": round(t - t0, 3), "baseline": report.baseline,
                          "verdicts": dict(verdicts)})
            last = dict(verdicts)
    if report is None:
        return None
    return {
        "baseline": report.baseline,
        "revisions": {r: v.to_dict() for r, v in report.verdicts.items()},
        "trace": trace,
    }


def fold_actuations(ring) -> Optional[dict]:
    """Fold a run-sampled HistoryRing's actuation counters into the
    report's closed-loop block: per-(plane, action, outcome) totals from
    `serving_actuations_total`, per-plane flap totals from
    `serving_actuation_flaps_total`, and a run-relative trace of each
    count step — the loadgen-side view of the decision plane
    (obs/decisions.py), so a closed-loop sweep's report shows WHAT the
    fleet did about the traffic it generated. Totals are the counters'
    final sampled values. None when the ring never saw an actuation
    series (open-loop run, or a server predating the decision plane)."""
    rows = list(ring.series("serving_actuations_total"))
    if not rows:
        return None
    t_all = [t for _, _, _, pts, _ in rows for t, _v in pts]
    t0 = min(t_all) if t_all else 0.0  # trace times are RUN-relative
    actuations: dict = {}
    trace: list = []
    for _, labels, _, pts, _ in rows:
        if not pts:
            continue
        key = "{}/{}/{}".format(labels.get("plane", "-"),
                                labels.get("action", "-"),
                                labels.get("outcome", "-"))
        actuations[key] = actuations.get(key, 0.0) + pts[-1][1]
        prev = 0.0
        for t, v in pts:
            if v > prev:
                trace.append({"t": round(t - t0, 3), "what": key,
                              "count": v})
            prev = v
    trace.sort(key=lambda step: step["t"])
    flaps: dict = {}
    for _, labels, _, pts, _ in ring.series("serving_actuation_flaps_total"):
        if pts:
            plane = labels.get("plane", "-")
            flaps[plane] = flaps.get(plane, 0.0) + pts[-1][1]
    return {"actuations": actuations, "flaps": flaps, "trace": trace[-64:]}


def _fmt(v, pattern: str = "{:.3f}", dash: str = "-") -> str:
    return pattern.format(v) if v is not None else dash


def render_report(report: dict, fleet: Optional[dict] = None) -> str:
    """One scenario report frame. `report` is runner.summarize()'s dict;
    `fleet` an optional parsed /metrics/fleet exposition."""
    total = report["all"]
    lines = [
        f"SCENARIO {report.get('scenario') or '-'}"
        f"  seed={report.get('seed') if report.get('seed') is not None else '-'}"
        f"  requests={total['count']}  completed={total['completed']}"
        f"  wall={_fmt(report.get('wall_s'), '{:.2f}s')}",
        f"load: offered={_fmt(report.get('offered_rps'), '{:.1f}')} rps"
        f"  achieved={_fmt(report.get('achieved_rps'), '{:.1f}')} rps"
        f"  (horizon {_fmt(report.get('horizon_s'), '{:.2f}s')})",
        "",
        f"{'CLASS':<12}{'REQS':>6}{'DONE':>6}{'ATTAIN':>8}{'GOODPUT':>9}"
        f"{'TOKENS':>8}{'TTFT_P50':>10}{'TTFT_P95':>10}{'TTFT_P99':>10}"
        f"{'ITL_P50':>9}{'ITL_P95':>9}{'ITL_P99':>9}{'QUEUE_P95':>10}",
    ]

    def row(name: str, s: dict) -> str:
        return (
            f"{name:<12}{s['count']:>6}{s['completed']:>6}"
            f"{_fmt(s.get('attainment'), '{:.0%}'):>8}"
            f"{_fmt(s.get('goodput_fraction'), '{:.0%}'):>9}"
            f"{s.get('tokens', 0):>8}"
            f"{_fmt(s.get('ttft_p50'), '{:.3f}s'):>10}"
            f"{_fmt(s.get('ttft_p95'), '{:.3f}s'):>10}"
            f"{_fmt(s.get('ttft_p99'), '{:.3f}s'):>10}"
            f"{_fmt(s.get('itl_p50'), '{:.4f}s'):>9}"
            f"{_fmt(s.get('itl_p95'), '{:.4f}s'):>9}"
            f"{_fmt(s.get('itl_p99'), '{:.4f}s'):>9}"
            f"{_fmt(s.get('queue_p95'), '{:.3f}s'):>10}"
        )

    for name, stats in report["classes"].items():
        lines.append(row(name, stats))
    all_stats = dict(total)
    all_stats.setdefault("queue_p95", None)
    lines.append(row("ALL", all_stats))
    # Worst-K offenders per class, by journey id: a scenario run ends with
    # requests an operator can explain directly (`lws-tpu explain <id>` —
    # the tail vault retains every breached/errored/incomplete one).
    worst_lines = []
    for name, stats in report["classes"].items():
        for w in stats.get("worst") or []:
            state = ("incomplete" if not w.get("completed")
                     else ("ok" if w.get("attained") else "MISS"))
            worst_lines.append(
                f"worst {name}: {w.get('id', '-')}"
                f"  ttft={_fmt(w.get('ttft_s'), '{:.3f}s')}"
                f"  total={_fmt(w.get('total_s'), '{:.3f}s')}"
                f"  {state}"
            )
    if worst_lines:
        lines.append("")
        lines.extend(worst_lines)
    if fleet is not None:
        f = fold_fleet(fleet)
        lines.append("")
        lines.append(
            "fleet: "
            f"GOODPUT%={_fmt(f.get('goodput'), '{:.0%}')}"
            f"  PFX%={_fmt(f.get('pfx'), '{:.0%}')}"
            f"  SPEC%={_fmt(f.get('spec'), '{:.0%}')}"
            f"  KV%={_fmt(f.get('kv'), '{:.0%}')}"
        )
    hist = report.get("history")
    if hist:
        lines.append("")
        lines.append(f"{'HISTORY':<16}{'PEAK_BURN':>10}{'FINAL':>8}")
        for key, s in sorted(hist.get("classes", {}).items()):
            lines.append(
                f"{key:<16}"
                f"{_fmt(s.get('peak_fast_burn'), '{:.1f}x'):>10}"
                f"{_fmt(s.get('final_fast_burn'), '{:.1f}x'):>8}"
            )
        for step in hist.get("recommendation", []):
            desired = " ".join(
                f"{role}={n}" for role, n in sorted(step["desired"].items())
            )
            lines.append(f"recommendation @{step['t']:.2f}s: {desired}")
    canary = report.get("canary")
    if canary:
        lines.append("")
        lines.append(
            f"{'CANARY':<14}{'VERDICT':>10}{'BURN':>8}{'SAMPLES':>9}"
            f"{'SPAN':>8}  REASON"
        )
        base = canary.get("baseline") or ""
        for rev, v in sorted(canary.get("revisions", {}).items()):
            tag = rev + ("*" if rev == base else "")
            lines.append(
                f"{tag:<14}{v.get('verdict', '-'):>10}"
                f"{_fmt(v.get('short_burn'), '{:.1f}x'):>8}"
                f"{v.get('samples', 0):>9.0f}"
                f"{_fmt(v.get('duration_s'), '{:.0f}s'):>8}"
                f"  {v.get('reason', '')}"
            )
        for step in canary.get("trace", []):
            verdicts = " ".join(
                f"{r}={v}" for r, v in sorted(step["verdicts"].items())
            )
            lines.append(f"canary @{step['t']:.2f}s: {verdicts}")
    act = report.get("actuations")
    if act:
        lines.append("")
        totals = " ".join(f"{k}={v:.0f}"
                          for k, v in sorted(act["actuations"].items()))
        flaps = " ".join(f"{p}={v:.0f}"
                         for p, v in sorted(act.get("flaps", {}).items()))
        lines.append(f"closed loop: {totals}"
                     + (f"  flaps: {flaps}" if flaps else "  flaps: none"))
        for step in act.get("trace", []):
            lines.append(
                f"actuation @{step['t']:.2f}s: {step['what']}"
                f" (count {step['count']:.0f})"
            )
    return "\n".join(lines)
