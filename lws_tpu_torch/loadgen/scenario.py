"""Scenario specs: the port's copy of lws_tpu/loadgen/scenario.py, whole. A
named, committable description of one traffic experiment — arrival
process + workload mix + per-class SLO targets — and the deterministic
compiler from (spec, seed) to a fully-materialized request schedule.

The schedule is byte-reproducible: `build_schedule(spec, seed)` draws from
one `random.Random(seed)` stream in a fixed order (prefix pool, all arrival
times, then per-request class/lengths/prefix/tokens), and
`schedule_digest()` hashes the result so a budget file (or a test) can pin
"same seed -> same traffic" across runs and Python versions. That property
is what turns a load test into a regression gate: when
benchmarks/scenario_bench.py fails, the traffic is above suspicion.

Built-in scenarios are CPU-sized (tiny model, second-scale horizons) so
they can gate `make check`; production runs load a JSON spec file with the
same schema (`lws-tpu loadgen --spec file.json`).
"""

from __future__ import annotations

import hashlib
import json
import random
from typing import Optional

from lws_tpu_torch.core.slo import SLOTargets
from lws_tpu_torch.loadgen.arrivals import make_process
from lws_tpu_torch.loadgen.workload import (
    ScheduledRequest,
    WorkloadClass,
    build_prefix_pool,
    build_prompt,
    pick_class,
)

# CPU-sized built-ins: the three `make check` gates (steady / burst /
# shared-prefix) plus the flash-crowd and diurnal-replay shapes the docs
# walk through. Loose targets — the gate is "the harness measures the
# right thing on a tiny box", not "a laptop hits production latency".
_CPU_TARGETS = {"ttft_s": 5.0, "itl_s": 1.0, "queue_wait_s": 5.0}

SCENARIOS: dict[str, dict] = {
    "steady_poisson": {
        "name": "steady_poisson",
        "horizon_s": 1.5,
        "max_len": 64,
        "vocab": 256,
        "arrivals": {"process": "poisson", "rate_rps": 12.0},
        "classes": [
            {"name": "chat", "weight": 0.75,
             "prompt_len": {"kind": "uniform", "lo": 4, "hi": 12},
             "output_len": 6, "targets": _CPU_TARGETS},
            {"name": "batch", "weight": 0.25,
             "prompt_len": {"kind": "uniform", "lo": 12, "hi": 24},
             "output_len": 10,
             "targets": {**_CPU_TARGETS, "ttft_s": 10.0, "queue_wait_s": 10.0}},
        ],
    },
    "burst": {
        "name": "burst",
        "horizon_s": 1.5,
        "max_len": 64,
        "vocab": 256,
        "arrivals": {"process": "burst", "base_rps": 4.0, "burst_rps": 28.0,
                     "period_s": 0.5, "duty": 0.3},
        "classes": [
            {"name": "chat", "weight": 1.0,
             "prompt_len": {"kind": "uniform", "lo": 4, "hi": 10},
             "output_len": 6, "targets": _CPU_TARGETS},
        ],
    },
    "shared_prefix": {
        "name": "shared_prefix",
        "horizon_s": 1.5,
        "max_len": 64,
        "vocab": 256,
        "prefix_pool": 2,
        "prefix_len": 16,
        "arrivals": {"process": "poisson", "rate_rps": 10.0},
        "classes": [
            # Prompts run past the 16-token pooled prefix so the paged
            # engine's block-aligned prefix cache (block_size 8 -> 2 warm
            # blocks) serves the head while the suffix stays unique.
            {"name": "assist", "weight": 1.0,
             "prompt_len": {"kind": "uniform", "lo": 20, "hi": 28},
             "output_len": 6, "shared_prefix_ratio": 0.75,
             "targets": _CPU_TARGETS},
        ],
    },
    "flash_crowd": {
        "name": "flash_crowd",
        "horizon_s": 1.5,
        "max_len": 64,
        "vocab": 256,
        "arrivals": {"process": "flash_crowd", "base_rps": 3.0,
                     "spike_rps": 36.0, "spike_at_s": 0.5, "spike_len_s": 0.3},
        "classes": [
            {"name": "chat", "weight": 0.8,
             "prompt_len": {"kind": "uniform", "lo": 4, "hi": 10},
             "output_len": 6, "targets": _CPU_TARGETS},
            {"name": "premium", "weight": 0.2,
             "prompt_len": {"kind": "uniform", "lo": 4, "hi": 8},
             "output_len": 4,
             "targets": {**_CPU_TARGETS, "ttft_s": 2.5, "queue_wait_s": 2.5}},
        ],
    },
    "rolling_update": {
        "name": "rolling_update",
        "horizon_s": 2.0,
        "max_len": 64,
        "vocab": 256,
        "arrivals": {"process": "poisson", "rate_rps": 12.0},
        # Mid-run template bump: against a live server (`--server`), the
        # driver flips the deployment's worker-template env at at_s, so the
        # run exercises a real revision rollout under steady load and the
        # report's canary block (fold_canary) grades old vs new revision.
        "revision_bump": {"at_s": 1.0,
                          "env": {"name": "LWS_TPU_CANARY_STAGE",
                                  "value": "canary"}},
        "classes": [
            {"name": "chat", "weight": 1.0,
             "prompt_len": {"kind": "uniform", "lo": 4, "hi": 12},
             "output_len": 6, "targets": _CPU_TARGETS},
        ],
    },
    "diurnal": {
        "name": "diurnal",
        "horizon_s": 2.0,
        "max_len": 64,
        "vocab": 256,
        # A compressed day: quiet night, morning ramp, evening peak.
        "arrivals": {"process": "trace", "points": [
            {"t_s": 0.0, "rate_rps": 2.0},
            {"t_s": 0.5, "rate_rps": 8.0},
            {"t_s": 1.0, "rate_rps": 16.0},
            {"t_s": 1.5, "rate_rps": 6.0},
        ]},
        "classes": [
            {"name": "chat", "weight": 0.7,
             "prompt_len": {"kind": "uniform", "lo": 4, "hi": 12},
             "output_len": 6, "targets": _CPU_TARGETS},
            {"name": "longctx", "weight": 0.3,
             "prompt_len": {"kind": "choice", "choices": [24, 32]},
             "output_len": 8,
             "targets": {**_CPU_TARGETS, "ttft_s": 10.0, "queue_wait_s": 10.0}},
        ],
    },
}


def load_scenario(name_or_path: str) -> dict:
    """A built-in scenario by name, or a JSON spec file by path (anything
    with a path separator or a .json suffix). The loaded spec is validated
    by construction: parse_classes / make_process raise on bad stanzas."""
    if name_or_path in SCENARIOS:
        return json.loads(json.dumps(SCENARIOS[name_or_path]))  # deep copy
    if "/" in name_or_path or name_or_path.endswith(".json"):
        with open(name_or_path) as f:
            spec = json.load(f)
        if not isinstance(spec, dict):
            raise ValueError(f"{name_or_path}: scenario spec must be a JSON object")
        return spec
    raise ValueError(
        f"unknown scenario {name_or_path!r} (built-ins: {', '.join(sorted(SCENARIOS))})"
    )


def parse_classes(spec: dict) -> list[WorkloadClass]:
    base = SLOTargets.from_env()
    raw = spec.get("classes") or [{"name": "default"}]
    classes = [WorkloadClass.from_spec(c, base) for c in raw]
    names = [c.name for c in classes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate class names in scenario: {names}")
    return classes


def class_targets(spec: dict) -> dict[str, SLOTargets]:
    """class name -> effective SLOTargets, for slo.set_class_targets()
    (the scenario-spec half of "targets come from env or the scenario")
    and for the runner's client-side verdicts."""
    return {
        c.name: (c.targets if c.targets is not None else SLOTargets.from_env())
        for c in parse_classes(spec)
    }


def install_class_targets(spec: dict, recorder=None) -> dict[str, SLOTargets]:
    """Install the scenario's per-class targets into THIS process's SLO
    recorder, so in-process engine targets grade their server-side
    attainment/goodput series against the same targets the client-side
    report uses. Scope is deliberately process-local: a LIVE disagg pair's
    workers grade against their own env (`LWS_TPU_SLO_CLASS_TARGETS` on
    the pod spec) — set it there to match the scenario, or the report's
    client-side grades and the fleet surface's will differ. Returns the
    mapping for the caller's own grading."""
    from lws_tpu_torch.core import slo

    mapping = class_targets(spec)
    (recorder if recorder is not None else slo.RECORDER).set_class_targets(mapping)
    return mapping


def revision_bump(spec: dict) -> Optional[dict]:
    """The optional `revision_bump` stanza, validated: None when absent,
    else `{"at_s": float, "lws": "ns/name" | "", "env": {"name", "value"}}`.
    The stanza never touches the schedule (build_schedule ignores it —
    committed digests stay stable); it drives the LIVE side of a run: the
    CLI flips the target deployment's worker-template env at `at_s`
    scenario-seconds, forcing a new template revision under load."""
    raw = spec.get("revision_bump")
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise ValueError("revision_bump must be a JSON object")
    env = raw.get("env") or {}
    if not isinstance(env, dict):
        raise ValueError("revision_bump.env must be a JSON object")
    return {
        "at_s": float(raw.get("at_s", 0.0)),
        "lws": str(raw.get("lws", "")),
        "env": {"name": str(env.get("name") or "LWS_TPU_CANARY_STAGE"),
                "value": str(env.get("value") or "canary")},
    }


def build_schedule(spec: dict, seed: int) -> list[ScheduledRequest]:
    """Compile (spec, seed) into the materialized request schedule. Draw
    order is FIXED (see module docstring) — reordering any draw is a
    breaking change to every committed digest."""
    rng = random.Random(seed)
    classes = parse_classes(spec)
    horizon = float(spec.get("horizon_s", 1.0))
    vocab = int(spec.get("vocab", 256))
    max_len = int(spec.get("max_len", 64))
    pool = build_prefix_pool(
        rng, int(spec.get("prefix_pool", 0)), int(spec.get("prefix_len", 0)),
        vocab,
    )
    arrivals = make_process(spec.get("arrivals", {"process": "poisson",
                                                  "rate_rps": 1.0}))
    times = arrivals.times(horizon, rng)
    schedule: list[ScheduledRequest] = []
    for i, t in enumerate(times):
        c = pick_class(classes, rng)
        plen = c.prompt_len.sample(rng)
        out_n = c.output_len.sample(rng)
        prefix = None
        shared = False
        if pool and c.shared_prefix_ratio > 0 and rng.random() < c.shared_prefix_ratio:
            prefix = pool[int(rng.random() * len(pool))]
            shared = True
        plen = min(plen, max_len - out_n)  # the engine contract, pre-enforced
        if plen < 1:
            raise ValueError(
                f"class {c.name!r}: output_len {out_n} leaves no room for a "
                f"prompt under max_len {max_len}"
            )
        schedule.append(ScheduledRequest(
            index=i, arrival_s=t, klass=c.name,
            prompt=build_prompt(rng, plen, vocab, prefix),
            max_new_tokens=out_n, shared_prefix=shared,
        ))
    return schedule


def schedule_digest(schedule: list[ScheduledRequest]) -> str:
    """sha256 over the schedule's canonical byte form: arrival times at
    full float repr, class, budget, and every prompt token. Two schedules
    with the same digest are the same traffic, bit for bit."""
    h = hashlib.sha256()
    for r in schedule:
        line = (
            f"{r.index}|{r.arrival_s!r}|{r.klass}|{r.max_new_tokens}"
            f"|{int(r.shared_prefix)}|{','.join(str(t) for t in r.prompt.tolist())}\n"
        )
        h.update(line.encode())
    return h.hexdigest()


def offered_load_rps(spec: dict, schedule: list[ScheduledRequest]) -> float:
    horizon = float(spec.get("horizon_s", 1.0)) or 1.0
    return len(schedule) / horizon


def scenario_names() -> list[str]:
    return sorted(SCENARIOS)


def describe_scenario(spec: dict,
                      schedule: Optional[list[ScheduledRequest]] = None) -> str:
    """One-line summary for CLI listings and reports."""
    classes = ",".join(c["name"] for c in spec.get("classes", [])) or "default"
    base = (f"{spec.get('name', '?')}: {spec.get('arrivals', {}).get('process', '?')}"
            f" over {spec.get('horizon_s', 1.0)}s, classes [{classes}]")
    if schedule is not None:
        base += f", {len(schedule)} requests"
    return base
