"""Scenario load generation and goodput measurement over the port's engines:
the port's copy of lws_tpu/loadgen (arrivals, workload, scenario, runner,
report). A named scenario and a seed give the schedule the JAX package
gives, with the same `schedule_digest`; the runner drives the port's
engines open-loop and grades goodput with the rule their server-side SLO
ledger uses, and the report renders it as the JAX package renders it.

    from lws_tpu_torch import loadgen
    spec = loadgen.load_scenario("shared_prefix")
    schedule = loadgen.build_schedule(spec, seed=0)      # byte-reproducible
    target = loadgen.build_local_target("paged", spec)  # on the card
    result = loadgen.run_schedule(schedule, target)
    report = loadgen.summarize(result, loadgen.class_targets(spec),
                               spec["horizon_s"], spec["name"], 0)
    print(loadgen.render_report(report))

`DisaggTarget(prefill_endpoint, decode_endpoint)` drives a live
disaggregated pair the same way. CLI: `python -m lws_tpu_torch loadgen
SCENARIO` (lws_tpu_torch/cli.py). Left out: the closed-loop sweep
(lws_tpu/loadgen/closedloop.py), which replays a synthetic capacity plant
against the control plane's store and drives no engine.
"""

from lws_tpu_torch.loadgen.arrivals import (
    BurstProcess,
    FlashCrowdProcess,
    GammaProcess,
    PoissonProcess,
    TraceReplayProcess,
    arrival_times,
    make_process,
    piecewise_poisson,
)
from lws_tpu_torch.loadgen.report import (
    fold_actuations,
    fold_canary,
    fold_fleet,
    fold_history,
    render_report,
)
from lws_tpu_torch.loadgen.runner import (
    DisaggTarget,
    EngineTarget,
    RequestOutcome,
    RunResult,
    attained,
    build_local_target,
    goodput_tokens,
    run_schedule,
    summarize,
    worst_requests,
)
from lws_tpu_torch.loadgen.scenario import (
    SCENARIOS,
    build_schedule,
    class_targets,
    describe_scenario,
    install_class_targets,
    load_scenario,
    offered_load_rps,
    revision_bump,
    scenario_names,
    schedule_digest,
)
from lws_tpu_torch.loadgen.workload import (
    LengthDist,
    ScheduledRequest,
    WorkloadClass,
    build_prompt,
    pick_class,
)

__all__ = [
    "SCENARIOS",
    "BurstProcess",
    "DisaggTarget",
    "EngineTarget",
    "FlashCrowdProcess",
    "GammaProcess",
    "LengthDist",
    "PoissonProcess",
    "RequestOutcome",
    "RunResult",
    "ScheduledRequest",
    "TraceReplayProcess",
    "WorkloadClass",
    "arrival_times",
    "attained",
    "build_local_target",
    "build_prompt",
    "build_schedule",
    "class_targets",
    "describe_scenario",
    "fold_actuations",
    "fold_canary",
    "fold_fleet",
    "fold_history",
    "goodput_tokens",
    "install_class_targets",
    "load_scenario",
    "make_process",
    "offered_load_rps",
    "pick_class",
    "piecewise_poisson",
    "render_report",
    "revision_bump",
    "run_schedule",
    "scenario_names",
    "schedule_digest",
    "summarize",
    "worst_requests",
]
