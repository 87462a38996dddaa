"""Scenario load generation and goodput measurement over the port's engines:
the port's copy of lws_tpu/loadgen (arrivals, workload, scenario, runner).
A named scenario and a seed give the schedule the JAX package gives, with
the same `schedule_digest`; the runner drives the port's engines open-loop
and grades goodput with the rule their server-side SLO ledger uses.

    from lws_tpu_torch import loadgen
    spec = loadgen.load_scenario("shared_prefix")
    schedule = loadgen.build_schedule(spec, seed=0)      # byte-reproducible
    target = loadgen.build_local_target("paged", spec)  # on the card
    result = loadgen.run_schedule(schedule, target)
    report = loadgen.summarize(result, loadgen.class_targets(spec),
                               spec["horizon_s"], spec["name"], 0)

Left out: the report renderer, the closed-loop sweep and the `lws-tpu
loadgen` CLI (lws_tpu/loadgen/report.py, closedloop.py), and `DisaggTarget`.
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
from lws_tpu_torch.loadgen.runner import (
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
    "goodput_tokens",
    "install_class_targets",
    "load_scenario",
    "make_process",
    "offered_load_rps",
    "pick_class",
    "piecewise_poisson",
    "run_schedule",
    "scenario_names",
    "schedule_digest",
    "summarize",
    "worst_requests",
]
