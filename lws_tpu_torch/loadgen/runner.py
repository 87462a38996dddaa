"""The open-loop driver: the port's copy of lws_tpu/loadgen/runner.py over
the port's engines (`EngineTarget`, `build_local_target`, `run_schedule`,
`summarize`, `worst_requests`). Left out: `DisaggTarget`, which waits for
the disaggregated handoff's telemetry (the port's `submit_prompt` carries
no workload class yet). Play a materialized schedule against a target and
record what the CLIENT observed.

Open-loop means arrivals come from the schedule's timer and NEVER wait on
completions: a target that falls behind accumulates a waiting queue, queue
wait climbs, and queueing collapse is measurable instead of being absorbed
by a closed loop. The driver admits in arrival order (head-of-line on
backpressure — an admission refusal delays everything behind it, exactly
like a full engine would), steps in-process engines between admissions, and
polls completions.

Two ledgers exist on purpose: the ENGINES record server-side timelines
(core/slo.py — those feed /metrics and the fleet surface; the runner
backdates their arrival clocks via submit(arrival_t=...) so open-loop queue
delay lands in the server-side queue-wait histograms too), while the runner
records CLIENT-side outcomes for the report. Both grade goodput with the
same `token_deadline_s` rule, so the two views agree on what "on time"
means.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from lws_tpu_torch._device import DeviceLike
from lws_tpu_torch.core.slo import SLOTargets, token_deadline_s
from lws_tpu_torch.loadgen.workload import ScheduledRequest


@dataclass
class RequestOutcome:
    """What the client saw for one scheduled request. Times are seconds in
    SCENARIO time (wall gaps divided by time_scale) so reports line up with
    the spec's targets regardless of replay speed."""

    index: int
    klass: str
    arrival_s: float
    request_id: str = ""    # a synthetic per-run id for in-process
    #                         engine targets, from the schedule index
    queue_s: float = 0.0    # scheduled arrival -> admission accepted
    ttft_s: float = 0.0     # scheduled arrival -> first token
    itl_s: float = 0.0      # mean inter-token gap after the first token
    total_s: float = 0.0    # scheduled arrival -> completion
    n_tokens: int = 0
    completed: bool = False
    failed: bool = False    # target delivered a failure verdict
    shared_prefix: bool = False


@dataclass
class RunResult:
    outcomes: list[RequestOutcome]
    wall_s: float            # real seconds the run took
    time_scale: float = 1.0

    @property
    def wall_scenario_s(self) -> float:
        return self.wall_s / self.time_scale if self.time_scale > 0 else self.wall_s


def goodput_tokens(targets: SLOTargets, ttft_s: float, n_tokens: int,
                   total_s: float) -> int:
    """Client-side goodput grading: tokens assumed delivered uniformly
    between first token and completion; token i counts when it landed by
    `token_deadline_s(targets, i)`. The in-engine ledger grades at chunk
    granularity with real chunk stamps — same rule, finer clock."""
    if n_tokens <= 0:
        return 0
    good = 1 if ttft_s <= targets.ttft_s else 0
    if n_tokens == 1:
        return good
    step = max(0.0, total_s - ttft_s) / (n_tokens - 1)
    for i in range(2, n_tokens + 1):
        t_i = ttft_s + (i - 1) * step
        if t_i <= token_deadline_s(targets, i):
            good += 1
    return good


def attained(outcome: RequestOutcome, targets: SLOTargets) -> bool:
    """Client-side SLO verdict, mirroring RequestTimeline.attained: every
    observed phase within target, and the request actually finished."""
    if not outcome.completed or outcome.failed:
        return False
    if outcome.queue_s > targets.queue_wait_s:
        return False
    if outcome.ttft_s > targets.ttft_s:
        return False
    if outcome.n_tokens > 1 and outcome.itl_s > targets.itl_s:
        return False
    return True


# ---------------------------------------------------------------------------
# Targets


class EngineTarget:
    """Drive an in-process serving engine (dense / batch / paged). The
    batch and paged engines are slot machines: submit admits (prefill) and
    step() advances every active slot; the dense engine serves one blocking
    generate() at a time — its queueing shows up as pure open-loop delay."""

    def __init__(self, engine, kind: str) -> None:
        if kind not in ("dense", "batch", "paged"):
            raise ValueError(f"unknown engine target kind {kind!r}")
        self.engine = engine
        self.kind = kind
        self._dense_results: dict[int, dict] = {}
        self._next_handle = 0

    def submit(self, req: ScheduledRequest,
               arrival_wall_t: float) -> Optional[int]:
        if self.kind == "dense":
            submit_t = time.perf_counter()
            res = self.engine.generate(
                np.asarray(req.prompt)[None, :], req.max_new_tokens,
                klass=req.klass,
            )
            h = self._next_handle
            self._next_handle += 1
            # submit() BLOCKS through generate() here, so the drive loop's
            # own admission stamps would fold the whole generation into
            # queue wait and TTFT — report the real splits instead: queue
            # is arrival -> generate start, first token lands res.ttft_s
            # after that. Both are WALL seconds (the runner scales them).
            self._dense_results[h] = {
                "n_tokens": int(np.asarray(res.tokens).shape[1]),
                "queue_wall_s": max(0.0, submit_t - arrival_wall_t),
                "ttft_wall_s": max(0.0, submit_t - arrival_wall_t) + res.ttft_s,
            }
            return h
        return self.engine.submit(
            req.prompt, req.max_new_tokens, klass=req.klass,
            arrival_t=arrival_wall_t,
        )

    def step(self) -> None:
        if self.kind != "dense" and self.engine.active_count:
            self.engine.step()

    def poll(self, handle: int) -> Optional[dict]:
        if self.kind == "dense":
            return self._dense_results.pop(handle, None)
        toks = self.engine.result(handle)
        if toks is None:
            return None
        return {"n_tokens": len(toks)}


def build_local_target(kind: str, spec: dict, device: DeviceLike = None) -> EngineTarget:
    """An in-process target sized from the scenario spec, random weights
    from seed 0, on the card unless `device="cpu"`. On the CPU it is the
    JAX package's small Llama twin (the test-suite shape, f32). The card's
    kernels take only bf16 with head dim 128 and paged blocks of 16, so
    there it is the smallest model they take: the same depth and a 2:1
    GQA at d_model 256, bf16, and the paged engine's blocks default to 16.
    Paged gets the prefix cache whenever the scenario pools shared
    prefixes — that IS what the shared-prefix mix exercises."""
    import torch

    from lws_tpu_torch._device import resolve_device
    from lws_tpu_torch.models.llama import LlamaConfig, init_params

    dev = resolve_device(device)
    vocab = int(spec.get("vocab", 256))
    max_len = int(spec.get("max_len", 64))
    eng_spec = dict(spec.get("engine") or {})
    on_card = dev.type == "cuda"
    width = (dict(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16) if on_card else
             dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, dtype=torch.float32,
                  param_dtype=torch.float32))
    cfg = LlamaConfig(vocab_size=vocab, n_layers=2, max_seq_len=max(128, max_len), **width)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if kind == "dense":
        from lws_tpu_torch.serving.engine import Engine

        return EngineTarget(
            Engine(cfg, params, batch_size=1, max_len=max_len, device=dev), "dense"
        )
    if kind == "batch":
        from lws_tpu_torch.serving.batch_engine import BatchEngine

        return EngineTarget(
            BatchEngine(cfg, params, slots=int(eng_spec.get("slots", 4)),
                        max_len=max_len, device=dev),
            "batch",
        )
    if kind == "paged":
        from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

        return EngineTarget(
            PagedBatchEngine(
                cfg, params, slots=int(eng_spec.get("slots", 4)),
                max_len=max_len,
                block_size=int(eng_spec.get("block_size", 16 if on_card else 8)),
                num_blocks=eng_spec.get("num_blocks"),
                prefix_cache=bool(eng_spec.get(
                    "prefix_cache", int(spec.get("prefix_pool", 0)) > 0
                )),
                device=dev,
            ),
            "paged",
        )
    raise ValueError(f"unknown local target kind {kind!r}")


# ---------------------------------------------------------------------------
# The drive loop


def run_schedule(
    schedule: list[ScheduledRequest],
    target,
    time_scale: float = 1.0,
    max_wall_s: float = 120.0,
    clock=time.perf_counter,
    sleep=time.sleep,
    on_tick=None,
) -> RunResult:
    """Play `schedule` against `target` open-loop. `time_scale` maps
    scenario seconds onto wall seconds (2.0 = half speed); `max_wall_s`
    bounds the drain — requests still unfinished at the bound are recorded
    as incomplete (goodput zero), which is exactly what an overload
    scenario is supposed to show. `on_tick(now)` runs once per drive-loop
    iteration (the seam a history sampler rides)."""
    pending = deque(sorted(schedule, key=lambda r: (r.arrival_s, r.index)))
    waiting: deque[ScheduledRequest] = deque()
    active: dict = {}  # handle -> RequestOutcome (partially filled)
    first_seen: dict = {}  # handle -> first-token wall stamp fallback
    outcomes: list[RequestOutcome] = []
    start = clock()

    def scen(wall_gap: float) -> float:
        return wall_gap / time_scale if time_scale > 0 else wall_gap

    while pending or waiting or active:
        now = clock()
        if on_tick is not None:
            on_tick(now)
        if now - start > max_wall_s:
            break
        rel = scen(now - start)
        while pending and pending[0].arrival_s <= rel:
            waiting.append(pending.popleft())
        # Admit in arrival order; a refusal head-of-line blocks (that IS
        # the backpressure signal — later arrivals queue behind it).
        while waiting:
            req = waiting[0]
            arrival_wall = start + req.arrival_s * time_scale
            handle = target.submit(req, arrival_wall)
            if handle is None:
                break
            waiting.popleft()
            t_admit = clock()
            out = RequestOutcome(
                index=req.index, klass=req.klass, arrival_s=req.arrival_s,
                # A string handle IS the wire request id; in-process
                # engines get a synthetic per-run id so the report's
                # worst-K rows are still addressable.
                request_id=(handle if isinstance(handle, str)
                            else f"#{req.index}"),
                queue_s=scen(max(0.0, t_admit - arrival_wall)),
                shared_prefix=req.shared_prefix,
            )
            # Slot engines produce the first token during submit (prefill);
            # targets that know better (dense/disagg) override via
            # ttft_offset_s at poll time.
            first_seen[handle] = (arrival_wall, t_admit)
            active[handle] = out
        target.step()
        for handle in list(active):
            res = target.poll(handle)
            if res is None:
                continue
            out = active.pop(handle)
            arrival_wall, t_first = first_seen.pop(handle)
            t_done = clock()
            out.completed = True
            out.failed = bool(res.get("failed"))
            out.n_tokens = int(res.get("n_tokens", 0))
            out.total_s = scen(max(0.0, t_done - arrival_wall))
            # Every override a target reports is WALL seconds; scen()
            # converts them like the loop's own stamps, so the outcome's
            # scenario-time contract holds at any --time-scale.
            if res.get("queue_wall_s") is not None:
                out.queue_s = scen(max(0.0, float(res["queue_wall_s"])))
            if res.get("ttft_wall_s") is not None:
                # Full arrival -> first-token span (dense: submit blocked
                # through generate, so the loop's stamps would misattribute).
                out.ttft_s = scen(max(0.0, float(res["ttft_wall_s"])))
            elif res.get("ttft_after_admit_wall_s") is not None:
                out.ttft_s = out.queue_s + scen(
                    max(0.0, float(res["ttft_after_admit_wall_s"])))
            else:
                out.ttft_s = scen(max(0.0, t_first - arrival_wall))
            if out.n_tokens > 1:
                out.itl_s = max(0.0, out.total_s - out.ttft_s) / (out.n_tokens - 1)
            outcomes.append(out)
        if not active and not waiting and pending:
            next_wall = start + pending[0].arrival_s * time_scale
            sleep(max(0.0, min(0.002, next_wall - clock())))
    # Whatever never finished (or never got admitted) is recorded as
    # incomplete — overload must show up in the report, not vanish.
    for handle, out in active.items():
        outcomes.append(out)
    for req in list(waiting) + list(pending):
        outcomes.append(RequestOutcome(
            index=req.index, klass=req.klass, arrival_s=req.arrival_s,
            shared_prefix=req.shared_prefix,
        ))
    outcomes.sort(key=lambda o: o.index)
    return RunResult(outcomes=outcomes, wall_s=clock() - start,
                     time_scale=time_scale)


# ---------------------------------------------------------------------------
# Summary (pure)


def _percentile(sorted_vals: list[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    rank = q * (len(sorted_vals) - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(sorted_vals):
        return sorted_vals[-1]
    return sorted_vals[lo] * (1 - frac) + sorted_vals[lo + 1] * frac


def _bucket_stats(outs: list[RequestOutcome], targets: SLOTargets) -> dict:
    done = [o for o in outs if o.completed and not o.failed]
    ttfts = sorted(o.ttft_s for o in done)
    itls = sorted(o.itl_s for o in done if o.n_tokens > 1)
    queues = sorted(o.queue_s for o in done)
    tokens = sum(o.n_tokens for o in done)
    good = sum(
        goodput_tokens(targets, o.ttft_s, o.n_tokens, o.total_s) for o in done
    )
    return {
        "count": len(outs),
        "completed": len(done),
        "attainment": (
            sum(attained(o, targets) for o in outs) / len(outs) if outs else None
        ),
        "tokens": tokens,
        "good_tokens": good,
        "goodput_fraction": (good / tokens) if tokens else None,
        "ttft_p50": _percentile(ttfts, 0.50),
        "ttft_p95": _percentile(ttfts, 0.95),
        "ttft_p99": _percentile(ttfts, 0.99),
        "itl_p50": _percentile(itls, 0.50),
        "itl_p95": _percentile(itls, 0.95),
        "itl_p99": _percentile(itls, 0.99),
        "queue_p95": _percentile(queues, 0.95),
    }


def worst_requests(outs: list[RequestOutcome], targets: SLOTargets,
                   k: int = 3) -> list[dict]:
    """The class's worst-K offenders, each with its request id.
    Incompletes rank worst (they never finished), then misses, then the
    slowest hits."""
    def key(o: RequestOutcome):
        incomplete = not o.completed or o.failed
        miss = not attained(o, targets)
        return (incomplete, miss, o.ttft_s if o.completed else float("inf"),
                o.total_s)

    ranked = sorted(outs, key=key, reverse=True)
    return [
        {
            "id": o.request_id or "-",
            "ttft_s": round(o.ttft_s, 6) if o.completed else None,
            "total_s": round(o.total_s, 6) if o.completed else None,
            "completed": o.completed and not o.failed,
            "attained": attained(o, targets),
        }
        for o in ranked[:max(0, k)]
    ]


def summarize(result: RunResult, targets_by_class: dict[str, SLOTargets],
              horizon_s: float, scenario_name: str = "",
              seed: Optional[int] = None, worst_k: int = 3) -> dict:
    """RunResult -> the report dict (the JAX package's `render_report` and
    scenario bench read this shape): per-class and overall latency quantiles, attainment, the
    goodput ledger, offered vs achieved load, and the worst-K offenders
    per class (request ids)."""
    default = SLOTargets.from_env()
    by_class: dict[str, list[RequestOutcome]] = {}
    for o in result.outcomes:
        by_class.setdefault(o.klass, []).append(o)
    classes = {
        name: {
            **_bucket_stats(outs, targets_by_class.get(name, default)),
            "worst": worst_requests(
                outs, targets_by_class.get(name, default), k=worst_k
            ),
        }
        for name, outs in sorted(by_class.items())
    }
    # Overall attainment/goodput grade each request against ITS class.
    total = {
        "count": len(result.outcomes),
        "completed": sum(o.completed and not o.failed for o in result.outcomes),
        "tokens": sum(s["tokens"] for s in classes.values()),
        "good_tokens": sum(s["good_tokens"] for s in classes.values()),
    }
    graded = [
        attained(o, targets_by_class.get(o.klass, default))
        for o in result.outcomes
    ]
    total["attainment"] = sum(graded) / len(graded) if graded else None
    total["goodput_fraction"] = (
        total["good_tokens"] / total["tokens"] if total["tokens"] else None
    )
    ttfts = sorted(o.ttft_s for o in result.outcomes if o.completed and not o.failed)
    itls = sorted(
        o.itl_s for o in result.outcomes
        if o.completed and not o.failed and o.n_tokens > 1
    )
    total["ttft_p50"] = _percentile(ttfts, 0.50)
    total["ttft_p95"] = _percentile(ttfts, 0.95)
    total["ttft_p99"] = _percentile(ttfts, 0.99)
    total["itl_p50"] = _percentile(itls, 0.50)
    total["itl_p95"] = _percentile(itls, 0.95)
    total["itl_p99"] = _percentile(itls, 0.99)
    wall_scen = result.wall_scenario_s or 1.0
    return {
        "scenario": scenario_name,
        "seed": seed,
        "horizon_s": horizon_s,
        "wall_s": result.wall_s,
        "offered_rps": len(result.outcomes) / horizon_s if horizon_s else None,
        "achieved_rps": total["completed"] / wall_scen,
        "classes": classes,
        "all": total,
    }
