"""One run of one cell: build the program, warm it, ramp the closed loop,
measure the window, read the trace, judge the outputs, and return the
result line.

Set-up (`setup_s`, from the start of the process to the opening of the
window): load the kernels and make the int8 weights on the card from the
seed, build the engine, warm every prefill bucket the mix can reach, then
ramp: the clients join in waves, with decode steps between the waves, so
that the requests in flight when the window opens are of many ages, as in
a steady loop. The host process runs on two cores (run.py) and the
collector's generations are frozen at the end of set-up.

With `trace`, a torch.profiler slice of PROFILE_SECONDS at the end of the
window feeds the device readings; the host-clock readings are taken before
the slice, since the profiler's start and stop hold the loop up for
seconds. The process profiles once: a second profiler run in one
process has read the device's clock at half its rate.
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from port_bench import judge, program, profiling, reckon, spec, stats
from port_bench.loop import ClosedLoop
from port_bench.traffic import Traffic

PROFILE_SECONDS = 3.0
STEP_N = 32              # decode steps asked of each step_n call (the engine clamps it)
RAMP_WAVES = 8           # the clients join in this many waves ...
RAMP_STEPS_BETWEEN = 8   # ... with this many decode steps between two waves


@dataclass
class Record:
    """What the readers of per-layer metrics read: the window's records
    (each flagged `sliced` when the profiler was on) and the slice."""

    shape: dict
    slots: int
    block_size: int
    max_len: int
    capacity_factor: float
    t0: float
    t1: float
    admissions: list
    dispatches: list
    completions: list
    cut: Optional[tuple] = None      # host interval the profiler covered
    slice: Optional[profiling.Slice] = None
    sliced_admissions: list = field(default_factory=list)
    sliced_dispatches: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def host_seconds(self) -> float:
        """The window's seconds outside the profiled slice."""
        return self.seconds - (self.cut[1] - self.cut[0] if self.cut else 0.0)


def e2e(rec: Record) -> dict:
    """The end-to-end metrics of the window (with tracing off)."""
    tokens = len(rec.admissions) + sum(d.n * d.active for d in rec.dispatches)
    ttft = [(a.t1 - a.sent) * 1e3 for a in rec.admissions]
    tpot = [(c.t - c.first) / (c.max_new - 1) * 1e3 for c in rec.completions if c.max_new > 1]
    return {"output_tok_s": tokens / rec.seconds, "ttft_p90_ms": stats.percentile(ttft, 0.9),
            "tpot_p90_ms": stats.percentile(tpot, 0.9)}


def ramp(loop: ClosedLoop) -> None:
    C = loop.traffic.clients
    waves = min(RAMP_WAVES, C)
    per = -(-C // waves)
    for w in range(waves):
        for c in range(w * per, min(C, (w + 1) * per)):
            loop.send(c)
        target = loop.decode_steps + RAMP_STEPS_BETWEEN
        loop.iterate()
        while w < waves - 1 and loop.decode_steps < target:
            loop.iterate()


def warm(served, traffic: Traffic, block_size: int, max_len: int) -> int:
    """Admit one prompt per prefill bucket the mix reaches and decode it
    out. Returns the count."""
    prompts = traffic.warm_prompts(lambda lens: reckon.warm_lengths(lens, block_size, max_len))
    for prompt, max_new in prompts:
        rid = served.submit(prompt, max_new)
        if rid is None:
            raise RuntimeError("warm-up admission refused")
        while served.result(rid) is None:
            served.step_n(STEP_N)
    return len(prompts)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, control: bool = False,
             clock: Callable[[], float] = time.perf_counter) -> dict:
    """One run; returns {"line": the result line's dict, "numbers": the
    judge's numbers, "stderr": lines}."""
    shape = spec.model_shape(cell.config)
    port = cell.config["port"]
    eng = dict(cell.config["engine"]) | dict(cell.traffic.get("engine", {}))
    cfg = program.llama_config(shape, port, eng["max_len"])
    marks = {"start": t_start}
    model = program.build_model(cfg, shape, seed, device)
    served = program.Served(cfg, model, eng, device)
    sync(device)
    marks["weights_engine"] = clock()
    traffic = Traffic(cell.traffic, shape["vocab_size"], eng["slots"], seed)
    n_warm = warm(served, traffic, eng["block_size"], eng["max_len"])
    sync(device)
    marks["warm"] = clock()
    loop = ClosedLoop(served, traffic, STEP_N, shape["vocab_size"], clock)
    ramp(loop)
    sync(device)
    marks["ramp"] = clock()
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's generations: steadier pauses

    prof = profiling.Profiler(torch, device) if trace else None
    slice_at = max(0.0, seconds - PROFILE_SECONDS)
    cut_a = cut_b = slice_t0 = None
    refused0 = loop.refused
    n_adm, n_disp, n_comp = len(loop.admissions), len(loop.dispatches), len(loop.completions)
    loop.window = True
    t0 = clock()
    while True:
        now = clock()
        if prof is not None and cut_a is None and now - t0 >= slice_at:
            cut_a = now
            prof.start()
            loop.sliced = True
            slice_t0 = clock()  # the profiler's start-up is not part of the slice
        loop.iterate()
        now = clock()
        if prof is not None and prof.on and now - slice_t0 >= PROFILE_SECONDS:
            prof.stop()
            loop.sliced = False
            cut_b = clock()
        if now - t0 >= seconds and (prof is None or cut_b is not None):
            break
    if prof is not None and prof.on:
        prof.stop()
        loop.sliced = False
        cut_b = clock()
    t1 = clock()
    loop.window = False
    refused = loop.refused - refused0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = Record(shape, eng["slots"], eng["block_size"], eng["max_len"],
                 float(port.get("capacity_factor", 0.0)), t0, t1,
                 loop.admissions[n_adm:], loop.dispatches[n_disp:], loop.completions[n_comp:],
                 (cut_a, cut_b) if cut_a is not None else None)
    rec.sliced_admissions = [a for a in rec.admissions if a.sliced]
    rec.sliced_dispatches = [d for d in rec.dispatches if d.sliced]
    out = {"stderr": []}
    note = out["stderr"].append
    note(f"set-up: weights and engine {marks['weights_engine'] - t_start:.3f} s (nvcc "
         f"{program.compile_seconds():.3f} s), warm-up of {n_warm} prefills "
         f"{marks['warm'] - marks['weights_engine']:.3f} s, ramp of {traffic.clients} clients "
         f"{marks['ramp'] - marks['warm']:.3f} s")
    note(f"window {rec.seconds:.3f} s: {len(rec.admissions)} admissions, "
         f"{len(rec.completions)} completions, {sum(d.n for d in rec.dispatches)} decode steps "
         f"in {len(rec.dispatches)} step_n calls, mean batch "
         f"{statistics.fmean([d.active for d in rec.dispatches]) if rec.dispatches else 0:.1f}, "
         f"{refused} refused")

    metrics = {}
    if trace:
        rec.slice = prof.slice(loop.phases)
        ops = rec.slice.ops
        note(f"profiled slice: {rec.slice.seconds:.6f} s ({cut_b - cut_a:.6f} s with the "
             f"profiler's start and stop); {len(ops)} device operations over "
             f"{rec.slice.span_seconds:.6f} s of the trace's clock"
             f"{'' if rec.slice.clock_ok else ' (the clocks disagree: no device metric is read)'}; "
             f"{len(rec.sliced_admissions)} admissions and "
             f"{sum(d.n for d in rec.sliced_dispatches)} decode steps in it")
        for m in cell.per_layer:
            reader = spec.load_metric(m["name"])
            value = reader.read(rec)
            if value is None:
                found = (f": {len(rec.slice.kernels(reader.PATTERN))} launches in the trace, "
                         f"{len(reader.ideal(rec))} reckoned" if hasattr(reader, "ideal") else "")
                note(f"per-layer {m['name']}: nothing to read{found}")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        vals = e2e(rec) | {"setup_s": t0 - t_start}
        for m in cell.end_to_end:
            if vals.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}

    # The comparison, after the window: the program's state is freed first.
    bad = sum(1 for c in rec.completions if not c.ok)
    sample = judge.pick_sample(loop.done, seed)
    vocab = shape["vocab_size"]
    del loop, served, model
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    numbers = judge.compare(shape, seed, sample, device, bool(port.get("kv_quant")), control) \
        if sample else {}
    numbers["bad_completions"] = bad
    note(f"reference over {len(sample)} requests ({numbers.get('positions', 0)} served tokens, "
         f"vocab {vocab}): {clock() - t_ref:.3f} s")
    correct, compared = judge.verdict(numbers, cell.limits)
    correct = correct and bool(sample)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(rec.admissions) + refused,
            "failed": refused + bad, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.slice.busy_seconds()
        dev["window_s"] = rec.slice.seconds
        line["breakdown"] = profiling.breakdown(rec.slice)
    line["compared"] = compared
    for name, c in compared.items():
        note(f"compared {name} {c['value']} limit {c['limit']}")
    out["line"], out["numbers"] = line, numbers
    return out
