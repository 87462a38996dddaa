"""A torch.profiler slice of the window, reduced to what the per-layer
readers and the result line need: device operations with their times,
the device's busy seconds (the union of their intervals), and the idle
gaps named by what the host was doing.

The profiler records CUDA activity only (kernels, copies, the runtime's
calls): recording every host operator as well slows the host by about
half inside the slice, and the device's idle share with it. The harness's
phases (admit, step_n, poll) are stamped on the wall clock, the clock of
the trace. Device operations are the trace's CUDA events less the GPU
user annotations, which repeat the time of the kernels they bracket
(chip_smoke.py `device_kernels`, whose rule this copies: ProcessGroupNCCL
brackets each collective with one). The slice opens and closes on a
synchronised device, so every device operation in the trace ran inside
it. The raw kineto events are read directly; the profiler's event tree is
never built.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from dataclasses import dataclass, field

BREAKDOWN_ENTRIES = 10
# The slice's wall-clock length over the span of its device operations:
# at most 1 (they all run inside it) up to a little rounding, and more only
# by the host's time before the first launch and after the last, a few
# milliseconds in a loop that launches every iteration. A trace whose clock
# reads the device at half its rate (seen once, with two profiler sessions
# in one process) gives 2.
CLOCK_RATIO = (0.97, 1.25)


@dataclass
class Slice:
    start_ns: int = 0
    end_ns: int = 0
    span_seconds: float = 0.0  # first device operation's start to the last's end, as traced
    clock_ok: bool = True      # the trace's clock agrees with the slice's wall clock
    ops: list = field(default_factory=list)     # (name, start_ns, end_ns) of device operations
    host: list = field(default_factory=list)    # (name, start_ns, end_ns) of runtime calls
    phases: list = field(default_factory=list)  # (name, start_ns, end_ns) of the harness's phases

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self, pattern: str) -> list:
        """The device operations whose names match `pattern`; none when the
        trace's clock disagrees with the slice's, so that no reading rests
        on it."""
        if not self.clock_ok:
            return []
        rx = re.compile(pattern)
        return [op for op in self.ops if rx.search(op[0])]

    def busy_seconds(self) -> float:
        """The union of the device operations' intervals: all of them ran
        inside the slice."""
        if not self.ops:
            return 0.0
        lo, hi = min(o[1] for o in self.ops), max(o[2] for o in self.ops)
        return union_seconds([(a, b) for _, a, b in self.ops], lo, hi)


def union_seconds(intervals, lo: int, hi: int) -> float:
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e9


def _device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def reduce(prof, start_ns: int, end_ns: int, phases: list) -> Slice:
    """The Slice of a stopped torch.profiler.profile that ran from
    start_ns to end_ns (wall clock), with the harness's phases.

    The slice opens and closes on a synchronised device, so its device
    operations span it to within milliseconds. Where the trace's clock
    says otherwise (outside CLOCK_RATIO), the times are kept as traced and
    `clock_ok` is false: the readers then find no kernels and the device's
    idle share is not read."""
    out = Slice(start_ns, end_ns, phases=list(phases))
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        item = (ev.name(), start, start + ev.duration_ns())
        if not _device(ev):
            out.host.append(item)
        elif not ev.is_user_annotation():
            out.ops.append(item)
    if out.ops:
        lo, hi = min(o[1] for o in out.ops), max(o[2] for o in out.ops)
        out.span_seconds = (hi - lo) / 1e9
        ratio = (end_ns - start_ns) / max(hi - lo, 1)
        out.clock_ok = CLOCK_RATIO[0] <= ratio <= CLOCK_RATIO[1]
    return out


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, at most `width` long."""
    s = name.split("(")[0] if "(" in name and not name.startswith("(") else name
    return s[:width]


def _covering(ranges: list, starts: list, t: int, back: int) -> str:
    """The shortest of the `back` ranges starting last before t that cover
    t ("-" when none does); `ranges` sorted by start, `starts` theirs."""
    i = bisect.bisect_right(starts, t)
    best = None
    for name, a, b in ranges[max(0, i - back):i]:
        if b >= t and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "-"


def breakdown(sl: Slice) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing in them (the innermost host range over the
    gap's middle), each at most BREAKDOWN_ENTRIES entries, in seconds."""
    by_op = collections.Counter()
    for name, a, b in sl.ops:
        by_op[short(name)] += (b - a) / 1e9
    gaps, end = [], sl.start_ns
    for _, a, b in sorted((o for o in sl.ops), key=lambda o: o[1]):
        if a > end:
            gaps.append((end, min(a, sl.end_ns)))
        end = max(end, b)
    if end < sl.end_ns:
        gaps.append((end, sl.end_ns))
    phases = sorted(sl.phases, key=lambda h: h[1])
    ops = sorted(sl.host, key=lambda h: h[1])
    p_starts, o_starts = [h[1] for h in phases], [h[1] for h in ops]
    by_host = collections.Counter()
    for a, b in (gaps if sl.clock_ok else []):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = _covering(phases, p_starts, mid, 2) + " > " \
            + _covering(ops, o_starts, mid, 64)
        by_host[name] += (b - a) / 1e9
    return {"device_ops": [[n, s] for n, s in by_op.most_common(BREAKDOWN_ENTRIES)],
            "idle_gaps": [[n, s] for n, s in by_host.most_common(BREAKDOWN_ENTRIES)]}


class Profiler:
    """Start and stop a slice between loop iterations."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None
        self._stopped = None
        self._slice = None
        self.start_ns = self.end_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.end_ns = time.time_ns()
        self.prof.stop()
        self._stopped, self.prof = self.prof, None

    @property
    def on(self) -> bool:
        return self.prof is not None

    def slice(self, phases: list) -> Slice:
        """The stopped slice, reduced (after the window)."""
        if self._slice is None:
            self._slice = reduce(self._stopped, self.start_ns, self.end_ns, phases)
            self._stopped = None
        return self._slice
