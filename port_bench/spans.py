"""The program's own spans in a traced run, laid on the profiled slice's
clock: what the readers of the program-span metrics read, and the tables
the traced run prints on standard error.

The port traces its serving hot path itself (`lws_tpu_torch/core/trace.py`
spans and sections, `serving/paged_engine.py` PORT_SPANS). After the window
the spans are read from the tracer's ring of finished spans in the running
program, found in `sys.modules` (this module imports nothing of the
program: a program whose tracer is off, or that lacks a span, leaves the
readers with nothing to read, and they report nothing). A span's interval
on the trace's clock is [start_unix, start_unix + duration_s], in
nanoseconds; the window's perf_counter edges are mapped onto it with the
offset between the two clocks read at reading time.

The ring is bounded and keeps spans in the order they finish: every span
that finished after the oldest one kept is there, so the window is read
from the end of the oldest kept span (or the window's start, if later) to
the slice's start ("covered"): host readings are of that stretch.

Device operations are tied to the runtime call that launched them by
order, kind by kind (pair): the slice opens and closes on a synchronised
device and the port launches on one stream, so the kernel launch calls of
the slice (a `cuLaunch*` call inside a `cudaLaunch*` call is the same
launch) and its kernels come in one order, and likewise its copies and
memsets. A kind whose operations and calls differ in number is not
paired, and no table rests on it; the device seconds that a span's calls
launched are then bounded from the counts (launched_in), and read where the
bounds lie close. No timing test is put on a pairing: on the H100 the trace has
stamped operations up to milliseconds before their calls in some
processes, its device clock set apart from the host's. For the same
reason the device's stamps are moved, before an idle gap is named by the
program span its middle lies in, by the least shift that puts no
operation before its launching call (device_shift).
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

TRACE_MODULE = "lws_tpu_torch.core.trace"
LAUNCH = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")
KINDS = {"kernel": "kernels", "copy": "copies", "memset": "memsets"}  # kind: plural
WAIT_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize")
PHASES = ("admit", "step_n", "poll")
SECTIONS = ("attn", "ffn", "moe_route", "moe_dispatch", "moe_experts", "moe_combine",
            "lm_head", "sample", "dequant")
EDGE_NS = 2_000  # the rounding of a record's stamps (1 us each) at a slice edge
# Where a kind's operations and calls differ in number, the most its
# device reading's bounds may lie apart, as a share of their middle
# (launched_in).
AMBIGUITY = 0.01


@dataclass
class Span:
    name: str
    a: int                # start, ns on the trace's clock
    b: int                # end
    attrs: dict
    sid: str
    parent: Optional[str]
    children: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.b - self.a) / 1e9


@dataclass
class Program:
    """The window's spans: `outside` the slice within the covered stretch
    [cover[0], cover[1]), and `sliced` inside the slice; `by_id` holds both."""

    t0: int               # the window's start, ns on the trace's clock
    cover: tuple
    outside: list
    sliced: list
    by_id: dict
    launches: list = field(default_factory=list)  # (name, start, end) of launching calls
    paired: dict = field(default_factory=dict)    # kind -> [(op, its call's start)]
    unpaired: dict = field(default_factory=dict)  # kind -> (its calls, its operations)
    pairing: str = ""                             # what paired, and why a kind did not
    _starts: list = field(default_factory=list)
    _labels: list = field(default_factory=list)

    @property
    def cover_seconds(self) -> float:
        return max(0, self.cover[1] - self.cover[0]) / 1e9

    def named(self, name: str, sliced: bool = False) -> list:
        return [s for s in (self.sliced if sliced else self.outside) if s.name == name]

    def innermost(self, t: int) -> Optional[Span]:
        """The innermost span of the slice covering t, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        return self._labels[i] if i >= 0 else None

    def within(self, s: Span, name: str) -> bool:
        """Whether s is, or lies inside, a span called `name`."""
        while s is not None:
            if s.name == name:
                return True
            s = self.by_id.get(s.parent)
        return False


def tracer_records() -> list:
    """The running program's finished span records, oldest first (none
    when its tracer was never loaded)."""
    mod = sys.modules.get(TRACE_MODULE)
    tracer = getattr(mod, "TRACER", None)
    return list(tracer.spans()) if tracer is not None else []


def unix_offset() -> float:
    """time.time() - time.perf_counter(), now."""
    return time.time() - time.perf_counter()


def program(rec) -> Optional[Program]:
    """The Program of a traced run's record, or None when the run has no
    slice or the program kept no span in its window. Read once and kept on
    the record as `program_spans` (harness.Record has no such field: the
    six readers share it this way)."""
    if "program_spans" not in vars(rec):
        rec.program_spans = build(rec, tracer_records(), unix_offset())
    return rec.program_spans


def build(rec, records: list, offset: float) -> Optional[Program]:
    sl = rec.slice
    if sl is None or not records:
        return None
    t0 = int((rec.t0 + offset) * 1e9)
    oldest_end = min(int(round((r["start_unix"] + r["duration_s"]) * 1e9)) for r in records)
    spans = []
    for r in records:
        a = int(round(r["start_unix"] * 1e9))
        spans.append(Span(r["name"], a, a + int(round(r["duration_s"] * 1e9)),
                          r.get("attrs") or {}, r["span_id"], r.get("parent_id")))
    cover = (max(t0, oldest_end), sl.start_ns)
    outside = [s for s in spans if s.a >= cover[0] and s.b <= cover[1] + EDGE_NS]
    sliced = [s for s in spans if s.a >= sl.start_ns - EDGE_NS and s.b <= sl.end_ns + EDGE_NS]
    if not outside and not sliced:
        return None
    by_id = {s.sid: s for s in outside + sliced}
    for s in by_id.values():
        if s.parent in by_id:
            by_id[s.parent].children.append(s)
    prog = Program(t0, cover, outside, sliced, by_id)
    prog._starts, prog._labels = segments(sliced)
    prog.launches = launch_calls(sl.host)
    prog.paired, prog.pairing = pair(prog.launches, sl.ops)
    prog.unpaired = {kind: calls_ops for kind in KINDS if kind not in prog.paired
                     and len((calls_ops := by_kind(prog.launches, sl.ops, kind))[1])}
    return prog


def segments(spans: list) -> tuple:
    """Elementary stretches of the trace's clock, each labelled with the
    innermost span over it (None: outside the program): (starts, labels)."""
    events = []
    for s in spans:
        events.append((s.a, 1, s))
        events.append((s.b, 0, s))
    events.sort(key=lambda e: (e[0], e[1], -e[2].b if e[1] else e[2].a))
    starts, labels, stack = [], [], []
    for t, opening, s in events:
        if opening:
            stack.append(s)
        elif s in stack:
            stack.remove(s)
        top = stack[-1] if stack else None
        if starts and starts[-1] == t:
            labels[-1] = top
        else:
            starts.append(t)
            labels.append(top)
    return starts, labels


def launch_calls(host: list) -> list:
    """The slice's launching runtime calls, (name, start, end) in start
    order; a launching call inside another is the same launch."""
    calls = sorted((h for h in host if LAUNCH.search(h[0])), key=lambda h: (h[1], -h[2]))
    out = []
    for name, a, b in calls:
        if out and a >= out[-1][1] and b <= out[-1][2]:
            continue
        out.append((name, a, b))
    return out


def call_kind(name: str) -> str:
    return "copy" if "Memcpy" in name else "memset" if "Memset" in name else "kernel"


def op_kind(name: str) -> str:
    return "copy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") \
        else "kernel"


def by_kind(launches: list, ops: list, kind: str) -> tuple:
    """(the launching calls of `kind`, its operations in start order)."""
    return ([c for c in launches if call_kind(c[0]) == kind],
            sorted((o for o in ops if op_kind(o[0]) == kind), key=lambda o: o[1]))


def pair(launches: list, ops: list) -> tuple:
    """{kind: [(op, its launching call's start)]} for each kind with as
    many operations as calls, call k with operation k, and a line saying
    what paired (with the most an operation is stamped before its call)
    and why a kind did not."""
    paired, notes = {}, []
    for kind, plural in KINDS.items():
        calls, kops = by_kind(launches, ops, kind)
        if not calls and not kops:
            continue
        if len(calls) != len(kops):
            notes.append(f"{plural} not paired: {len(calls)} calls, {len(kops)} operations")
            continue
        paired[kind] = [(o, c[1]) for c, o in zip(calls, kops)]
        lead = max(c[1] - o[1] for c, o in zip(calls, kops))
        notes.append(f"{len(kops)} {plural} paired"
                     + (f" (the most an operation leads its call: {lead} ns)" if lead > 0 else ""))
    return paired, "; ".join(notes) or "no device operation"


def idle_gaps(sl, shift: int = 0) -> list:
    """The slice's stretches with no device operation running, (start,
    end), with the operations' stamps moved by `shift` ns."""
    gaps, end = [], sl.start_ns
    for _, a, b in sorted(sl.ops, key=lambda o: o[1]):
        a, b = a + shift, b + shift
        if a > end:
            gaps.append((end, min(a, sl.end_ns)))
        end = max(end, b)
    if end < sl.end_ns:
        gaps.append((end, sl.end_ns))
    return [(a, b) for a, b in gaps if b > a]


def device_shift(prog: Program) -> int:
    """The least shift (ns) of the trace's device stamps that puts no
    paired operation before its launching call: 0 where the stamps agree
    with the host's, and milliseconds in some processes (PERF.md §5)."""
    return max([0] + [c - o[1] for pairs in prog.paired.values() for o, c in pairs])


def launched_by(prog: Program) -> list:
    """(op seconds, innermost span of its launching call) for each device
    operation of a paired kind."""
    return [((o[2] - o[1]) / 1e9, prog.innermost(c))
            for kind in KINDS for o, c in prog.paired.get(kind, [])]


def launched_in(prog: Program, name: str) -> tuple:
    """(least, most) device seconds of the operations launched by calls
    inside spans called `name`. A paired kind gives its seconds exactly. A
    kind with d more operations than calls (or -d fewer) is bounded from
    the counts, on the understanding that its misses all go one way (calls
    whose operation the trace lost, or operations whose call it lost):
    the call k of a run of calls inside such spans launched an operation
    among k+min(0, d) to k+max(0, d), so the run launched at least the
    operations between its first call's latest place and its last call's
    earliest, and at most those between the earliest and the latest."""
    lo = hi = 0.0
    for kind in KINDS:
        if kind in prog.paired:
            t = sum((o[2] - o[1]) / 1e9 for o, c in prog.paired[kind]
                    if prog.within(prog.innermost(c), name))
            lo, hi = lo + t, hi + t
            continue
        calls, kops = prog.unpaired.get(kind, ([], []))
        d = len(kops) - len(calls)
        cum = [0]
        for _, a, b in kops:
            cum.append(cum[-1] + b - a)

        def seconds(i, j):
            i, j = max(0, i), min(len(kops), j)
            return (cum[j] - cum[i]) / 1e9 if j > i else 0.0

        inside = [prog.within(prog.innermost(c[1]), name) for c in calls] + [False]
        start = None
        for k, flag in enumerate(inside):
            if flag and start is None:
                start = k
            elif not flag and start is not None:
                lo += seconds(start + max(0, d), k + min(0, d))
                hi += seconds(start + min(0, d), k + max(0, d))
                start = None
    return lo, hi


# ---- the readings --------------------------------------------------------


def decode_launch_ms(prog: Optional[Program]) -> Optional[float]:
    spans = prog.named("serve.decode_launch") if prog else []
    steps = sum(s.attrs.get("steps", 0) for s in spans)
    return sum(s.seconds for s in spans) / steps * 1e3 if steps else None


def decode_device_ms(prog: Optional[Program], sl) -> Optional[float]:
    if prog is None or sl is None or not sl.clock_ok:
        return None
    spans = prog.named("serve.decode_launch", sliced=True)
    steps = sum(s.attrs.get("steps", 0) for s in spans)
    if not steps:
        return None
    lo, hi = launched_in(prog, "serve.decode_launch")
    mid = (lo + hi) / 2
    if not mid or hi - lo > AMBIGUITY * mid:
        return None
    return mid / steps * 1e3


def ring_blocked_pct(prog: Optional[Program]) -> Optional[float]:
    if prog is None or not prog.cover_seconds:
        return None
    blocked = [s.attrs["host_blocked_s"] for s in prog.outside if "host_blocked_s" in s.attrs]
    return 100.0 * sum(blocked) / prog.cover_seconds if blocked else None


def admit_host_ms(prog: Optional[Program]) -> list:
    """Each admitted request's host milliseconds in `submit`, outside the
    slice: the admission's duration less its first-token wait."""
    out = []
    for s in prog.named("serve.admission") if prog else []:
        waits = [c for c in s.children if c.name == "serve.first_token"]
        if s.attrs.get("admitted") and waits:
            out.append((s.seconds - sum(c.seconds for c in waits)) * 1e3)
    return out


def idle_in_program_pct(prog: Optional[Program], sl) -> Optional[float]:
    if prog is None or sl is None or not sl.clock_ok or not sl.ops:
        return None
    gaps = idle_gaps(sl, device_shift(prog))
    total = sum(b - a for a, b in gaps)
    inside = sum(b - a for a, b in gaps if prog.innermost((a + b) // 2) is not None)
    return 100.0 * inside / total if total else None


def moe_launch_pct(prog: Optional[Program]) -> Optional[float]:
    spans = prog.named("serve.decode_launch") if prog else []
    total = sum(s.seconds for s in spans)
    moe = sum(v for s in spans for k, v in s.attrs.items()
              if k.startswith("moe_") and k.endswith("_s"))
    return 100.0 * moe / total if total and any(
        k.startswith("moe_") for s in spans for k in s.attrs) else None


# ---- the checks and tables on standard error -----------------------------


def clock_check(prog: Program, sl) -> tuple:
    """(calls, inside): the slice's launching calls made inside the
    harness's admit, step_n and poll phases, and of those the ones inside
    a program span."""
    phases = sorted((a, b) for name, a, b in sl.phases if name in PHASES)
    starts = [a for a, _ in phases]
    calls = inside = 0
    for _, c, _ in prog.launches:
        i = bisect.bisect_right(starts, c) - 1
        if i >= 0 and c <= phases[i][1]:
            calls += 1
            inside += prog.innermost(c) is not None
    return calls, inside


def ring_wait_check(prog: Program, sl) -> tuple:
    """(Σ device_wait_s of the slice's consume and first-token spans, Σ
    seconds of the runtime wait calls inside them)."""
    spans = [s for s in prog.sliced if s.name in ("serve.decode_consume", "serve.first_token")]
    waited = sum(s.attrs.get("device_wait_s", 0.0) for s in spans)
    calls = sorted((a, b) for name, a, b in sl.host if name in WAIT_CALLS)
    starts = [a for a, _ in calls]
    in_calls = 0
    for s in spans:
        i = bisect.bisect_left(starts, s.a)
        while i < len(calls) and calls[i][0] <= s.b:
            in_calls += min(calls[i][1], s.b) - calls[i][0]
            i += 1
    return waited, in_calls / 1e9


def span_table(prog: Program, sl) -> list:
    """Per span name in the slice: (name, count, self s, device s launched,
    idle s), and the row of time outside the program."""
    rows = {}
    for s in sorted(prog.sliced, key=lambda s: s.a):
        r = rows.setdefault(s.name, [0, 0.0, 0.0, 0.0])
        r[0] += 1
        r[1] += s.seconds - sum(c.seconds for c in s.children)
    outside = [0, 0.0, 0.0, 0.0]
    for t, s in launched_by(prog):
        (rows[s.name] if s is not None else outside)[2] += t
    for a, b in idle_gaps(sl, device_shift(prog)) if sl.clock_ok else []:
        s = prog.innermost((a + b) // 2)
        (rows[s.name] if s is not None else outside)[3] += (b - a) / 1e9
    return [(n, *r) for n, r in rows.items()] + [("outside the program", *outside)]


def section_means(prog: Program) -> dict:
    """Host milliseconds of each section per span, outside the slice, for
    `serve.decode_launch` and `serve.prefill`."""
    out = {}
    for name in ("serve.decode_launch", "serve.prefill"):
        spans = prog.named(name)
        means = {k: 1e3 * sum(s.attrs.get(f"{k}_s", 0.0) for s in spans) / len(spans)
                 for k in SECTIONS if any(f"{k}_s" in s.attrs for s in spans)}
        if means:
            out[name] = means
    return out


def report(rec) -> list:
    """The traced run's lines about the program's spans."""
    prog, sl = program(rec), rec.slice
    if prog is None:
        return ["program spans: none in the window (the program's tracer is off or has none)"]
    lines = [f"program spans: {len(prog.outside)} in {prog.cover_seconds:.3f} s of the window "
             f"before the slice (from {(prog.cover[0] - prog.t0) / 1e9:.3f} s after it opens: "
             f"the tracer's ring), {len(prog.sliced)} in the slice; device operations tied to "
             f"their launching calls: {prog.pairing}"]
    by_name = collections.Counter(name for name, _, _ in prog.launches)
    lines.append("launching calls in the slice: "
                 + ", ".join(f"{n} {c}" for n, c in by_name.most_common()))
    calls, inside = clock_check(prog, sl)
    lines.append(f"clock check: {inside} of {calls} launching calls in the harness's admit, "
                 f"step_n and poll phases lie inside a program span"
                 + (f" ({100.0 * inside / calls:.2f} %)" if calls else ""))
    waited, in_calls = ring_wait_check(prog, sl)
    lines.append(f"ring-wait check: device_wait_s of the slice's serve.decode_consume and "
                 f"serve.first_token spans {waited:.6f} s; {' and '.join(WAIT_CALLS)} inside "
                 f"them {in_calls:.6f} s")
    if prog.unpaired:
        lo, hi = launched_in(prog, "serve.decode_launch")
        lines.append(f"device seconds launched in the slice's serve.decode_launch spans, bounded "
                     f"where a kind did not pair: {lo:.6f} to {hi:.6f} s (decode_device_ms is read "
                     f"where they lie at most {100 * AMBIGUITY:g} % of their middle apart)")
    shift = device_shift(prog)
    stamped = sum(b - a for a, b in idle_gaps(sl) if prog.innermost((a + b) // 2))
    lines.append(f"device stamps moved by {shift / 1e3:.3f} us onto the host's clock (the least "
                 f"shift that puts no operation before its launching call); idle inside a "
                 f"program span as stamped: {stamped / 1e9:.6f} s")
    lines.append("by program span in the slice: name, count, self s, device s launched, idle s")
    for name, n, self_s, dev, idle in span_table(prog, sl):
        lines.append(f"  {name:<24} {n:>5} {self_s:>10.6f} {dev:>10.6f} {idle:>10.6f}")
    sections = section_means(prog)
    for name, means in sections.items():
        lines.append(f"sections per {name} (ms): "
                     + ", ".join(f"{k} {v:.4f}" for k, v in means.items()))
    adm = [s for s in prog.named("serve.admission") if s.attrs.get("admitted")]
    if adm and "serve.prefill" in sections:  # a program that times no section counts no byte
        nbytes = sum(s.attrs.get("dequant_bytes", 0) for s in prog.named("serve.prefill"))
        lines.append(f"dequant_bytes per admission: {nbytes / len(adm):.0f} "
                     f"({len(adm)} admissions)")
    walks = prog.named("serve.prefix_walk")
    if walks:
        hit, shareable = (sum(s.attrs.get(k, 0) for s in walks) for k in ("hit_blocks", "blocks"))
        lines.append(f"prefix walks: {len(walks)}, {hit} of {shareable} shareable blocks hit")
    causes = collections.Counter(s.attrs.get("cause", "-") for s in prog.outside + prog.sliced
                                 if s.name == "serve.decode_flush")
    lines.append("flushes by cause: " + (", ".join(f"{c} {n}" for c, n in causes.most_common())
                                         or "none"))
    return lines


def print_report(rec) -> None:
    """Print report(rec) on standard error, once per record (the first
    reader to run prints it, before the harness prints its own lines)."""
    if vars(rec).get("program_spans_reported"):
        return
    rec.program_spans_reported = True
    for line in report(rec):
        print(line, file=sys.stderr)
    sys.stderr.flush()
