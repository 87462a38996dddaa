"""Tracing spine: the port's copy of lws_tpu/core/trace.py, with the same
record format, so a JSONL file written by either package's `export_jsonl`
reads back in the other's `read_jsonl`. Left out: JAX's
`LWS_TPU_TRACE_EXPORT` stream of every finished span (`export_path`),
which no port process turns on.

  * context-manager + decorator API over a thread-local span stack, so
    nesting and parent/child links come for free;
  * monotonic clocks for duration, wall clock for export ordering;
  * bounded in-memory ring of finished spans + JSONL export;
  * cross-process propagation: a span's `context` is a 2-key dict that
    rides any JSON channel (the KV transport's frame meta) and seeds a
    child span in the peer process; the peer's finished records ride back
    and join this ring through `record`;
  * a no-op fast path: with tracing disabled (LWS_TPU_TRACE=0) or a root
    sampled out, `span()` returns one shared singleton — no allocation, no
    clock reads — so the paged decode loop keeps its throughput;
  * sections (port only): `section(name)` times a block on the host and
    adds `<name>_s` and `<name>_n` to the innermost live span, an
    accumulated attribute rather than a span of its own, so a block run
    once per layer costs two clock reads and a dict update. With no live
    span it is the shared no-op.

The module-level TRACER is the process default (one trace surface per
worker, like the process-global metrics REGISTRY); tests build private
`Tracer()` instances. It is a different object from the JAX package's.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from functools import wraps
from typing import Callable, Iterator, Optional


def _new_id() -> str:
    # 64-bit hex, cheap and collision-safe at ring scale.
    return f"{random.getrandbits(64):016x}"


class _NoopSpan:
    """Shared do-nothing span: the disabled fast path. Implements the FULL
    Span surface (context/set/duration_s/to_dict) so callers that serialize
    or link spans degrade gracefully instead of crashing when tracing is
    off."""

    __slots__ = ()
    context: Optional[dict] = None
    duration_s: float = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def add(self, **attrs) -> None:
        pass

    def to_dict(self) -> dict:
        return {
            "name": "disabled", "trace_id": "", "span_id": "",
            "parent_id": None, "start_unix": 0.0, "duration_s": 0.0,
            "status": "disabled", "attrs": {},
        }


NOOP = _NoopSpan()


class _Section:
    """Host seconds of one block, accumulated on a live span as
    `<name>_s`, with `<name>_n` counting the blocks; `add` accumulates
    further numeric attributes on the same span."""

    __slots__ = ("_span", "_keys", "_t0")

    def __init__(self, span: "Span", keys: tuple) -> None:
        self._span = span
        self._keys = keys

    def __enter__(self) -> "_Section":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        attrs, (key_s, key_n) = self._span.attrs, self._keys
        attrs[key_s] = attrs.get(key_s, 0.0) + dt
        attrs[key_n] = attrs.get(key_n, 0) + 1
        return False

    def add(self, **attrs) -> None:
        self._span.add(**attrs)


class _SuppressedSpan(_NoopSpan):
    """Sampled-out subtree marker: a root that loses the sampling roll
    returns one of these, and while it sits on the thread's suppress depth
    every descendant is suppressed too — a trace is sampled WHOLE, never
    shredded into orphan fragments."""

    __slots__ = ("_tracer",)

    def __init__(self, tracer: "Tracer") -> None:
        self._tracer = tracer

    def __enter__(self) -> "_SuppressedSpan":
        self._tracer._tls_state().suppressed += 1
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._tls_state().suppressed -= 1
        return False


class Span:
    """One timed operation. Use as a context manager (via Tracer.span);
    attributes set with `span.set(k=v)` ride into the finished record."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "start_unix", "duration_s", "status", "_t0", "_tracer",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.start_unix = 0.0
        self.duration_s = 0.0
        self.status = "ok"
        self._t0 = 0.0

    @property
    def context(self) -> dict:
        """Wire-portable parent reference: put it in any JSON meta and pass
        it back as `span(..., parent=ctx)` in the receiving process."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def add(self, **attrs) -> None:
        """Accumulate numeric attributes (missing keys start at 0): the
        host-blocked / device-wait attribution the serving pipeline folds
        into its enclosing dispatch span, one increment per window."""
        for k, v in attrs.items():
            self.attrs[k] = self.attrs.get(k, 0) + v

    def __enter__(self) -> "Span":
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration_s = time.perf_counter() - self._t0
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}"[:200])
        self._tracer._pop(self)
        self._tracer._finish(self)
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": round(self.start_unix, 6),
            "duration_s": round(self.duration_s, 6),
            "status": self.status,
            "attrs": self.attrs,
        }


class Tracer:
    def __init__(
        self,
        ring: int = 4096,
        enabled: Optional[bool] = None,
        sample_rate: Optional[float] = None,
    ) -> None:
        """`ring` bounds finished spans kept in memory (oldest dropped).
        `enabled` defaults from LWS_TPU_TRACE (on unless "0"/"false"/"off").
        `sample_rate` (default LWS_TPU_TRACE_SAMPLE or 1.0) decides at ROOT
        span creation; children always follow their root's decision."""
        if enabled is None:
            enabled = os.environ.get("LWS_TPU_TRACE", "1").lower() not in (
                "0", "false", "off",
            )
        if sample_rate is None:
            sample_rate = float(os.environ.get("LWS_TPU_TRACE_SAMPLE", "1.0"))
        self.enabled = enabled
        self.sample_rate = sample_rate
        self._ring: "deque[dict]" = deque(maxlen=ring)
        self._tls = threading.local()
        # ident -> that thread's live span stack (the SAME list _TlsState
        # holds, registered once per thread): the sampling profiler
        # (core/profile.py) reads other threads' stacks from its sampler
        # thread to tag samples by semantic phase. CPython dict/list ops
        # are GIL-atomic; readers copy before iterating and tolerate a
        # push/pop racing the copy (one sample mis-tagged by one frame).
        self._thread_stacks: dict[int, list] = {}
        self._prune_pending: set = set()  # idents absent from ONE live set
        self._section_keys: dict[str, tuple] = {}  # name -> (name_s, name_n)
        # Finish listeners: called with every finished span's record dict.
        # An empty list costs one truthiness check on the hot path.
        self._finish_listeners: list = []

    # ---- span stack (thread-local: concurrent reconcile workers and
    # serving threads each nest independently) ----------------------------
    class _TlsState:
        __slots__ = ("stack", "suppressed")

        def __init__(self) -> None:
            self.stack: list = []
            self.suppressed = 0  # sampled-out subtree depth

    def _tls_state(self) -> "_TlsState":
        state = getattr(self._tls, "state", None)
        if state is None:
            state = self._tls.state = Tracer._TlsState()
            self._thread_stacks[threading.get_ident()] = state.stack
        return state

    def stack_names(self, ident: int) -> list[str]:
        """Span names live on thread `ident`, outermost first — the
        profiler's phase tags. Copied so a racing push/pop cannot tear the
        iteration; an empty/unknown thread reads as untagged."""
        stack = self._thread_stacks.get(ident)
        if not stack:
            return []
        return [s.name for s in list(stack)]

    def prune_thread_stacks(self, live: set) -> None:
        """Drop stack registrations for dead threads (idents not in `live`,
        the sys._current_frames() key set) — without this every short-lived
        worker thread would pin its stack list forever. Two-pass: an ident
        is dropped only after being absent from TWO consecutive live sets.
        A thread that registers between the caller's frame snapshot and
        this call is missing from the (stale) first set but present in the
        next one — one-pass pruning would deregister it while alive, and
        since registration happens only on TLS-state creation, its samples
        would stay untagged for the thread's whole lifetime."""
        # list() first: other threads insert registrations concurrently
        # (first span on a new thread), and iterating the live dict would
        # raise "dictionary changed size during iteration".
        doomed = {i for i in list(self._thread_stacks) if i not in live}
        for ident in doomed & self._prune_pending:
            self._thread_stacks.pop(ident, None)
        self._prune_pending = doomed

    def _stack(self) -> list:
        return self._tls_state().stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # exited out of order: drop it wherever it sits
            stack.remove(span)

    def add_finish_listener(self, fn: Callable[[dict], None]) -> None:
        """Register `fn(record)` to observe every finished span. Idempotent
        per function."""
        if fn not in self._finish_listeners:
            self._finish_listeners.append(fn)

    def remove_finish_listener(self, fn: Callable[[dict], None]) -> None:
        if fn in self._finish_listeners:
            self._finish_listeners.remove(fn)

    def _finish(self, span: Span) -> None:
        record = span.to_dict()
        self._ring.append(record)
        for listener in self._finish_listeners:
            try:
                listener(record)
            except Exception:  # noqa: BLE001 — a broken listener must never break span accounting
                pass

    # ---- public API ------------------------------------------------------
    def span(self, name: str, parent: Optional[dict] = None, **attrs):
        """Start a span. `parent` overrides the thread-local stack — pass a
        peer process's span `context` dict to graft onto its trace. Returns
        the shared NOOP singleton when tracing is off or the root is
        sampled out (children of a live span are always kept: a trace is
        sampled whole, never shredded)."""
        if not self.enabled:
            return NOOP
        state = self._tls_state()
        current = state.stack[-1] if state.stack else None
        if parent is not None and parent.get("trace_id"):
            # Explicit cross-process context wins: the peer already decided
            # to sample this trace.
            trace_id = parent["trace_id"]
            parent_id = parent.get("span_id")
        elif current is not None:
            trace_id = current.trace_id
            parent_id = current.span_id
        else:
            if state.suppressed > 0 or (
                self.sample_rate < 1.0 and random.random() >= self.sample_rate
            ):
                # Root lost the roll (or sits under one that did): suppress
                # the WHOLE subtree so sampling can't shred a trace into
                # orphan fragments.
                return _SuppressedSpan(self)
            trace_id = _new_id()
            parent_id = None
        return Span(self, name, trace_id, parent_id, attrs)

    def section(self, name: str):
        """Time the enclosed block on the host into the innermost live span
        of this thread (`<name>_s` seconds and `<name>_n` blocks, summed).
        Returns the shared NOOP, reading no clock, when tracing is off, the
        root was sampled out, or no span is live."""
        if not self.enabled:
            return NOOP
        state = getattr(self._tls, "state", None)
        if state is None or not state.stack or state.suppressed:
            return NOOP
        keys = self._section_keys.get(name)
        if keys is None:
            keys = self._section_keys[name] = (f"{name}_s", f"{name}_n")
        return _Section(state.stack[-1], keys)

    def trace(self, name: Optional[str] = None, **attrs) -> Callable:
        """Decorator form: the wrapped call runs inside a span named after
        the function (or `name`)."""

        def deco(fn: Callable) -> Callable:
            span_name = name or fn.__qualname__

            @wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(span_name, **attrs):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def current_context(self) -> Optional[dict]:
        stack = self._stack()
        return stack[-1].context if stack else None

    def current_span(self):
        """The innermost live span on this thread, or the shared NOOP when
        none is open — callers may unconditionally set()/add() on it."""
        stack = self._stack()
        return stack[-1] if stack else NOOP

    def record(self, record: dict) -> None:
        """Ingest a span record produced elsewhere (a peer process's subtree
        riding back over the result channel) into this ring."""
        self._ring.append(dict(record))

    def spans(self, limit: Optional[int] = None) -> list[dict]:
        """Finished spans, oldest first; `limit` keeps the most recent N."""
        out = list(self._ring)
        if limit is not None and limit >= 0:
            # out[-0:] would be the WHOLE list — limit=0 means none.
            out = out[-limit:] if limit else []
        return out

    def clear(self) -> None:
        self._ring.clear()

    def export_jsonl(self, path: str) -> int:
        """Write the ring as JSON lines; returns the span count."""
        spans = self.spans()
        with open(path, "w") as f:
            for record in spans:
                f.write(json.dumps(record, default=str) + "\n")
        return len(spans)

    @staticmethod
    def read_jsonl(path: str) -> list[dict]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


def connected_tree(spans: list[dict]) -> bool:
    """True iff the records form ONE trace whose parent links all resolve:
    exactly one trace_id, exactly one root (parent_id None or pointing
    outside the set counts as a root), and every other span's parent_id is
    another span's span_id. The e2e acceptance check."""
    if not spans:
        return False
    if len({s["trace_id"] for s in spans}) != 1:
        return False
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if s.get("parent_id") not in ids]
    return len(roots) == 1


def walk(spans: list[dict], root_id: str) -> Iterator[dict]:
    """Depth-first iteration of a span subtree by parent links."""
    children: dict[Optional[str], list[dict]] = {}
    for s in spans:
        children.setdefault(s.get("parent_id"), []).append(s)
    todo = [s for s in spans if s["span_id"] == root_id]
    while todo:
        s = todo.pop()
        yield s
        todo.extend(children.get(s["span_id"], []))


# Process-default tracer + conveniences.
TRACER = Tracer()


def span(name: str, parent: Optional[dict] = None, **attrs):
    return TRACER.span(name, parent=parent, **attrs)


def section(name: str):
    return TRACER.section(name)


def traced(name: Optional[str] = None, **attrs) -> Callable:
    return TRACER.trace(name, **attrs)


def current_context() -> Optional[dict]:
    return TRACER.current_context()


def current_span():
    return TRACER.current_span()


def record(rec: dict) -> None:
    TRACER.record(rec)


def spans(limit: Optional[int] = None) -> list[dict]:
    return TRACER.spans(limit)


def set_enabled(enabled: bool) -> None:
    TRACER.enabled = enabled
