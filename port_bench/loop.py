"""The closed loop, in one thread, and the record the metrics read.

Each of C clients has its own seeded stream of requests (traffic.py). A
client sends its next request the moment it sees its previous one
complete; the send is stamped then. One iteration of the loop:
  1. admit every waiting client, in the order they were sent, through the
     engine's `submit` (which returns once the first token is on the host);
  2. one `step_n(step_n)` over the requests still decoding (the engine
     clamps it to its completion bound, as `run_until_drained` does);
  3. poll `result` for every request whose last token has been launched.

The loop counts each request's launched tokens itself (1 at admission, n
at each step_n for every request still decoding), which is exact: the
engine never gives a request more steps than it has left, and retires a
request before the next dispatch once its last step is in flight. So the
tokens produced in the window are the sum of n x decoding requests over
its step_n calls, plus its admissions' first tokens.

The engine is anything with `submit(prompt, max_new) -> id | None`,
`step_n(n) -> steps`, `result(id) -> tokens | None` and `hit_tokens()`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from port_bench.traffic import Traffic


@dataclass
class Live:
    client: int
    prompt: np.ndarray
    max_new: int
    first: float
    launched: int = 1


@dataclass
class Admission:
    t0: float
    t1: float
    sent: float
    plen: int
    hit: int
    max_new: int
    window: bool
    sliced: bool


@dataclass
class Dispatch:
    t0: float
    t1: float
    n: int
    active: int
    keys: int       # (query, key) pairs of the chunk's attention over the active requests
    window: bool
    sliced: bool


@dataclass
class Completion:
    t: float
    first: float
    max_new: int
    ok: bool
    window: bool


class ClosedLoop:
    def __init__(self, engine, traffic: Traffic, step_n: int, vocab: int,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine, self.traffic, self.step_n_size = engine, traffic, step_n
        self.vocab = vocab
        self.clock = clock
        self.next_j = [0] * traffic.clients
        self.waiting: dict[int, float] = {}   # client -> send stamp, in send order
        self.live: dict[int, Live] = {}       # engine id -> request
        self.admissions: list[Admission] = []
        self.dispatches: list[Dispatch] = []
        self.completions: list[Completion] = []
        self.done: list[tuple] = []           # (prompt, tokens) completed in the window
        self.refused = 0
        self.window = False                   # set while the measured window is open
        self.sliced = False                   # set while the profiler records
        self.phases: list[tuple] = []         # (name, start, end) wall-clock ns, while sliced
        self.decode_steps = 0

    def send(self, client: int) -> None:
        self.waiting[client] = self.clock()

    def iterate(self) -> None:
        for name, phase in (("admit", self._admit), ("step_n", self._step), ("poll", self._poll)):
            if self.sliced:
                a = time.time_ns()
                phase()
                self.phases.append((name, a, time.time_ns()))
            else:
                phase()

    def _admit(self) -> None:
        for client in list(self.waiting):
            req = self.traffic.request(client, self.next_j[client])
            hits = self.engine.hit_tokens()
            t0 = self.clock()
            rid = self.engine.submit(req.prompt, req.max_new)
            t1 = self.clock()
            if rid is None:  # out of slots or blocks: the client keeps waiting
                self.refused += 1
                break
            sent = self.waiting.pop(client)
            self.next_j[client] += 1
            self.admissions.append(Admission(t0, t1, sent, len(req.prompt),
                                             self.engine.hit_tokens() - hits, req.max_new,
                                             self.window, self.sliced))
            self.live[rid] = Live(client, req.prompt, req.max_new, t1)

    def _step(self) -> None:
        active = [r for r in self.live.values() if r.launched < r.max_new]
        if not active:
            return
        t0 = self.clock()
        n = self.engine.step_n(self.step_n_size)
        t1 = self.clock()
        ctx = 0
        for r in active:
            ctx += len(r.prompt) + r.launched
            r.launched += n
        keys = n * ctx + len(active) * n * (n - 1) // 2
        self.decode_steps += n
        self.dispatches.append(Dispatch(t0, t1, n, len(active), keys, self.window, self.sliced))

    def _poll(self) -> None:
        due = [rid for rid, r in self.live.items() if r.launched >= r.max_new]
        if not due:
            return
        for rid in due:
            toks = self.engine.result(rid)
            if toks is None:
                continue
            t = self.clock()
            r = self.live.pop(rid)
            ok = len(toks) == r.max_new and all(0 <= int(x) < self.vocab for x in toks)
            self.completions.append(Completion(t, r.first, r.max_new, ok, self.window))
            if self.window:
                self.done.append((r.prompt, np.asarray(toks, dtype=np.int32)))
            self.waiting[r.client] = t
