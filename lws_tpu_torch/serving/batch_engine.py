"""Continuous batching over a dense slot cache: the port of the BatchEngine
(lws_tpu/serving/batch_engine.py).

Sequences at different lengths decode together and new requests join
mid-stream. The cache is [L, slots, max_len, Hkv, hd] (int8 with scales
when cfg.kv_quant), updated in place; per-slot positions drive RoPE, the
K/V writes and the mask (models.llama.forward_decode_slotted: the int8
decode kernel with a [slots] pos on CUDA for an int8 cache). Admission
prefills one request alone, its prompt padded to a power-of-two bucket
(8 up to max_len), through forward_prefill (flash on CUDA), and copies its
rows into a free slot. Inactive slots compute but their outputs are ignored,
and their rows are overwritten on admission. Greedy only, as in JAX; the
PagedBatchEngine is the production engine, this one the simplest dense
implementation.

Decode steps ride the in-flight ring (serving/pipeline.py): step() never
waits for its own tokens, and a step that would run the soonest-finishing
slot past its budget flushes the ring first.

Telemetry rides the JAX engine's seams with its names and labels: each
request's SLO timeline (queue wait and first token at submit, one ITL
observation per committed step, finish at retire), the `serve.admission`,
`serve.prefill` and `serve.decode_dispatch` spans with `compile_site`s, and
`serving_requests_total`, the admission and dispatch durations and
`serving_active_slots{engine="batch"}`.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.core import metrics, slo, trace
from lws_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    forward_decode_slotted,
    forward_prefill,
    init_cache,
)
from lws_tpu_torch.obs import device as devicemod
from lws_tpu_torch.serving.paged_engine import pow2_rows
from lws_tpu_torch.serving.pipeline import DecodePipeline, remaining_steps


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    tokens: list[int] = field(default_factory=list)
    slot: int = -1
    # Per-request SLO timeline (queue wait / TTFT / ITL; core/slo.py).
    slo: "slo.RequestTimeline | None" = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class BatchEngine:
    """Slot-based continuously-batched greedy engine."""

    def __init__(self, cfg: LlamaConfig, params: Llama, slots: int = 8, max_len: int = 512,
                 pipeline_depth: Optional[int] = None, device: DeviceLike = None):
        """`device` defaults to CUDA (raising without a GPU); `params` must
        already live there. `pipeline_depth` bounds the steps in flight: 2 on
        CUDA, 0 (synchronous) on the CPU by default."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type or (
            self.device.index is not None and params.device != self.device
        ):
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        if params.cfg != cfg:
            raise ValueError("params were built for another LlamaConfig")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self._ids = itertools.count()
        self._free = list(range(slots))
        self._active: dict[int, Request] = {}  # slot -> request
        self._completed: dict[int, Request] = {}
        if pipeline_depth is None:
            pipeline_depth = 2 if self.device.type == "cuda" else 0
        self._pipeline = DecodePipeline(depth=pipeline_depth, engine="batch")
        self.cache = init_cache(cfg, slots, max_len, self.device)
        self.pos_b = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self.tokens = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._active_mask = np.zeros((slots,), bool)  # host truth, uploaded every step
        self.stats = {"decode_steps": 0}

    # ------------------------------------------------------------------
    def _prefill_one(self, prompt: torch.Tensor, last_pos: int):
        """Prefill one padded prompt [1, bucket] into a fresh one-row cache;
        returns (its greedy first token [1] int32, the cache)."""
        cache = init_cache(self.cfg, 1, prompt.shape[1], self.device)
        logits, cache = forward_prefill(self.params, prompt, cache, last_pos=last_pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def _insert(self, slot_cache, slot: int, plen: int, first: torch.Tensor) -> None:
        """Copy a one-row prefill cache's rows into slot `slot` (values and,
        for int8, their scales), then set the slot's position and running
        token. Rows past the bucket keep an earlier occupant's values, masked
        by position until decode overwrites them. tokens and pos_b are
        replaced, not written: a step in flight keeps the ones it read."""
        rows = slot_cache.k.shape[2]
        for name in ("k", "v", "k_scale", "v_scale"):
            src = getattr(slot_cache, name)
            if src is not None:
                getattr(self.cache, name)[:, slot, :rows] = src[:, 0]
        self.pos_b, self.tokens = self.pos_b.clone(), self.tokens.clone()
        self.pos_b[slot] = plen
        self.tokens[slot] = first[0]

    @torch.no_grad()
    def submit(self, prompt: np.ndarray, max_new_tokens: int, klass: str = "",
               arrival_t: Optional[float] = None) -> Optional[int]:
        """Admit a request into a free slot; returns its id (None: no free
        slot). The first token is on the host when this returns. `klass`
        labels the request's SLO/goodput series by workload class;
        `arrival_t` (a time.perf_counter() stamp) backdates the SLO arrival
        clock, so open-loop admission delay shows up as queue wait."""
        if not self._free and self._pipeline:
            # A completion may be sitting unconsumed in the in-flight ring.
            self._pipeline.flush()
        if not self._free:
            return None
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        slot = self._free.pop(0)
        req = Request(next(self._ids), np.asarray(prompt), max_new_tokens, slot=slot,
                      slo=slo.request("batch", arrival_t, klass=klass))
        plen = len(prompt)
        t0 = time.perf_counter()
        with trace.span("serve.admission", engine="batch", prompt_len=plen):
            # A power-of-two bucket of at least 8 rows (lws_tpu/serving/batch_engine.py:147).
            bucket = min(pow2_rows(plen, 8), self.max_len)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :plen] = prompt
            with trace.span("serve.prefill", chunked=False, prompt_len=plen), \
                    devicemod.compile_site("batch.prefill", engine="batch", shape=f"b{bucket}",
                                           request_id=req.slo.request_id):
                first, slot_cache = self._prefill_one(torch.tensor(padded, device=self.device),
                                                      plen - 1)
            self._insert(slot_cache, slot, plen, first)
        metrics.inc("serving_requests_total", {"engine": "batch"})
        metrics.observe("serving_admission_duration_seconds", time.perf_counter() - t0,
                        {"engine": "batch"})
        req.tokens.append(int(first[0]))
        # Queue wait (arrival -> slot) and TTFT (arrival -> prefill token):
        # for this engine both end at submit(); with a backdated arrival the
        # wait is the real arrival -> submit gap.
        req.slo.queue_wait(0.0 if arrival_t is None else max(0.0, t0 - arrival_t))
        req.slo.first_token()
        if req.done:  # max_new_tokens == 1: the prefill token alone finishes it
            req.slo.finish()
            self._completed[req.request_id] = req
            self._free.append(slot)
        else:
            self._active[slot] = req
            self._active_mask[slot] = True
        metrics.set("serving_active_slots", len(self._active), {"engine": "batch"})
        return req.request_id

    def _retire(self, slot: int, req: Request) -> None:
        """Complete a request and free its slot. Identity-guarded: a request
        retired by an earlier commit is not freed twice."""
        req.slo.finish()
        self._completed[req.request_id] = req
        if self._active.get(slot) is req:
            del self._active[slot]
            self._active_mask[slot] = False
            self._free.append(slot)
            metrics.set("serving_active_slots", len(self._active), {"engine": "batch"})

    @torch.no_grad()
    def step(self) -> None:
        """One decode step across every active slot, pipelined: its tokens
        are pushed onto the in-flight ring and committed on a later call (or
        flush). A step that would run the soonest-finishing slot past its
        budget flushes the ring first."""
        if not self._active:
            self._pipeline.flush()
            return
        bound = min(remaining_steps(r, self.max_len) for r in self._active.values()) \
            - self._pipeline.inflight_steps()
        if bound < 1:
            self._pipeline.flush()
            if not self._active:
                return
        t0 = time.perf_counter()
        with trace.span("serve.decode_dispatch", engine="batch", steps=1,
                        active=len(self._active), inflight=len(self._pipeline)):
            with self._pipeline.host_section():
                active = torch.tensor(self._active_mask, device=self.device)  # a copy
                with devicemod.compile_site("batch.step", engine="batch"):
                    logits, self.cache = forward_decode_slotted(self.params, self.tokens,
                                                                self.cache, self.pos_b)
                    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                    self.tokens = torch.where(active, nxt, self.tokens)
                    self.pos_b = torch.where(active, self.pos_b + 1, self.pos_b)
                self.stats["decode_steps"] += 1
            # Only requests active at dispatch get a token from this step.
            snapshot = dict(self._active)

            def commit(host_tokens, snapshot=snapshot):
                for slot, req in snapshot.items():
                    req.tokens.append(int(host_tokens[slot]))
                    req.slo.tokens(1)  # ITL: the gap since this request's last commit
                    # The position is host-derivable: prompt + generated tokens.
                    if req.done or len(req.prompt) + len(req.tokens) >= self.max_len:
                        self._retire(slot, req)

            self._pipeline.push(1, self.tokens, commit)
        metrics.observe("serving_decode_dispatch_duration_seconds", time.perf_counter() - t0,
                        {"engine": "batch"})

    def run_until_drained(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if not self._active:
                self._pipeline.flush()  # commits only retire, never admit
                return
            self.step()
        raise RuntimeError("engine did not drain")

    def result(self, request_id: int) -> Optional[list[int]]:
        req = self._completed.get(request_id)
        if req is None and self._pipeline:
            # Flush only when the request could have finished in flight.
            live = next((r for r in self._active.values() if r.request_id == request_id), None)
            if live is None or remaining_steps(live, self.max_len) <= self._pipeline.inflight_steps():
                self._pipeline.flush()
                req = self._completed.get(request_id)
        return list(req.tokens) if req is not None else None

    @property
    def active_count(self) -> int:
        return len(self._active)
