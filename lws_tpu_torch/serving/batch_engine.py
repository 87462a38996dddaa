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
slot past its budget flushes the ring first. Left out: telemetry (SLO
timelines, spans, metrics).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    forward_decode_slotted,
    forward_prefill,
    init_cache,
)
from lws_tpu_torch.serving.paged_engine import pow2_rows
from lws_tpu_torch.serving.pipeline import DecodePipeline, remaining_steps


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    tokens: list[int] = field(default_factory=list)
    slot: int = -1

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
        self._pipeline = DecodePipeline(depth=pipeline_depth)
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
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Optional[int]:
        """Admit a request into a free slot; returns its id (None: no free
        slot). The first token is on the host when this returns."""
        if not self._free and self._pipeline:
            # A completion may be sitting unconsumed in the in-flight ring.
            self._pipeline.flush()
        if not self._free:
            return None
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        slot = self._free.pop(0)
        req = Request(next(self._ids), np.asarray(prompt), max_new_tokens, slot=slot)
        plen = len(prompt)
        # A power-of-two bucket of at least 8 rows (lws_tpu/serving/batch_engine.py:147).
        padded = np.zeros((1, min(pow2_rows(plen, 8), self.max_len)), np.int64)
        padded[0, :plen] = prompt
        first, slot_cache = self._prefill_one(torch.tensor(padded, device=self.device), plen - 1)
        self._insert(slot_cache, slot, plen, first)
        req.tokens.append(int(first[0]))
        if req.done:  # max_new_tokens == 1: the prefill token alone finishes it
            self._completed[req.request_id] = req
            self._free.append(slot)
        else:
            self._active[slot] = req
            self._active_mask[slot] = True
        return req.request_id

    def _retire(self, slot: int, req: Request) -> None:
        """Complete a request and free its slot. Identity-guarded: a request
        retired by an earlier commit is not freed twice."""
        self._completed[req.request_id] = req
        if self._active.get(slot) is req:
            del self._active[slot]
            self._active_mask[slot] = False
            self._free.append(slot)

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
        with self._pipeline.host_section():
            active = torch.tensor(self._active_mask, device=self.device)  # a copy
            logits, self.cache = forward_decode_slotted(self.params, self.tokens, self.cache,
                                                        self.pos_b)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            self.tokens = torch.where(active, nxt, self.tokens)
            self.pos_b = torch.where(active, self.pos_b + 1, self.pos_b)
            self.stats["decode_steps"] += 1
            # Only requests active at dispatch get a token from this step.
            snapshot = dict(self._active)

            def commit(host_tokens, snapshot=snapshot):
                for slot, req in snapshot.items():
                    req.tokens.append(int(host_tokens[slot]))
                    # The position is host-derivable: prompt + generated tokens.
                    if req.done or len(req.prompt) + len(req.tokens) >= self.max_len:
                        self._retire(slot, req)

            self._pipeline.push(1, self.tokens, commit)

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
