"""Paged continuous batching: the port of the PagedBatchEngine core
(lws_tpu/serving/paged_engine.py).

K/V live in a shared block pool instead of a dense [slots, max_len]
reservation: each request holds ceil(footprint / block_size) blocks for its
lifetime and returns them on completion, so a pool sized to the expected
live footprint serves more slots than a dense cache of the same bytes.

Allocation policy (host side, exclusive):
  * block 0 is the NULL block, never allocated; released and unallocated
    table entries point at it, so inactive slots' dead writes and reads land
    there, masked by position;
  * submit() takes ceil(max(bucket, plen + max_new) / bs) blocks up front
    (bucket: the prompt length rounded up to a power of two, at least one
    block) and returns None when the slots or the pool are exhausted.

Decode chunks ride the in-flight ring (serving/pipeline.py): step_n never
waits for its own chunk's tokens, and the completion bound subtracts the
steps already in flight, so no chunk can run a slot past its budget or read
blocks of a request already released. Device state (pool, positions,
running tokens) is updated in place in stream order; the host keeps the
truth for allocation, budgets and results.

On CUDA every prefill runs the flash kernel and every decode step the
paged-decode kernel (its int8 entry over an int8 pool when cfg.kv_quant);
with quantized weights the products of at most 256 rows run the int8_matmul
kernel. A build or launch failure raises. There is no fallback path. With
cfg.kv_quant the pool holds int8 K/V with per-(token, kv head) scales, and
admission scatters the prefill cache's int8 values and scales into it
unchanged. Left out of this slice: mesh/TP, prefix cache and its host and remote
tiers, chunked admission, speculative decoding, donation knobs, telemetry.
"""

from __future__ import annotations

import collections
import itertools
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    forward_decode_paged,
    forward_prefill,
    init_cache,
    init_paged_cache,
    paged_insert,
)
from lws_tpu_torch.serving.engine import sample_logits_per_slot
from lws_tpu_torch.serving.pipeline import DecodePipeline, remaining_steps


@dataclass
class PagedRequest:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    tokens: list[int] = field(default_factory=list)
    slot: int = -1
    blocks: list[int] = field(default_factory=list)
    # Per-request sampling: temperature <= 0 is greedy; seed pins the
    # request's generator for reproducible sampling.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class PagedBatchEngine:
    """Slot-based continuously-batched engine over a paged KV pool, with
    per-request sampling (greedy by default)."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Llama,
        slots: int = 8,
        max_len: int = 512,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        pipeline_depth: Optional[int] = None,
        device: DeviceLike = None,
    ):
        """`device` defaults to CUDA (raising without a GPU); `params` must
        already live there. `pipeline_depth` defaults to 2 in-flight decode
        chunks on CUDA and 0 (synchronous) on the CPU, where launches are
        not asynchronous and a ring buys nothing."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type or (
            self.device.index is not None and params.device != self.device
        ):
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        if params.cfg != cfg:
            raise ValueError("params were built for another LlamaConfig")
        if max_len % block_size:
            raise ValueError("max_len must be a multiple of block_size")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        # Default pool = dense equivalent (+ the null block); callers shrink
        # it for density.
        self.num_blocks = num_blocks if num_blocks is not None else slots * self.max_blocks + 1
        self._ids = itertools.count()
        self._free_slots = list(range(slots))
        # FIFO: allocation pops from the left, release appends on the right.
        self._free_blocks = collections.deque(range(1, self.num_blocks))  # 0 = null
        self._active: dict[int, PagedRequest] = {}
        self._completed: dict[int, PagedRequest] = {}

        dev = self.device
        self.cache = init_paged_cache(cfg, self.num_blocks, block_size, dev)
        self.table = np.zeros((slots, self.max_blocks), np.int32)  # host truth
        self.pos_b = torch.zeros(slots, dtype=torch.int32, device=dev)
        self.tokens = torch.zeros(slots, dtype=torch.int32, device=dev)
        # Per-slot sampling state (host truth, shipped when dirty).
        self.temp = np.zeros((slots,), np.float32)
        self.top_k = np.zeros((slots,), np.int32)
        self.top_p = np.ones((slots,), np.float32)
        self._gens = [torch.Generator(device=dev).manual_seed(s) for s in range(slots)]
        if pipeline_depth is None:
            pipeline_depth = 2 if dev.type == "cuda" else 0
        self._pipeline = DecodePipeline(depth=pipeline_depth)
        # Host-built dispatch inputs, re-uploaded only after admission or
        # release changed them. A rebuild makes a new tensor: in-flight
        # chunks keep the one they were launched with.
        self._active_mask = np.zeros((slots,), bool)
        self._active_dev: Optional[torch.Tensor] = None
        self._table_dev: Optional[torch.Tensor] = None
        self._sampling_dev: Optional[tuple[torch.Tensor, ...]] = None
        self._dirty_active = self._dirty_table = self._dirty_sampling = True
        self._sampled_active = 0  # live requests with temperature > 0
        self.stats = {
            "attention_path": "kernel" if dev.type == "cuda" else "plain",
            "decode_steps": 0,
        }

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def active_count(self) -> int:
        return len(self._active)

    def pool_accounting(self) -> dict[str, int]:
        """Block-pool counts. `live` is computed from the blocks requests
        hold, so free + live == num_blocks - 1 (block 0 being the null
        block) detects a leaked or double-counted block."""
        live_blocks: set[int] = set()
        for req in self._active.values():
            live_blocks.update(req.blocks)
        return {
            "free": len(self._free_blocks),
            "live": len(live_blocks),
            "total": self.num_blocks - 1,
        }

    def _dispatch_inputs(self):
        if self._dirty_active:
            self._active_dev = torch.tensor(self._active_mask, device=self.device)
            self._dirty_active = False
        if self._dirty_table:
            self._table_dev = torch.tensor(self.table, device=self.device)
            self._dirty_table = False
        if self._dirty_sampling:
            self._sampling_dev = tuple(
                torch.tensor(a, device=self.device) for a in (self.temp, self.top_k, self.top_p)
            )
            self._dirty_sampling = False
        return self._active_dev, self._table_dev, self._sampling_dev

    # ---- admission ----------------------------------------------------
    def _prefill_one(self, prompt: torch.Tensor, last_pos: int):
        """Prefill one padded prompt [1, bucket] into a fresh dense cache;
        returns (last-token logits [1, V] f32, cache)."""
        cache = init_cache(self.cfg, 1, prompt.shape[1], self.device)
        return forward_prefill(self.params, prompt, cache, last_pos=last_pos)

    def _insert(self, slot_k, slot_v, block_ids, slot: int, plen: int, first,
                k_scale=None, v_scale=None) -> None:
        paged_insert(self.cache, slot_k, slot_v, block_ids, k_scale, v_scale)
        self.pos_b[slot] = plen
        self.tokens[slot] = first

    def _assign_sampling(self, slot: int, temperature, top_k, top_p, seed) -> torch.Generator:
        """Write the slot's sampling params and return its request stream."""
        self.temp[slot] = temperature
        self.top_k[slot] = top_k
        self.top_p[slot] = top_p
        self._dirty_sampling = True
        if temperature > 0.0:
            self._sampled_active += 1
        if seed is None:
            # Unseeded sampling must be nondeterministic: process entropy.
            seed = int.from_bytes(os.urandom(8), "little") >> 1
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _sample_first_token(self, logits, gen, slot: int, temperature, top_k, top_p):
        """Sample the post-prefill token from the request's stream and park
        the stream on the slot. Returns a 0-d int32 device tensor."""
        dev = self.device
        first = sample_logits_per_slot(
            logits, [gen],
            torch.tensor([temperature], dtype=torch.float32, device=dev),
            torch.tensor([top_k], dtype=torch.int32, device=dev),
            torch.tensor([top_p], dtype=torch.float32, device=dev),
        )[0]
        self._gens[slot] = gen
        return first

    def _finish_admission(self, req: PagedRequest, first) -> int:
        req.tokens.append(int(first))
        if req.done:
            self._completed[req.request_id] = req
            self._release(req)
        else:
            self._active[req.slot] = req
            self._active_mask[req.slot] = True
            self._dirty_active = True
        return req.request_id

    def _retire(self, slot: int, req: PagedRequest) -> None:
        """Move a finished request out of the active set and return its
        resources. Idempotent: a request already retired by an earlier
        chunk's commit is not released twice."""
        self._completed[req.request_id] = req
        if self._active.get(slot) is not req:
            return
        del self._active[slot]
        self._active_mask[slot] = False
        self._dirty_active = True
        self._release(req)

    @torch.no_grad()
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: Optional[int] = None,
    ) -> Optional[int]:
        """Admit a request; returns its id, or None when out of slots or out
        of pool blocks (the density backpressure signal). The first token is
        sampled before this returns."""
        if not self._free_slots and self._pipeline:
            # In-flight completions may be about to free a slot.
            self._pipeline.flush()
        if not self._free_slots:
            return None
        plen = len(prompt)
        if plen + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        # Power-of-two length bucket, floored at one block so the prefill
        # scatter is block-aligned.
        bucket = self.block_size
        while bucket < plen:
            bucket *= 2
        bucket = min(bucket, self.max_len)
        footprint = max(bucket, plen + max_new_tokens)
        n_blocks = -(-footprint // self.block_size)
        if n_blocks > len(self._free_blocks) and self._pipeline:
            self._pipeline.flush()  # in-flight completions may free blocks
        if n_blocks > len(self._free_blocks):
            return None
        slot = self._free_slots.pop(0)
        blocks = [self._free_blocks.popleft() for _ in range(n_blocks)]
        req = PagedRequest(
            next(self._ids), np.asarray(prompt), max_new_tokens, slot=slot,
            blocks=blocks, temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
        gen = self._assign_sampling(slot, temperature, top_k, top_p, seed)
        self.table[slot] = 0
        self.table[slot, :n_blocks] = blocks
        self._dirty_table = True

        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = prompt
        logits, slot_cache = self._prefill_one(
            torch.from_numpy(padded).to(self.device), plen - 1
        )
        first = self._sample_first_token(logits, gen, slot, temperature, top_k, top_p)
        prefill_ids = torch.tensor(blocks[: bucket // self.block_size], device=self.device)
        scales = ((slot_cache.k_scale[:, 0], slot_cache.v_scale[:, 0])
                  if self.cfg.kv_quant else ())
        self._insert(slot_cache.k[:, 0], slot_cache.v[:, 0], prefill_ids, slot, plen, first,
                     *scales)
        return self._finish_admission(req, first)

    def _release(self, req: PagedRequest) -> None:
        self.table[req.slot] = 0  # dead writes + stale reads -> null block
        self._dirty_table = True
        if req.temperature > 0.0:
            self._sampled_active -= 1
        self._free_blocks.extend(req.blocks)
        req.blocks = []
        self._free_slots.append(req.slot)

    # ---- decode -------------------------------------------------------
    def step(self) -> None:
        """One decode step across every active slot."""
        self.step_n(1)

    def _completion_bound(self) -> int:
        """Steps until the soonest completion or length overflow."""
        return min(remaining_steps(r, self.max_len) for r in self._active.values())

    @torch.no_grad()
    def step_n(self, n: int) -> int:
        """Up to n decode steps launched back to back, pipelined: the chunk's
        tokens are pushed onto the in-flight ring and committed on a later
        call (or flush). Clamped to min(n, the completion bound minus the
        steps in flight, 32) and floored to a power of two; tokens and
        positions advance only where a slot is active. Returns the number of
        steps launched."""
        if n <= 0:
            return 0
        if not self._active:
            self._pipeline.flush()
            return 0
        bound = self._completion_bound() - self._pipeline.inflight_steps()
        if bound < 1:
            self._pipeline.flush()  # consume; retires re-clamp the bound
            if not self._active:
                return 0
            bound = self._completion_bound()
        n = min(n, max(1, bound), 32)
        n = 1 << (n.bit_length() - 1)
        with self._pipeline.host_section():
            active, table, (temp, top_k, top_p) = self._dispatch_inputs()
            sample = self._sampled_active > 0
            tokens, pos_b, cache = self.tokens, self.pos_b, self.cache
            toks = []
            for _ in range(n):
                logits, cache = forward_decode_paged(self.params, tokens, cache, table, pos_b)
                if sample:
                    # Each slot advances its own stream; inactive slots too
                    # (harmless: a new occupant brings its own generator).
                    nxt = sample_logits_per_slot(logits, self._gens, temp, top_k, top_p)
                else:  # all-greedy batch: plain argmax
                    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                tokens = torch.where(active, nxt, tokens)
                pos_b = torch.where(active, pos_b + 1, pos_b)
                toks.append(tokens)
            self.tokens, self.pos_b = tokens, pos_b
            self.stats["decode_steps"] += n
            # Only requests active at dispatch receive this chunk's tokens.
            snapshot = dict(self._active)

            def commit(host_toks, snapshot=snapshot):  # host_toks [n, slots]
                for slot, req in snapshot.items():
                    req.tokens.extend(int(t) for t in host_toks[:, slot])
                    if req.done or len(req.prompt) + len(req.tokens) >= self.max_len:
                        self._retire(slot, req)

            self._pipeline.push(n, torch.stack(toks), commit)
        return n

    def run_until_drained(self, max_steps: int = 10000) -> None:
        """Decode until every active request completes; the final in-flight
        chunks are flushed."""
        for _ in range(max_steps):
            if not self._active:
                self._pipeline.flush()
                return
            self.step_n(32)  # step_n clamps to the completion bound itself
        raise RuntimeError("engine did not drain")

    def result(self, request_id: int) -> Optional[list[int]]:
        req = self._completed.get(request_id)
        if req is None and self._pipeline:
            # The request may have finished inside an unconsumed chunk; flush
            # only when it could have.
            live = next(
                (r for r in self._active.values() if r.request_id == request_id), None
            )
            if live is None or (
                remaining_steps(live, self.max_len) <= self._pipeline.inflight_steps()
            ):
                self._pipeline.flush()
                req = self._completed.get(request_id)
        return list(req.tokens) if req is not None else None
