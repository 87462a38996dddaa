"""Paged continuous batching: the port of the PagedBatchEngine
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
running tokens, speculative history) is updated in place or replaced in
stream order; the host keeps the truth for allocation, budgets and results.

Three serving modes, each off by default as in the JAX engine:
  * `prefix_cache=True`: full prompt blocks are content-addressed by a
    position-binding hash chain; a prompt that shares a block-aligned prefix
    with an earlier one reuses its blocks and prefills only the suffix.
    Shared blocks are refcounted; at refcount 0 they park in an LRU (still
    mapped) and are evicted only when allocation needs them. Two more tiers
    sit behind the pool (HBM): `host_arena` (a KVHostArena) receives each
    evicted block's K/V, and `remote_prefix` (a RemotePrefixSource) fetches
    blocks from a sibling over the KV wire; a prefix-map miss restores the
    block from the first tier that holds it instead of recomputing it. The
    blocks travel in the wire's `pack_payload` format;
  * `prefill_chunk=C`: a prompt longer than C is prefilled C tokens at a
    time into a dense cache, with `interleave_steps` decode steps for the
    active slots between chunks; the slot's table row stays on the null
    block until the commit scatters the dense rows into its blocks;
  * speculative decoding (`run_until_drained_speculative`): each greedy
    slot drafts gamma tokens by prompt lookup from its device history ring,
    one verify pass scores every slot's run, and acceptance and the commit
    run on the device; dispatches ride the ring like step_n's chunks.
    `step_speculative_sync` is the host-loop oracle it is held to.

On CUDA every one-shot prefill runs the flash kernel and every decode step
the paged-decode kernel (its int8 entry over an int8 pool when
cfg.kv_quant); with quantized weights the products of at most 256 rows run
the int8_matmul kernel (verify passes, suffix and chunk prefills included).
The suffix, chunk and verify attention is stock torch, as JAX leaves it to
XLA. A build or launch failure raises. There is no fallback path. With
cfg.kv_quant the pool holds int8 K/V with per-(token, kv head) scales, and
admission scatters the prefill cache's int8 values and scales into it
unchanged. Left out: mesh/TP (`mesh`, with the multi-GPU slice), donation
knobs (`donate_steps`: PyTorch updates the pool in place), the kernel probe
and its fallback, and the /debug/prefixes advertisement.

Telemetry rides the JAX engine's seams with its names and labels: each
request's SLO timeline (queue wait at slot acquisition, first token at
admission, one ITL observation per committed chunk, finish at retire), the
`serve.admission` / `serve.prefill` / `serve.decode_dispatch` /
`serve.spec_verify` spans, `serving_*` counters, histograms and gauges
(requests, admission and dispatch durations, active slots, pool blocks by
state, prefix-cache hits by tier, misses and evictions, restored bytes,
speculative tokens), `compile_site`s around every dispatch seam, the
weights and kv pool bytes, and the bytes of each dirty dispatch-input
upload. Telemetry is per dispatch, never per token.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.core import metrics, slo, trace
from lws_tpu_torch.models.llama import (
    KVCache,
    Llama,
    LlamaConfig,
    forward_decode_paged,
    forward_prefill,
    forward_prefill_chunk,
    forward_verify_paged,
    forward_with_cache,
    init_cache,
    init_paged_cache,
    ngram_draft,
    paged_insert,
    speculative_accept,
)
from lws_tpu_torch.models.quant import quantized_bytes
from lws_tpu_torch.obs import device as devicemod
from lws_tpu_torch.serving import kv_host_arena
from lws_tpu_torch.serving.engine import Engine, sample_logits_per_slot
from lws_tpu_torch.serving.kv_transport import host_array, to_tensor
from lws_tpu_torch.serving.pipeline import DecodePipeline, remaining_steps


def pow2_rows(n: int, floor: int) -> int:
    """The least power-of-two multiple of `floor` (a power of two) that
    holds n rows."""
    rows = floor
    while rows < n:
        rows *= 2
    return rows


def admission_route(plen: int, hit_len: int, block_size: int, max_len: int,
                    prefill_chunk: Optional[int]) -> tuple[str, int, int]:
    """The prefill that admitting a `plen`-token prompt with `hit_len`
    cached tokens runs: (route, rows of each forward, forwards).
      * "chunked" when more than one chunk is left to compute: forwards of
        prefill_chunk rows;
      * "one-shot" on a miss: the prompt's bucket, a power of two of at
        least one block, capped at max_len;
      * "suffix" on a hit: the suffix in its own power-of-two bucket of at
        least 8 rows, whose padding lands in the dense view's scratch tail.
    """
    s_true = plen - hit_len
    if prefill_chunk is not None and s_true > prefill_chunk:
        return "chunked", prefill_chunk, -(-s_true // prefill_chunk)
    if not hit_len:
        return "one-shot", min(pow2_rows(plen, block_size), max_len), 1
    return "suffix", pow2_rows(s_true, 8), 1


@dataclass
class PagedRequest:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    tokens: list[int] = field(default_factory=list)
    slot: int = -1
    blocks: list[int] = field(default_factory=list)
    # Prefix caching: blocks shared through the prefix map (released by
    # refcount), a subset of `blocks`; the rest return to the free list.
    shared_blocks: list[int] = field(default_factory=list)
    # Per-request sampling: temperature <= 0 is greedy; seed pins the
    # request's generator for reproducible sampling.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    # Per-request SLO timeline (queue wait / TTFT / ITL; core/slo.py).
    slo: "slo.RequestTimeline | None" = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class PagedBatchEngine:
    """Slot-based continuously-batched engine over a paged KV pool, with
    per-request sampling (greedy by default), and optionally prefix
    caching, chunked-prefill admission and speculative decoding."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Llama,
        slots: int = 8,
        max_len: int = 512,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = False,
        prefill_chunk: Optional[int] = None,
        interleave_steps: int = 8,
        pipeline_depth: Optional[int] = None,
        spec_history: Optional[int] = None,
        host_arena: Optional[kv_host_arena.KVHostArena] = None,
        remote_prefix=None,
        device: DeviceLike = None,
    ):
        """`device` defaults to CUDA (raising without a GPU); `params` must
        already live there. `pipeline_depth` defaults to 2 in-flight decode
        chunks on CUDA and 0 (synchronous) on the CPU, where launches are
        not asynchronous and a ring buys nothing. `prefill_chunk` must be a
        power of two of at least one block, so every bucket is a whole
        number of chunks. `spec_history` is the per-slot token window the
        device drafter searches (default max_len, the whole context). With
        prefix_cache, `host_arena` (default: kv_host_arena.from_env(), None
        unless LWS_TPU_KV_HOST_ARENA_MB is set) receives evicted prefix
        blocks and `remote_prefix` (a kv_transport.RemotePrefixSource, or
        set later by set_remote_prefix) fetches them from siblings. The JAX
        engine's `mesh` comes with the multi-GPU slice; `donate_steps` has
        no counterpart (the pool is updated in place)."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type or (
            self.device.index is not None and params.device != self.device
        ):
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        if params.cfg != cfg:
            raise ValueError("params were built for another LlamaConfig")
        if max_len % block_size:
            raise ValueError("max_len must be a multiple of block_size")
        if prefill_chunk is not None and (
            prefill_chunk < block_size or prefill_chunk & (prefill_chunk - 1)
        ):
            raise ValueError("prefill_chunk must be a power of two >= block_size")
        self.spec_history = spec_history if spec_history is not None else max_len
        if self.spec_history < 2:
            raise ValueError("spec_history must be >= 2")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        self.prefill_chunk = prefill_chunk
        self.interleave_steps = interleave_steps
        # Default pool = dense equivalent (+ the null block); callers shrink
        # it for density.
        self.num_blocks = num_blocks if num_blocks is not None else slots * self.max_blocks + 1
        self._ids = itertools.count()
        self._free_slots = list(range(slots))
        # FIFO: allocation pops from the left, release appends on the right.
        self._free_blocks = collections.deque(range(1, self.num_blocks))  # 0 = null
        self._active: dict[int, PagedRequest] = {}
        self._completed: dict[int, PagedRequest] = {}
        # Prefix caching (host truth): digest <-> block maps, refcounts of
        # shared blocks, and the refcount-0 blocks parked in LRU order.
        self.prefix_cache = prefix_cache
        self._prefix_map: dict[bytes, int] = {}
        self._block_digest: dict[int, bytes] = {}
        self._block_refs: dict[int, int] = {}
        self._lru: dict[int, None] = {}
        self.stats_prefix = {"hit_tokens": 0, "hit_blocks": 0, "evictions": 0,
                             "spills": 0, "host_hits": 0, "remote_hits": 0}
        self._host_arena = host_arena
        if prefix_cache and host_arena is None:
            self._host_arena = kv_host_arena.from_env()
        self._remote_prefix = remote_prefix
        # A request mid-chunked-admission holds blocks but is not active yet:
        # pool_accounting counts its blocks live.
        self._admitting: Optional[PagedRequest] = None

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
        self._pipeline = DecodePipeline(depth=pipeline_depth, engine="paged")
        # Host-built dispatch inputs, re-uploaded only after admission or
        # release changed them. A rebuild makes a new tensor: in-flight
        # chunks keep the one they were launched with.
        self._active_mask = np.zeros((slots,), bool)
        self._active_dev: Optional[torch.Tensor] = None
        self._table_dev: Optional[torch.Tensor] = None
        self._sampling_dev: Optional[tuple[torch.Tensor, ...]] = None
        self._dirty_active = self._dirty_table = self._dirty_sampling = True
        self._sampled_active = 0  # live requests with temperature > 0
        # Device speculative state: each slot's token history ring (global
        # token t at column t % spec_history), its length and remaining
        # budget. Speculative dispatches keep them current; plain step_n
        # dispatches stale them (_spec_fresh) and the next speculative
        # entry rebuilds them from host truth.
        self._hist = torch.zeros(slots, self.spec_history, dtype=torch.int32, device=dev)
        self._hist_len = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._rem = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._spec_fresh = False
        self.stats = {
            "attention_path": "kernel" if dev.type == "cuda" else "plain",
            "decode_steps": 0,
            "chunked_admissions": 0,
            "interleaved_decode_steps": 0,
            "spec_dispatches": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "spec_fallback_dispatches": 0,
        }
        # HBM attribution (obs/device.py): the two big pools this engine
        # owns, published as serving_hbm_pool_bytes{pool} on the refresh
        # (workspace is the allocator residual).
        devicemod.set_pool_bytes("weights", quantized_bytes(params))
        devicemod.set_pool_bytes("kv", sum(
            t.nbytes for t in (self.cache.k, self.cache.v, self.cache.k_scale,
                               self.cache.v_scale) if t is not None))
        self._update_pool_gauges()  # capacity gauges valid from the start

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: free, and parked ones (evicted on demand)."""
        return len(self._free_blocks) + len(self._lru)

    @property
    def active_count(self) -> int:
        return len(self._active)

    def pool_accounting(self) -> dict[str, int]:
        """Block-pool counts. `live` is computed from the blocks requests
        hold (a request mid-chunked-admission included), so free + parked +
        live == num_blocks - 1 (block 0 being the null block) detects a
        leaked or double-counted block."""
        live_blocks: set[int] = set()
        for req in self._active.values():
            live_blocks.update(req.blocks)
        if self._admitting is not None:
            live_blocks.update(self._admitting.blocks)
        return {
            "free": len(self._free_blocks),
            "parked": len(self._lru),
            "live": len(live_blocks),
            "total": self.num_blocks - 1,
        }

    def _dispatch_inputs(self):
        """Device copies of the host-built inputs, rebuilt only when dirty.
        Each upload copies the host array (torch.tensor, never
        torch.from_numpy): an aliased CPU tensor would let the next
        admission or release change an input a pending chunk still reads."""
        if self._dirty_active:
            self._active_dev = torch.tensor(self._active_mask, device=self.device)
            self._dirty_active = False
            devicemod.record_transfer("paged.dispatch_inputs", self._active_mask.nbytes)
        if self._dirty_table:
            self._table_dev = torch.tensor(self.table, device=self.device)
            self._dirty_table = False
            devicemod.record_transfer("paged.dispatch_inputs", self.table.nbytes)
        if self._dirty_sampling:
            self._sampling_dev = tuple(
                torch.tensor(a, device=self.device) for a in (self.temp, self.top_k, self.top_p)
            )
            self._dirty_sampling = False
            devicemod.record_transfer(
                "paged.dispatch_inputs",
                self.temp.nbytes + self.top_k.nbytes + self.top_p.nbytes)
        return self._active_dev, self._table_dev, self._sampling_dev

    def _update_pool_gauges(self) -> None:
        acct = self.pool_accounting()
        for state in ("free", "live", "parked"):
            metrics.set(
                "serving_kv_pool_blocks", acct[state],
                {"engine": "paged", "state": state},
            )

    def _set_table(self, slot: int, blocks: list[int]) -> None:
        self.table[slot] = 0
        self.table[slot, :len(blocks)] = blocks
        self._dirty_table = True

    # ---- prefix caching -----------------------------------------------
    def set_remote_prefix(self, source) -> None:
        """Wire (or clear) the remote tier after construction."""
        self._remote_prefix = source

    def _block_digests(self, prompt: np.ndarray, n: int) -> list[bytes]:
        """Position-binding hash chain over the first n full blocks: block
        i's digest commits to every token in [0, (i+1)*bs), so equal digests
        mean equal tokens at equal positions, which is when K/V match (RoPE
        binds position). Byte-identical to the JAX engine's chain."""
        bs = self.block_size
        d = b"\x00" * 16
        out = []
        for i in range(n):
            chunk = np.ascontiguousarray(prompt[i * bs:(i + 1) * bs], dtype=np.int32)
            d = hashlib.blake2b(d + chunk.tobytes(), digest_size=16).digest()
            out.append(d)
        return out

    def _alloc_blocks(self, n: int) -> Optional[list[int]]:
        """Allocate n pool blocks, evicting LRU-parked prefix blocks on
        demand (unmapping their digests). Returns None when the pool cannot
        supply n, checked up front so a refused request evicts nothing."""
        if self._pipeline and n > len(self._free_blocks):
            # Consume the ring before evicting: retires may return enough
            # private blocks, and no dispatch still in flight can then touch
            # a block this allocation hands out again.
            self._pipeline.flush()
        if n > len(self._free_blocks) + len(self._lru):
            return None
        out: list[int] = []
        while len(out) < n:
            if self._free_blocks:
                out.append(self._free_blocks.popleft())
                continue
            blk = next(iter(self._lru))
            del self._lru[blk]
            digest = self._block_digest.pop(blk, None)
            # Unmap only if the digest still points at this block.
            if digest is not None and self._prefix_map.get(digest) == blk:
                del self._prefix_map[digest]
                # Spill instead of drop: the flush above means no chunk in
                # flight can still write this block, so the copy sees its
                # final contents.
                if self._host_arena is not None:
                    self._spill_block(blk, digest)
            self._block_refs.pop(blk, None)
            self.stats_prefix["evictions"] += 1
            metrics.inc("serving_prefix_cache_evictions_total", {"engine": "paged"})
            out.append(blk)
        return out

    def _spill_block(self, blk: int, digest: bytes) -> None:
        """An evicted parked block's pool rows -> the host arena, in the KV
        wire's format. Eviction proceeds the same whether the arena took
        the entry or dropped it as oversized."""
        names = ("k", "v", "k_scale", "v_scale") if self.cfg.kv_quant else ("k", "v")
        if self._host_arena.put(digest, {n: host_array(getattr(self.cache, n)[:, blk])
                                         for n in names}):
            self.stats_prefix["spills"] += 1

    def _restore_block(self, digest: bytes, arrays: dict) -> Optional[int]:
        """Upload one spilled or fetched block ([L, bs, Hkv(, hd)] arrays)
        into a freshly allocated pool block, map its digest and take this
        admission's ref on it (released by refcount, like an HBM hit).
        None when the pool cannot supply a block: the caller's hit chain
        ends there."""
        got = self._alloc_blocks(1)
        if got is None:
            return None
        blk = got[0]
        rows = {n: to_tensor(a, self.device) for n, a in arrays.items()}
        scales = (rows["k_scale"], rows["v_scale"]) if self.cfg.kv_quant else ()
        paged_insert(self.cache, rows["k"], rows["v"],
                     torch.tensor([blk], device=self.device), *scales)
        self._prefix_map[digest] = blk
        self._block_digest[blk] = digest
        self._block_refs[blk] = self._block_refs.get(blk, 0) + 1
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        metrics.inc("serving_kv_spill_bytes_total", {"direction": "restore"},
                    value=float(nbytes))
        devicemod.record_transfer("paged.kv_restore", nbytes)
        return blk

    def _dense_view(self, block_ids: torch.Tensor, pad: int, hit_len: int) -> KVCache:
        """A gathered COPY of pool blocks `block_ids` as a dense [L, 1,
        bucket + pad] cache at pos = hit_len: the hit blocks carry the
        cached prefix K/V, the new blocks garbage the suffix overwrites, and
        the `pad` rows past bucket a scratch tail the scatter drops. A copy,
        so decodes interleaved with a chunked admission cannot change it."""
        L = self.cfg.n_layers
        bucket = block_ids.numel() * self.block_size
        idx = block_ids.long()

        def view(pool):  # [L, NB, bs, ...] -> [L, 1, bucket + pad, ...]
            v = pool[:, idx].reshape(L, 1, bucket, *pool.shape[3:])
            return torch.cat([v, v.new_zeros((L, 1, pad, *pool.shape[3:]))], dim=2)

        c = self.cache
        return KVCache(k=view(c.k), v=view(c.v), pos=hit_len,
                       k_scale=None if c.k_scale is None else view(c.k_scale),
                       v_scale=None if c.v_scale is None else view(c.v_scale))

    def _scatter_dense(self, dense: KVCache, block_ids: torch.Tensor, slot: int,
                       plen: int) -> None:
        """Scatter a filled dense cache's first bucket rows into pool blocks
        `block_ids` and commit the slot's position. Rows past the prompt
        carry padding garbage, masked by position and overwritten by decode
        appends."""
        bucket = block_ids.numel() * self.block_size
        scales = ((dense.k_scale[:, 0, :bucket], dense.v_scale[:, 0, :bucket])
                  if dense.k_scale is not None else ())
        paged_insert(self.cache, dense.k[:, 0, :bucket], dense.v[:, 0, :bucket], block_ids,
                     *scales)
        self.pos_b[slot] = plen

    def _insert_with_prefix(self, suffix: torch.Tensor, block_ids: torch.Tensor, hit_len: int,
                            last_off: int, slot: int, plen: int) -> torch.Tensor:
        """Prefix-hit admission: the suffix [1, s] through forward_with_cache
        over the slot's gathered blocks at pos = hit_len, scattered back.
        Returns the last true token's logits [1, V]. The hit blocks are
        rewritten with the bytes they hold."""
        dense = self._dense_view(block_ids, suffix.shape[1], hit_len)
        logits, dense = forward_with_cache(self.params, suffix, dense, last_offset=last_off)
        self._scatter_dense(dense, block_ids, slot, plen)
        return logits

    def _chunk_logits(self, hidden: torch.Tensor, last_off: int) -> torch.Tensor:
        """lm_head logits [1, V] f32 of row `last_off` of a chunk's
        normalized hidden states [1, C, D]."""
        return self.params.head(hidden[:, last_off])

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

    def _sample_first_token(self, logits, gen, req: PagedRequest):
        """Sample the post-prefill token from the request's stream and park
        the stream on the slot. Returns a 0-d int32 device tensor."""
        dev = self.device
        first = sample_logits_per_slot(
            logits, [gen],
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
        )[0]
        self._gens[req.slot] = gen
        return first

    def _finish_admission(self, req: PagedRequest, first) -> int:
        req.tokens.append(int(first))
        if req.slo is not None:
            # The prefill token in hand marks TTFT on the arrival clock
            # (queue wait was recorded at slot acquisition).
            req.slo.first_token()
        if req.done:
            if req.slo is not None:
                req.slo.finish()
            self._completed[req.request_id] = req
            self._release(req)
        else:
            self._active[req.slot] = req
            self._active_mask[req.slot] = True
            self._dirty_active = True
            if self._spec_fresh:
                # Admission during speculation: this request's host truth is
                # exact now, so its device rows are written directly, with
                # no ring flush and no full rebuild.
                self._seed_spec_slot(req)
        return req.request_id

    def _retire(self, slot: int, req: PagedRequest) -> None:
        """Move a finished request out of the active set and return its
        resources. Idempotent: a request already retired by an earlier
        chunk's commit is not released twice."""
        if req.slo is not None:
            req.slo.finish()  # idempotent: a later duplicate retire is a no-op
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
        klass: str = "",
        arrival_t: Optional[float] = None,
    ) -> Optional[int]:
        """Admit a request; returns its id, or None when out of slots or out
        of pool blocks (the density backpressure signal). The first token is
        sampled before this returns. With prefix_cache, resident
        block-aligned prefixes are reused and only the suffix is prefilled;
        with prefill_chunk, a longer prompt is prefilled in chunks with
        decode steps for the active slots between them. `klass` labels the
        request's SLO/goodput series by workload class; `arrival_t` (a
        time.perf_counter() stamp) backdates the SLO arrival clock, so
        open-loop admission delay shows up as queue wait."""
        t0 = time.perf_counter()
        timeline = slo.request("paged", arrival_t, klass=klass)
        with trace.span("serve.admission", engine="paged", prompt_len=len(prompt)) as sp:
            rid = self._submit(prompt, max_new_tokens, (temperature, top_k, top_p, seed),
                               timeline)
            sp.set(admitted=rid is not None)
        if rid is not None:
            metrics.inc("serving_requests_total", {"engine": "paged"})
            metrics.observe("serving_admission_duration_seconds",
                            time.perf_counter() - t0, {"engine": "paged"})
            metrics.set("serving_active_slots", len(self._active), {"engine": "paged"})
        # Unconditional: a refused admission may still have flushed the ring
        # (retiring requests) or evicted parked blocks.
        self._update_pool_gauges()
        return rid

    def _submit(self, prompt: np.ndarray, max_new_tokens: int, sampling: tuple,
                timeline: "slo.RequestTimeline") -> Optional[int]:
        if not self._free_slots and self._pipeline:
            # In-flight completions may be about to free a slot.
            self._pipeline.flush()
        if not self._free_slots:
            return None
        prompt = np.asarray(prompt)
        plen = len(prompt)
        if plen + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        # Power-of-two length bucket, floored at one block so the prefill
        # scatter is block-aligned.
        bucket = min(pow2_rows(plen, self.block_size), self.max_len)
        footprint = max(bucket, plen + max_new_tokens)
        n_blocks = -(-footprint // self.block_size)
        if self.prefix_cache:
            return self._submit_prefix(prompt, max_new_tokens, sampling, bucket, n_blocks,
                                       timeline)
        if n_blocks > len(self._free_blocks) and self._pipeline:
            self._pipeline.flush()  # in-flight completions may free blocks
        if n_blocks > len(self._free_blocks):
            return None
        blocks = [self._free_blocks.popleft() for _ in range(n_blocks)]
        req, gen = self._new_request(prompt, max_new_tokens, sampling, blocks, timeline)
        if admission_route(plen, 0, self.block_size, self.max_len,
                           self.prefill_chunk)[0] == "chunked":
            first = self._admit_chunked(req, gen, bucket, 0, None)
        else:
            first = self._admit_one_shot(req, gen, bucket)
        return self._finish_admission(req, first)

    def _new_request(self, prompt, max_new_tokens, sampling, blocks, timeline, shared=()):
        """Take a free slot for a request holding `blocks`; returns it with
        its sampling stream. The slot ends the request's queue wait."""
        temperature, top_k, top_p, seed = sampling
        slot = self._free_slots.pop(0)
        timeline.queue_wait()  # arrival -> slot (includes any ring flushes)
        req = PagedRequest(
            next(self._ids), prompt, max_new_tokens, slot=slot, blocks=blocks,
            shared_blocks=list(shared), temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed, slo=timeline,
        )
        return req, self._assign_sampling(slot, temperature, top_k, top_p, seed)

    def _admit_one_shot(self, req: PagedRequest, gen, bucket: int):
        """The whole padded prompt through forward_prefill (flash on CUDA)
        into a fresh dense cache, scattered into the slot's blocks."""
        plen, slot = len(req.prompt), req.slot
        self._set_table(slot, req.blocks)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = req.prompt
        with trace.span("serve.prefill", chunked=False, prompt_len=plen), \
                devicemod.compile_site("paged.prefill", engine="paged", shape=f"b{bucket}",
                                       request_id=req.slo.request_id if req.slo else ""):
            logits, slot_cache = self._prefill_one(torch.tensor(padded, device=self.device),
                                                   plen - 1)
            first = self._sample_first_token(logits, gen, req)
            prefill_ids = torch.tensor(req.blocks[: bucket // self.block_size],
                                       device=self.device)
            scales = ((slot_cache.k_scale[:, 0], slot_cache.v_scale[:, 0])
                      if self.cfg.kv_quant else ())
            self._insert(slot_cache.k[:, 0], slot_cache.v[:, 0], prefill_ids, slot, plen, first,
                         *scales)
        return first

    def _submit_prefix(self, prompt, max_new_tokens, sampling, bucket: int,
                       n_blocks: int, timeline: "slo.RequestTimeline") -> Optional[int]:
        bs = self.block_size
        plen = len(prompt)
        # Never cache the whole prompt: at least one token is computed, so
        # the first-token logits exist.
        shareable_n = (plen - 1) // bs
        digests = self._block_digests(prompt, shareable_n)
        # The tiered hit walk, in digest-chain order: the pool (hbm), then the
        # host arena, then a sibling (remote); the first digest no tier holds
        # ends the chain. Each hit is pinned as the walk reaches it, so a
        # restore's allocation (which may evict) or the allocation below
        # cannot take it; a failed allocation rolls every pin back.
        hits: list[int] = []
        tiers: list[str] = []
        remote_found: Optional[dict] = None
        for i, d in enumerate(digests):
            blk = self._prefix_map.get(d)
            if blk is not None:
                if self._block_refs.get(blk, 0) == 0:
                    self._lru.pop(blk, None)
                self._block_refs[blk] = self._block_refs.get(blk, 0) + 1
                tiers.append("hbm")
                hits.append(blk)
                continue
            tier = "host"
            arrays = self._host_arena.get(d) if self._host_arena is not None else None
            if arrays is None:
                if self._remote_prefix is not None and remote_found is None:
                    # One fetch per admission for the whole remaining chain.
                    remote_found = self._remote_prefix.fetch(digests[i:]) or {}
                tier, arrays = "remote", (remote_found or {}).get(d)
                if arrays is None:
                    break
            blk = self._restore_block(d, arrays)  # pinned by the restore
            if blk is None:
                break  # the pool is exhausted: the chain ends here
            tiers.append(tier)
            hits.append(blk)
        hit_len = len(hits) * bs
        new_blocks = self._alloc_blocks(n_blocks - len(hits))
        if new_blocks is None:
            for blk in hits:  # backpressure: unpin and park again
                self._unref(blk)
            return None
        blocks = hits + new_blocks
        req, gen = self._new_request(prompt, max_new_tokens, sampling, blocks, timeline, hits)
        route, s_suf, _ = admission_route(plen, hit_len, bs, self.max_len, self.prefill_chunk)
        if route == "chunked":
            dense = None
            if hits:
                # The hit blocks gathered once, padded by one chunk so the
                # final padded chunk cannot overflow the bucket.
                ids = torch.tensor(blocks[: bucket // bs], device=self.device)
                dense = self._dense_view(ids, self.prefill_chunk, hit_len)
            first = self._admit_chunked(req, gen, bucket, hit_len, dense)
        elif route == "one-shot":
            first = self._admit_one_shot(req, gen, bucket)
        else:
            # The suffix in its own bucket of s_suf rows: true rows land in
            # [hit_len, plen) of the view, the padding past bucket in the
            # scratch tail the scatter drops.
            self._set_table(req.slot, blocks)
            s_true = plen - hit_len
            suffix = np.zeros((1, s_suf), np.int64)
            suffix[0, :s_true] = prompt[hit_len:]
            with trace.span("serve.prefill", chunked=False, prompt_len=plen,
                            prefix_hit_tokens=hit_len), \
                    devicemod.compile_site("paged.prefill_suffix", engine="paged",
                                           shape=f"b{bucket}/s{s_suf}",
                                           request_id=timeline.request_id):
                logits = self._insert_with_prefix(
                    torch.tensor(suffix, device=self.device),
                    torch.tensor(blocks[: bucket // bs], device=self.device),
                    hit_len, s_true - 1, req.slot, plen)
                first = self._sample_first_token(logits, gen, req)
                self.tokens[req.slot] = first
        # Register the newly computed shareable blocks (this request holds a
        # ref on each until it completes). A digest already mapped keeps
        # its block; this copy stays private.
        for i in range(len(hits), shareable_n):
            d, blk = digests[i], blocks[i]
            if d in self._prefix_map:
                continue
            self._prefix_map[d] = blk
            self._block_digest[blk] = d
            self._block_refs[blk] = self._block_refs.get(blk, 0) + 1
            req.shared_blocks.append(blk)
        self.stats_prefix["hit_tokens"] += hit_len
        self.stats_prefix["hit_blocks"] += len(hits)
        self.stats_prefix["host_hits"] += tiers.count("host")
        self.stats_prefix["remote_hits"] += tiers.count("remote")
        # Hit-rate counters: hits = shareable blocks served from some tier
        # (labelled hbm/host/remote), misses = shareable blocks this
        # admission had to prefill.
        for tier in ("hbm", "host", "remote"):
            if tiers.count(tier):
                metrics.inc("serving_prefix_cache_hits_total", {"engine": "paged", "tier": tier},
                            value=float(tiers.count(tier)))
        if shareable_n > len(hits):
            metrics.inc("serving_prefix_cache_misses_total", {"engine": "paged"},
                        value=float(shareable_n - len(hits)))
        return self._finish_admission(req, first)

    def _admit_chunked(self, req: PagedRequest, gen, bucket: int, hit_len: int,
                       dense: Optional[KVCache]):
        """Chunked-prefill admission: fill a dense cache chunk by chunk from
        hit_len (a fresh one, or the gathered view of the hit blocks),
        running `interleave_steps` decode steps for the active slots between
        chunks, then commit: sample the first token, map the table row and
        scatter the dense rows into the pool. The slot's table row stays on
        the null block until the commit, so the interleaved decodes' dead
        writes for it land there and not in its new blocks."""
        C = self.prefill_chunk
        plen, slot = len(req.prompt), req.slot
        s_true = plen - hit_len
        n_chunks = -(-s_true // C)
        padded = np.zeros((n_chunks * C,), np.int64)
        padded[:s_true] = req.prompt[hit_len:]
        self._set_table(slot, [])
        self._admitting = req
        try:
            if dense is None:
                # Wide enough for every chunk: when max_len caps the bucket
                # below a power of two, n_chunks * C can exceed it. The
                # scatter takes only the first bucket rows.
                dense = init_cache(self.cfg, 1, max(bucket, n_chunks * C), self.device)
            hidden = None
            with trace.span("serve.prefill", chunked=True, chunks=n_chunks, prompt_len=plen,
                            prefix_hit_tokens=hit_len), \
                    devicemod.compile_site("paged.chunk_prefill", engine="paged",
                                           shape=f"b{bucket}/c{C}",
                                           request_id=req.slo.request_id if req.slo else ""):
                for i in range(n_chunks):
                    chunk = torch.tensor(padded[None, i * C:(i + 1) * C], device=self.device)
                    hidden, dense = forward_prefill_chunk(self.params, chunk, dense)
                    if self._active and self.interleave_steps > 0 and i < n_chunks - 1:
                        self.stats["interleaved_decode_steps"] += self.step_n(
                            self.interleave_steps)
                logits = self._chunk_logits(hidden, (s_true - 1) % C)
                first = self._sample_first_token(logits, gen, req)
                self._set_table(slot, req.blocks)
                ids = torch.tensor(req.blocks[: bucket // self.block_size], device=self.device)
                self._scatter_dense(dense, ids, slot, plen)
                self.tokens[slot] = first
        finally:
            self._admitting = None
        self.stats["chunked_admissions"] += 1
        return first

    def _unref(self, blk: int) -> None:
        """Drop one ref on a shared block; at zero it parks in the LRU with
        its contents and digest mapping intact."""
        self._block_refs[blk] -= 1
        if self._block_refs[blk] <= 0:
            self._block_refs[blk] = 0
            self._lru[blk] = None

    def _release(self, req: PagedRequest) -> None:
        self.table[req.slot] = 0  # dead writes + stale reads -> null block
        self._dirty_table = True
        if req.temperature > 0.0:
            self._sampled_active -= 1
        shared = set(req.shared_blocks)
        for blk in req.blocks:
            if blk in shared:
                self._unref(blk)
            else:
                self._free_blocks.append(blk)
        req.blocks = []
        req.shared_blocks = []
        self._free_slots.append(req.slot)
        metrics.set("serving_active_slots", len(self._active), {"engine": "paged"})
        self._update_pool_gauges()

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
        # Span + histogram per dispatch, never per token.
        t0 = time.perf_counter()
        with trace.span("serve.decode_dispatch", engine="paged", steps=n,
                        active=len(self._active), inflight=len(self._pipeline)):
            # Host-side scheduling window: with chunks in flight it overlaps
            # device compute; with an empty ring it counts as host-blocked.
            with self._pipeline.host_section():
                active, table, (temp, top_k, top_p) = self._dispatch_inputs()
                sample = self._sampled_active > 0
                tokens, pos_b, cache = self.tokens, self.pos_b, self.cache
                toks = []
                with devicemod.compile_site("paged.step_n", engine="paged",
                                            shape=f"n{n}/sample={sample}"):
                    for _ in range(n):
                        logits, cache = forward_decode_paged(self.params, tokens, cache, table,
                                                             pos_b)
                        if sample:
                            # Each slot advances its own stream; inactive slots
                            # too (harmless: a new occupant brings its own
                            # generator).
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
                    if req.slo is not None:
                        # ITL: the per-dispatch mean of this chunk's step gaps.
                        req.slo.tokens(host_toks.shape[0])
                    if req.done or len(req.prompt) + len(req.tokens) >= self.max_len:
                        self._retire(slot, req)

            # Plain decode advanced tokens without the speculative history
            # and budgets: the next speculative entry rebuilds them.
            self._spec_fresh = False
            self._pipeline.push(n, torch.stack(toks), commit)
        metrics.observe("serving_decode_dispatch_duration_seconds",
                        time.perf_counter() - t0, {"engine": "paged"})
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

    # ---- speculative decoding -----------------------------------------
    def _spec_slot_state(self, req: PagedRequest) -> tuple[np.ndarray, int, int]:
        """One slot's device speculative rows from host truth: the history
        window on the ring invariant (global token t at column t % H), the
        total token count and the remaining budget."""
        H = self.spec_history
        ctx = [int(t) for t in req.prompt] + req.tokens
        L = len(ctx)
        W = min(L, H)
        window = np.zeros((H,), np.int32)
        window[np.arange(L - W, L) % H] = ctx[-W:]
        return window, L, remaining_steps(req, self.max_len)

    def _seed_spec_slot(self, req: PagedRequest) -> None:
        """Write one slot's device speculative rows from its admission-time
        host truth, in stream order after every dispatch in flight."""
        window, total, rem = self._spec_slot_state(req)
        self._hist[req.slot] = torch.tensor(window, device=self.device)
        self._hist_len[req.slot] = total
        self._rem[req.slot] = rem

    def _refresh_spec_state(self) -> None:
        """Rebuild every slot's device speculative state from host truth,
        which needs (and performs) a ring flush: entry into speculation
        after plain step_n dispatches, or after a rollback."""
        self._pipeline.flush()
        H = self.spec_history
        hist = np.zeros((self.slots, H), np.int32)
        hlen = np.zeros((self.slots,), np.int32)
        rem = np.zeros((self.slots,), np.int32)
        for s, r in self._active.items():
            hist[s], hlen[s], rem[s] = self._spec_slot_state(r)
        self._hist = torch.tensor(hist, device=self.device)
        self._hist_len = torch.tensor(hlen, device=self.device)
        self._rem = torch.tensor(rem, device=self.device)
        self._spec_fresh = True

    def _rollback_to_host_truth(self) -> None:
        """Restore the device positions and running tokens from host truth
        after in-flight chunks were discarded (pos_b is the pool's rewind:
        rows past it are masked and later overwritten), and mark the device
        speculative state stale."""
        pos = np.zeros((self.slots,), np.int32)
        tok = np.zeros((self.slots,), np.int32)
        for s, r in self._active.items():
            pos[s] = len(r.prompt) + len(r.tokens) - 1
            tok[s] = r.tokens[-1]
        self.pos_b = torch.tensor(pos, device=self.device)
        self.tokens = torch.tensor(tok, device=self.device)
        self._spec_fresh = False

    def _spec_fits(self, S: int, inflight: int) -> bool:
        """Write-safety gate: a verify pass appends S K/V rows per active
        slot, and with the worst-case in-flight commits no row may land at
        or past max_len (a table index past max_len would be clamped onto a
        live block)."""
        return all(
            len(r.prompt) + len(r.tokens) + inflight + S <= self.max_len
            for r in self._active.values()
        )

    def _spec_step(self, active, table, temp, top_k, top_p, sample: bool, gamma: int,
                   ngram: int) -> torch.Tensor:
        """Draft, verify, accept and commit on the device, with no host
        read: each slot drafts from its history ring, one verify pass scores
        every run, the accepted prefix is clamped by the device budget, and
        pos_b, tokens, history and budget advance. Sampled slots verify
        filler drafts (their running token) that never extend acceptance and
        advance one token, sampled from column 0 with one draw of their own
        generator, as step_n draws. Returns the packed [slots, gamma + 2]
        result: column 0 the tokens taken, then the tokens produced."""
        tokens, pos_b = self.tokens, self.pos_b
        hist, hist_len, rem = self._hist, self._hist_len, self._rem
        drafts = ngram_draft(hist, hist_len, ngram, gamma)  # [slots, gamma]
        is_greedy = temp <= 0.0
        tokens_in = torch.cat(
            [tokens[:, None], torch.where(is_greedy[:, None], drafts, tokens[:, None])], dim=1)
        greedy, sampled = self._spec_verify(tokens_in, pos_b, table, temp, top_k, top_p, sample)
        take, out = speculative_accept(torch.where(is_greedy[:, None], drafts, -1), greedy, rem)
        out = torch.where(is_greedy[:, None], out, sampled[:, None].expand_as(out))
        take = torch.where(is_greedy, take, torch.clamp(rem, max=1))
        take = torch.where(active, take, 0)
        last = out.gather(1, torch.clamp(take - 1, min=0)[:, None].long())[:, 0]
        self.tokens = torch.where(take > 0, last, tokens)
        self.pos_b = pos_b + take
        self._rem = rem - take
        i = torch.arange(gamma + 1, device=tokens.device)[None, :]
        idx = (hist_len.long()[:, None] + i) % self.spec_history
        kept = torch.where(i < take[:, None], out, hist.gather(1, idx))
        self._hist = hist.scatter(1, idx, kept)
        self._hist_len = hist_len + take
        return torch.cat([take[:, None], out], dim=1)

    @torch.no_grad()
    def step_speculative(self, gamma: int = 4, ngram: int = 3) -> bool:
        """One device-resident speculative dispatch across every active
        slot, pushed onto the in-flight ring like a step_n chunk; the host
        commits each chunk's packed tokens when it lands. The steady loop
        never flushes: flushes remain at speculation entry, budget and tail
        boundaries, and rollback. Returns False (nothing dispatched) when
        inapplicable: no active slot, no greedy slot, or a slot too close to
        max_len for a full run; the caller then steps plainly."""
        if not self._active:
            self._pipeline.flush()
            return False
        if len(self._active) <= self._sampled_active:
            # No greedy slot to draft for: a (gamma + 1)-wide verify would
            # advance every slot by one token at gamma + 1 times the work.
            return False
        S = gamma + 1
        if S > self.spec_history:
            raise ValueError(f"gamma+1={S} exceeds spec_history={self.spec_history}")
        if not self._spec_fresh:
            self._refresh_spec_state()
            if not self._active or len(self._active) <= self._sampled_active:
                return False
        inflight = self._pipeline.inflight_steps()
        if self._completion_bound() - inflight < 1 or not self._spec_fits(S, inflight):
            # The soonest completion is already in flight, or a verify row
            # could cross max_len in the worst case: consume, then recheck.
            self._pipeline.flush()
            if not self._active or len(self._active) <= self._sampled_active:
                return False
            if not self._spec_fits(S, 0):
                return False  # a genuine tail: the caller single-steps
        t0 = time.perf_counter()
        with trace.span("serve.decode_dispatch", engine="paged", steps=S, speculative=True,
                        active=len(self._active), inflight=len(self._pipeline)), \
                self._pipeline.host_section():
            active, table, (temp, top_k, top_p) = self._dispatch_inputs()
            any_sampled = self._sampled_active > 0
            with devicemod.compile_site("paged.spec_step", engine="paged",
                                        shape=f"g{gamma}/n{ngram}/sample={any_sampled}"):
                packed = self._spec_step(active, table, temp, top_k, top_p, any_sampled, gamma,
                                         ngram)
            snapshot = dict(self._active)
            greedy_slots = {s for s, r in snapshot.items() if r.temperature <= 0}

            def commit(host_packed, snapshot=snapshot, greedy_slots=greedy_slots):
                with trace.span("serve.spec_verify", engine="paged", gamma=gamma) as sp:
                    accepted = drafted = 0
                    for slot, req in snapshot.items():
                        t = int(host_packed[slot, 0])
                        if t <= 0:
                            continue  # budget already spent on the device
                        req.tokens.extend(int(x) for x in host_packed[slot, 1:1 + t])
                        if req.slo is not None:
                            req.slo.tokens(t)
                        if slot in greedy_slots:
                            drafted += gamma
                            accepted += t - 1
                        if req.done or len(req.prompt) + len(req.tokens) >= self.max_len:
                            self._retire(slot, req)
                    sp.set(accepted=accepted, drafted=drafted)
                self.stats["spec_drafted"] += drafted
                self.stats["spec_accepted"] += accepted
                metrics.inc("serving_spec_tokens_total", {"engine": "paged", "kind": "drafted"},
                            value=float(drafted))
                metrics.inc("serving_spec_tokens_total", {"engine": "paged", "kind": "accepted"},
                            value=float(accepted))

            try:
                self._pipeline.push(S, packed, commit)
            except Exception:
                # A chunk whose commit failed or never made the ring leaves
                # device truth ahead of host truth: drop everything in
                # flight, restore device truth from the host, re-raise.
                self._pipeline.discard()
                self._rollback_to_host_truth()
                raise
        metrics.observe("serving_spec_verify_duration_seconds", time.perf_counter() - t0)
        self.stats["spec_dispatches"] += 1
        return True

    def _spec_verify(self, tokens_in, pos, table, temp, top_k, top_p, sample: bool):
        """The verify pass both speculative loops launch: its argmax [slots,
        S] and each slot's column-0 token [slots], sampled from the slot's
        generator when `sample`, else the argmax."""
        all_logits, _ = forward_verify_paged(self.params, tokens_in, self.cache, table, pos)
        greedy = torch.argmax(all_logits, dim=-1).to(torch.int32)
        if sample:
            return greedy, sample_logits_per_slot(all_logits[:, 0], self._gens, temp, top_k,
                                                  top_p)
        return greedy, greedy[:, 0]

    @torch.no_grad()
    def step_speculative_sync(self, gamma: int = 4, ngram: int = 3) -> bool:
        """The host-loop speculative step, the oracle of step_speculative:
        drafts on the host (Engine._draft_ngram), waits for the verify
        pass, accepts on the host and re-uploads positions and tokens. Its
        streams equal step_speculative's token for token."""
        self._pipeline.flush()
        self._spec_fresh = False  # the host commit below bypasses hist/rem
        if not self._active:
            return False
        if all(r.temperature > 0 for r in self._active.values()):
            return False
        S = gamma + 1
        if any(len(r.prompt) + len(r.tokens) + S > self.max_len for r in self._active.values()):
            return False
        tokens_in = np.zeros((self.slots, S), np.int32)
        drafts: dict[int, list[int]] = {}
        pos = np.zeros((self.slots,), np.int32)
        with self._pipeline.host_section():  # host drafting: the device idles
            for s, r in self._active.items():
                if r.temperature <= 0:
                    d = Engine._draft_ngram([int(t) for t in r.prompt] + r.tokens, ngram, gamma)
                else:
                    d = [r.tokens[-1]] * gamma  # never accepted; the slot samples
                drafts[s] = d
                tokens_in[s, 0] = r.tokens[-1]
                tokens_in[s, 1:] = d
                pos[s] = len(r.prompt) + len(r.tokens) - 1
            _, table, (temp, top_k, top_p) = self._dispatch_inputs()
            tokens_dev = torch.tensor(tokens_in, device=self.device)
            pos_dev = torch.tensor(pos, device=self.device)
        t0 = time.perf_counter()
        with trace.span("serve.spec_verify", engine="paged", gamma=gamma,
                        active=len(self._active)):
            with self._pipeline.host_section():
                greedy, sampled = self._spec_verify(tokens_dev, pos_dev, table, temp, top_k,
                                                    top_p, self._sampled_active > 0)
            greedy_h, sampled_h = greedy.cpu().numpy(), sampled.cpu().numpy()
        metrics.observe("serving_spec_verify_duration_seconds", time.perf_counter() - t0)
        self.stats["spec_dispatches"] += 1
        with self._pipeline.host_section():  # host acceptance + commit
            for s, r in list(self._active.items()):
                if r.temperature > 0:
                    new = [int(sampled_h[s])]
                else:
                    d = drafts[s]
                    a = 0
                    while a < gamma and d[a] == int(greedy_h[s, a]):
                        a += 1
                    new = [*map(int, d[:a]), int(greedy_h[s, a])][:r.max_new_tokens - len(r.tokens)]
                    self.stats["spec_drafted"] += gamma
                    self.stats["spec_accepted"] += len(new) - 1
                r.tokens.extend(new)
                if r.slo is not None:
                    r.slo.tokens(len(new))
                if r.done or len(r.prompt) + len(r.tokens) >= self.max_len:
                    self._retire(s, r)
            # Host truth back to the device (rejected draft rows sit past
            # pos_b, masked until overwritten).
            self._rollback_to_host_truth()
        return True

    def run_until_drained_speculative(self, gamma: int = 4, ngram: int = 3,
                                      max_dispatches: int = 10000, sync: bool = False) -> None:
        """Drain with speculative dispatches (`sync=True`: the host-loop
        oracle). When a dispatch is refused: single steps while a greedy
        slot could speculate again (the near-max_len tail), 32-step chunks
        when none can (an all-sampled batch)."""
        step = self.step_speculative_sync if sync else self.step_speculative
        for _ in range(max_dispatches):
            if not self._active:
                self._pipeline.flush()
                return
            if not step(gamma, ngram):
                greedy_alive = any(r.temperature <= 0 for r in self._active.values())
                if self.step_n(1 if greedy_alive else 32):
                    self.stats["spec_fallback_dispatches"] += 1
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
