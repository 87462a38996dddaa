"""Sampling for the port's engines (lws_tpu/serving/engine.py:72-143), the
dense `Engine` (:162-886) and `shard_params_for_serving` (:34).

JAX's threefry keys become `torch.Generator`s: one per request stream (one
per Engine). The two frameworks draw different numbers from the same seed,
so a sampled stream is reproducible inside the port but never equal to
JAX's; greedy (temperature <= 0) is argmax in both and exact.

The Engine serves one batch of equal-length prompts at a time over a dense
KV cache [L, B, max_len, Hkv, hd] (int8 with scales when cfg.kv_quant),
updated in place: prefill through forward_prefill (flash on CUDA), or in
chunks through forward_prefill_chunk (`prefill_chunked`, and
`prefill_chunked_stream`, which hands each chunk's K/V rows to a callback
as they land); decode steps through forward_with_cache (on CUDA with an
int8 cache, the int8 decode kernel; with quantized weights, the int8_matmul
kernel). `generate_speculative` and `decode_speculative` run B = 1 greedy
n-gram speculation with drafting, verification, acceptance and the cache
rewind on the device: the verify pass appends at a device position, so the
loop reads nothing back but each dispatch's packed tokens, and the host
cache.pos is reconciled when the ring is flushed.

With `mesh` (parallel.mesh.Mesh) the Engine serves tensor-parallel: every
rank of the mesh runs it on the same host schedule (SPMD), holding its tp
shard of the weights (shard_params_for_serving) and a cache on its Hkv/tp
KV heads; the batch splits over the dp ranks (rank dp_rank takes rows
[dp_rank*B/dp, (dp_rank+1)*B/dp)) and each step's tokens are gathered back
over dp, so every rank returns the whole batch's tokens. The collectives
are the model's (models/llama.py); `prefill_chunked_stream`, the
disaggregated handoff's producer, gathers each chunk's KV heads over tp on
every rank and emits the single-device engine's rows on tp rank 0.

Telemetry rides the JAX engine's seams with its names and labels: a
`serve.request` span, an SLO timeline (first token after the prefill, one
ITL observation for the decode; a dense request has no queue) and
`serving_active_slots{engine="dense"}` around each generate, `serve.prefill`
and `serve.decode_dispatch` spans, `serve.spec_verify` spans and
`serving_spec_tokens_total` per speculative commit, and
`serving_requests_total` per request.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.core import metrics, slo, trace
from lws_tpu_torch.models.llama import (
    KVCache,
    Llama,
    LlamaConfig,
    forward_prefill,
    forward_prefill_chunk,
    forward_with_cache,
    init_cache,
    ngram_draft,
    shard_params,
    speculative_accept,
)
from lws_tpu_torch.parallel.collectives import gather_heads
from lws_tpu_torch.serving.kv_transport import host_array
from lws_tpu_torch.serving.pipeline import DecodePipeline


def shard_params_for_serving(params: Llama, cfg: LlamaConfig, mesh) -> Llama:
    """The rank's tensor-parallel shard of a full model for serving on
    `mesh` (lws_tpu/serving/engine.py:34): every product, the embedding and
    the lm_head split as param_shardings splits them, int8 scales with
    their output channels (models/llama.py:shard_params). Every rank calls
    it with the same full weights. A model already sharded for `mesh` is
    returned as it is."""
    if params.cfg != cfg:
        raise ValueError("params were built for another LlamaConfig")
    return shard_params(params, mesh)


def check_mesh(cfg: LlamaConfig, mesh) -> None:
    """The engines' refusal of a mesh whose tp does not divide the KV heads,
    and of pp or cp > 1 (serving runs tp and dp; pipeline and context
    parallelism are the training path's)."""
    if mesh.pp > 1 or mesh.cp > 1:
        raise NotImplementedError(f"serving over pp={mesh.pp}, cp={mesh.cp} is not ported")
    if cfg.n_kv_heads % mesh.tp:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={mesh.tp}")


@dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 is greedy; top_k/top_p restrict the candidate set."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32, one batch-wide parameter set."""
    B = logits.shape[0]
    dev = logits.device
    return sample_logits_per_slot(
        logits, [generator] * B,
        torch.full((B,), params.temperature, dtype=torch.float32, device=dev),
        torch.full((B,), params.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), params.top_p, dtype=torch.float32, device=dev),
    )


def mask_logits_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits [B, V] with each slot's top-k mask, then its
    top-p mask on the masked distribution, applied as -inf (the order of
    lws_tpu/serving/engine.py:116-134). top_k 0 (or >= V) and top_p 1.0
    disable their masks; the top-p prefix always keeps at least one token."""
    V = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.long() - 1, 0, V - 1)
    kth = sorted_desc.gather(1, k_idx[:, None])
    use_k = (top_k > 0) & (top_k < V)
    scaled = torch.where(use_k[:, None] & (scaled < kth), neg_inf, scaled)

    sorted_masked = torch.sort(scaled, dim=-1, descending=True).values
    cumulative = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((cumulative < top_p[:, None]).sum(dim=-1), 0, V - 1)
    cutoff = sorted_masked.gather(1, cutoff_idx[:, None])
    use_p = top_p < 1.0
    return torch.where(use_p[:, None] & (scaled < cutoff), neg_inf, scaled)


def sample_logits_per_slot(
    logits: torch.Tensor,                   # [B, V]
    generators: Sequence[torch.Generator],  # one stream per slot
    temperature: torch.Tensor,              # [B] f32; <= 0 means greedy for that slot
    top_k: torch.Tensor,                    # [B] int; 0 disables
    top_p: torch.Tensor,                    # [B] f32; 1.0 disables
) -> torch.Tensor:
    """Per-slot sampling for continuous batching: every slot samples with
    its own request's parameters from its own generator; greedy slots take
    the argmax. Every slot's generator advances by one draw per call, greedy
    or not, as every JAX slot key splits per step."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(mask_logits_per_slot(logits, temperature, top_k, top_p).float(), dim=-1)
    sampled = torch.stack([
        torch.multinomial(probs[i], 1, generator=g)[0] for i, g in enumerate(generators)
    ]).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def host_sync(x: torch.Tensor) -> None:
    """Wait for `x` by copying it to the host (a named fence)."""
    x.cpu()


@contextmanager
def _occupancy_gauge(engine: str):
    """serving_active_slots for the request-scoped dense engine: 1 while a
    generate holds the batch, back to 0 on any exit (an exception
    mid-request must not leave a phantom active slot)."""
    metrics.set("serving_active_slots", 1.0, {"engine": engine})
    try:
        yield
    finally:
        metrics.set("serving_active_slots", 0.0, {"engine": engine})


@dataclass
class GenerationResult:
    tokens: np.ndarray  # [B, steps + 1] on the host: the first token, then each decode step's
    ttft_s: float
    decode_s: float
    decode_steps: int
    decode_tokens_per_s: float
    # generate_speculative: dispatches, drafted, accepted, tokens_per_dispatch.
    spec_stats: Optional[dict] = None


class Engine:
    """Dense-cache batch generation (lws_tpu/serving/engine.py:Engine)."""

    # generate() runs decode_n in chunks of this many steps (and single steps
    # for the remainder), as the JAX engine does.
    DECODE_CHUNK = 32

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Llama,
        batch_size: int = 1,
        max_len: int = 2048,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        mesh=None,
        pipeline_depth: Optional[int] = None,
        device: DeviceLike = None,
    ):
        """`device` defaults to CUDA (raising without a GPU); `params` must
        already live there. `pipeline_depth` bounds the decode chunks in
        flight in generate(): 2 on CUDA, 0 (synchronous) on the CPU by
        default. One generator seeded from `seed` draws every sample. With
        `mesh`, `params` (full, or already sharded for it) are sharded for
        the rank, the cache holds Hkv/tp heads and batch_size/dp rows, and
        a mesh whose tp does not divide n_kv_heads, or whose dp does not
        divide batch_size, is refused."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type or (
            self.device.index is not None and params.device != self.device
        ):
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        if params.cfg != cfg:
            raise ValueError("params were built for another LlamaConfig")
        self.mesh = mesh
        self._rows = slice(None)  # the batch rows this rank serves
        self._local_batch = batch_size
        if mesh is not None:
            check_mesh(cfg, mesh)
            if batch_size % mesh.dp:
                raise ValueError(f"batch_size={batch_size} not divisible by dp={mesh.dp}")
            params = shard_params_for_serving(params, cfg, mesh)
            n = self._local_batch = batch_size // mesh.dp
            self._rows = slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.sampling = sampling
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if pipeline_depth is None:
            pipeline_depth = 2 if self.device.type == "cuda" else 0
        self.pipeline_depth = pipeline_depth

    @staticmethod
    def _draft_ngram(context: list, ngram: int, gamma: int) -> list:
        """Draft gamma tokens by matching the context's trailing n-gram
        against its own history (prompt-lookup decoding): the latest earlier
        occurrence wins, a short or absent candidate pads with the last
        token (lws_tpu/serving/engine.py:492). Any draft is safe: acceptance
        keeps only tokens equal to the model's own argmax."""
        tail = context[-ngram:]
        cand: list = []
        for i in range(len(context) - ngram - 1, -1, -1):
            if context[i:i + ngram] == tail:
                cand = context[i + ngram: i + ngram + gamma]
                break
        while len(cand) < gamma:
            cand.append(context[-1])
        return cand

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.sampling.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_logits(logits, self._gen, self.sampling)

    def new_cache(self) -> KVCache:
        """An empty cache for the rank's rows (batch_size/dp) and KV heads."""
        return init_cache(self.cfg, self._local_batch, self.max_len, self.device, self.mesh)

    def _gather(self, tok: torch.Tensor) -> torch.Tensor:
        """The whole batch's tokens [B] from the rank's rows: gathered over
        the dp ranks in rank order (as they are, with dp = 1)."""
        if self.mesh is None or self.mesh.dp == 1:
            return tok
        parts = [torch.empty_like(tok) for _ in range(self.mesh.dp)]
        torch.distributed.all_gather(parts, tok.contiguous(), group=self.mesh.dp_group)
        return torch.cat(parts)

    @torch.no_grad()
    def prefill(self, tokens) -> tuple[torch.Tensor, KVCache]:
        """tokens [B, S] -> (first generated token [B] int32, cache at pos S)."""
        tokens = self._tokens(tokens)
        if tokens.shape[1] > self.max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds max_len {self.max_len}")
        logits, cache = forward_prefill(self.params, tokens[self._rows], self.new_cache())
        return self._gather(self._sample(logits)), cache

    def _tokens(self, tokens) -> torch.Tensor:
        """A host array or tensor of token ids as int64 on the engine's device."""
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device).long()
        return torch.tensor(np.asarray(tokens), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def prefill_chunked(self, tokens, chunk_size: int = 256) -> tuple[torch.Tensor, KVCache]:
        """Prefill in chunks of `chunk_size` through forward_prefill_chunk:
        the same first token and cache rows as prefill(), with attention
        memory O(chunk * max_len) instead of O(S^2). A prompt no longer than
        one chunk goes to prefill(); the last chunk is padded, so the padded
        length must fit in max_len, and pos rewinds to S afterwards: the
        padding's K/V sit past it, masked until decode overwrites them
        (lws_tpu/serving/engine.py:321)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        if S <= chunk_size:
            return self.prefill(tokens)
        pad = (-S) % chunk_size
        if S + pad > self.max_len:
            raise ValueError(f"padded prompt {S + pad} exceeds max_len {self.max_len}; "
                             f"use a chunk_size dividing max_len or a shorter prompt")
        padded = F.pad(tokens[self._rows], (0, pad))
        cache = self.new_cache()
        hidden = None
        with trace.span("serve.prefill", chunked=True, prompt_len=S,
                        chunks=(S + pad) // chunk_size):
            for i in range(0, S + pad, chunk_size):
                hidden, cache = forward_prefill_chunk(self.params, padded[:, i:i + chunk_size],
                                                      cache)
            token = self._gather(self._sample(self.params.head(hidden[:, (S - 1) % chunk_size])))
        cache.pos = S
        return token, cache

    @torch.no_grad()
    def prefill_chunked_stream(self, tokens, chunk_size: int, emit, ring_depth: int = 1
                               ) -> tuple[torch.Tensor, KVCache, dict]:
        """Chunked prefill whose K/V leave the device chunk by chunk: after
        chunk N+1 is launched, chunk N's rows are copied to the host and
        handed to `emit(lo, hi, arrays)`, so the gather of chunk N overlaps
        the compute of chunk N+1. A ring of `ring_depth` chunks (0: gather
        right after each chunk) bounds how far the gather trails. `arrays`
        holds "k", "v" (and "k_scale", "v_scale" with cfg.kv_quant) as numpy
        [L, B, hi - lo, Hkv(, hd)] cut to the true prompt rows, copied to
        the host by kv_transport.host_array (bf16 as its uint16 bits tagged
        to go on the wire as "bfloat16", whether ml_dtypes is installed or
        not), and "tokens", the prompt's [B, lo:hi] slice: the shapes and
        bytes of JAX's arrays (lws_tpu/serving/engine.py:360). A chunk's
        rows are copied on the device before the next chunk runs. Returns (first token [B], the
        cache at pos S, stats {"chunks", "gather_s"}).

        Under a mesh every rank computes each chunk, and every rank gathers
        chunk N's KV heads over the tp group (in chunk order, on this
        thread and stream, after chunk N+1 is launched: a collective never
        runs on a side thread); only tp rank 0 copies the full heads to the
        host and calls `emit` (the other ranks' `emit` is never called and
        may be None). `gather_s` then covers the head gather too."""
        group = self.mesh.tp_group if self.mesh is not None else None
        emits = self.mesh is None or self.mesh.tp_rank == 0
        tokens_host = tokens.cpu().numpy() if isinstance(tokens, torch.Tensor) \
            else np.asarray(tokens)
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        if S <= 0:
            raise ValueError("empty prompt")
        pad = (-S) % chunk_size
        if S + pad > self.max_len:
            raise ValueError(f"padded prompt {S + pad} exceeds max_len {self.max_len}; "
                             f"use a chunk_size dividing max_len or a shorter prompt")
        padded = F.pad(tokens, (0, pad))
        cache = self.new_cache()
        hidden = None
        stats = {"chunks": 0, "gather_s": 0.0}
        pending: deque = deque()

        def drain_one() -> None:
            lo, hi, slices = pending.popleft()
            t0 = time.perf_counter()
            if group is not None:
                slices = {name: gather_heads(x, group, dim=3) for name, x in slices.items()}
            if emits:
                arrays = {name: host_array(x) for name, x in slices.items()}  # the fence
            stats["gather_s"] += time.perf_counter() - t0
            if emits:
                arrays["tokens"] = tokens_host[:, lo:hi]
                emit(lo, hi, arrays)
            stats["chunks"] += 1

        for i in range(0, S + pad, chunk_size):
            hidden, cache = forward_prefill_chunk(self.params, padded[:, i:i + chunk_size], cache)
            lo, hi = i, min(i + chunk_size, S)
            names = ("k", "v", "k_scale", "v_scale") if cache.k_scale is not None else ("k", "v")
            pending.append((lo, hi, {n: getattr(cache, n)[:, :, lo:hi].clone() for n in names}))
            while len(pending) > max(0, ring_depth):
                drain_one()
        while pending:
            drain_one()
        token = self._sample(self.params.head(hidden[:, (S - 1) % chunk_size]))
        cache.pos = S
        return token, cache, stats

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """tokens [B] -> (next token [B], cache), the cache written in place."""
        if cache.pos >= cache.max_len:
            raise ValueError(f"cache full at {cache.pos} tokens")
        logits, cache = forward_with_cache(self.params, tokens[self._rows, None], cache)
        return self._gather(self._sample(logits)), cache

    @torch.no_grad()
    def decode_n(self, tokens: torch.Tensor, cache: KVCache, n: int
                 ) -> tuple[torch.Tensor, KVCache, torch.Tensor]:
        """n chained decode steps launched back to back, with no host sync;
        returns (last token [B], cache, all tokens [B, n])."""
        toks = []
        for _ in range(n):
            tokens, cache = self.decode(tokens, cache)
            toks.append(tokens)
        return tokens, cache, torch.stack(toks, dim=1)

    # ---- speculative decoding (n-gram drafts, B = 1) ------------------
    def _spec_step(self, cache: KVCache, token, pos, hist, hist_len, rem, gamma: int, ngram: int):
        """One device-resident speculative dispatch, with no host read: draft
        gamma tokens from the history ring hist [1, H] (hist_len [1] tokens
        recorded), verify the running token and the drafts in one pass
        appended at the device position pos [1], accept the longest prefix
        matching the pass's argmax (clamped by the budget rem [1]), and
        advance pos (the rewind: rejected rows sit past it, masked until
        overwritten), the running token, the history and the budget.
        Returns them with the packed [gamma + 2] result: the tokens taken,
        then the tokens produced (lws_tpu/serving/engine.py:_get_spec_step_dense)."""
        S = gamma + 1
        drafts = ngram_draft(hist, hist_len, ngram, gamma)  # [1, gamma]
        tokens_in = torch.cat([token[:, None], drafts], dim=1)  # [1, S]
        all_logits, _ = forward_with_cache(self.params, tokens_in, cache, all_logits=True, pos=pos)
        greedy = torch.argmax(all_logits, dim=-1).to(torch.int32)
        take, out = speculative_accept(drafts, greedy, rem)  # [1], [1, S]
        token = out.gather(1, torch.clamp(take - 1, min=0)[:, None].long())[:, 0]
        i = torch.arange(S, device=token.device)[None, :]
        idx = (hist_len.long()[:, None] + i) % hist.shape[1]
        hist = hist.scatter(1, idx, torch.where(i < take[:, None], out, hist.gather(1, idx)))
        packed = torch.cat([take, out[0]])
        return token, pos + take, hist, hist_len + take, rem - take, packed

    def _seed_spec_history(self, context, token: torch.Tensor):
        """The device history ring for a fresh speculative run: `context`
        (the prompt, optional) then the running token, in a [1, max_len]
        ring, so the drafting window holds the whole context and the device
        drafts equal _draft_ngram's. Returns (hist, hist_len [1])."""
        ctx = np.zeros((0,), np.int32) if context is None else \
            np.asarray(context.cpu() if isinstance(context, torch.Tensor) else context,
                       np.int32).reshape(-1)
        n = len(ctx)
        hist = np.zeros((1, self.max_len), np.int32)
        hist[0, :n] = ctx
        hist = torch.tensor(hist, device=self.device)
        hist[0, n] = token[0].to(torch.int32)
        return hist, torch.tensor([n + 1], dtype=torch.int32, device=self.device)

    def _speculate_loop(self, cache: KVCache, token: torch.Tensor, needed: int, gamma: int,
                        ngram: int, pos_start: int, context, engine_label: str):
        """Produce exactly `needed` greedy tokens after `token` with
        speculative dispatches on the in-flight ring: the host commits each
        dispatch's packed tokens when it lands and never reads anything
        else. The budget lives on the device (acceptance is clamped by it),
        so dispatches in flight never overshoot. A dispatch whose verify rows
        could reach max_len in the worst case flushes first; once no full
        run fits, the loop finishes with a fixed count of pipelined single
        steps, computed from exact host truth (cache.pos reconciled at that
        flush). Returns (tokens, cache, last token, stats)
        (lws_tpu/serving/engine.py:_speculate_loop)."""
        S = gamma + 1
        hist, hist_len = self._seed_spec_history(context, token)
        rem = torch.tensor([needed], dtype=torch.int32, device=self.device)
        pos = torch.tensor([pos_start], dtype=torch.int32, device=self.device)
        pipe = DecodePipeline(depth=self.pipeline_depth, engine=engine_label)
        out: list[int] = []
        acct = {"dispatches": 0, "drafted": 0, "accepted": 0}

        def commit(host_packed):
            with trace.span("serve.spec_verify", engine=engine_label, gamma=gamma) as sp:
                t = int(host_packed[0])
                if t > 0:
                    out.extend(int(x) for x in host_packed[1:1 + t])
                    acct["dispatches"] += 1
                    acct["drafted"] += gamma
                    acct["accepted"] += t - 1
                sp.set(accepted=max(t - 1, 0))
            metrics.inc("serving_spec_tokens_total", {"engine": engine_label, "kind": "drafted"},
                        value=float(gamma if t > 0 else 0))
            metrics.inc("serving_spec_tokens_total", {"engine": engine_label, "kind": "accepted"},
                        value=float(max(t - 1, 0)))

        guard = 0
        while len(out) < needed:
            guard += 1
            if guard > 4 * needed + 16:
                raise RuntimeError("speculative loop did not converge")
            if pipe and len(out) + pipe.inflight_steps() >= needed:
                # The chunks in flight may already cover the budget: consume
                # instead of dispatching, so every dispatch has budget left.
                pipe.flush()
                continue
            if pos_start + len(out) + pipe.inflight_steps() + S > self.max_len:
                # Worst-case commits in flight could push a verify write past
                # max_len: sync to exact truth, then recheck.
                pipe.flush()
                if pos_start + len(out) + S > self.max_len:
                    break  # a genuine tail: single steps below
                continue
            t0 = time.perf_counter()
            with trace.span("serve.decode_dispatch", engine=engine_label, steps=S,
                            speculative=True, inflight=len(pipe)):
                with pipe.host_section():
                    token, pos, hist, hist_len, rem, packed = self._spec_step(
                        cache, token, pos, hist, hist_len, rem, gamma, ngram)
                pipe.push(S, packed, commit)
            metrics.observe("serving_spec_verify_duration_seconds", time.perf_counter() - t0)
        pipe.flush()
        cache.pos = pos_start + len(out)  # the device pos, as host truth
        # The tail: a fixed count from exact truth (the ring just flushed);
        # counting len(out) inside the loop would lag the pushes in flight.
        tail = min(needed - len(out), self.max_len - pos_start - len(out))
        for _ in range(max(0, tail)):
            with trace.span("serve.decode_dispatch", engine=engine_label, steps=1):
                with pipe.host_section():
                    token, cache = self.decode(token, cache)
                pipe.push(1, token, lambda h: out.append(int(h[0])))
            acct["dispatches"] += 1
        pipe.flush()
        return out, cache, token, acct

    def _check_speculative(self) -> None:
        if self.sampling.temperature > 0:
            raise NotImplementedError("speculative decoding is greedy-only")
        if self.batch_size != 1:
            raise ValueError("speculative decoding is single-sequence (B=1)")

    @torch.no_grad()
    def decode_speculative(self, token: torch.Tensor, cache: KVCache, steps: int, gamma: int = 4,
                           ngram: int = 3, pos: Optional[int] = None, context=None,
                           engine_label: str = "dense"):
        """Continue `cache` by exactly `steps` greedy tokens with speculative
        dispatches: the tokens of decode_n (acceptance keeps only the model's
        own argmax chain), in fewer dispatches on repetitive content. `pos`
        is the cache's length (default cache.pos); `context` (the prompt)
        seeds the drafting history; `engine_label` labels the loop's metrics
        and spans. Returns (last token [1], cache, tokens [1, steps] on the
        host) (lws_tpu/serving/engine.py:678)."""
        self._check_speculative()
        if pos is None:
            pos = cache.pos
        out, cache, token, _ = self._speculate_loop(cache, token, steps, gamma, ngram, pos, context,
                                                    engine_label)
        return token, cache, np.asarray(out, np.int32)[None, :]

    def generate_speculative(self, prompt, max_new_tokens: int, gamma: int = 8,
                             ngram: int = 3, klass: str = "") -> GenerationResult:
        """Greedy generation with n-gram speculative decoding, B = 1: prefill
        (timed to the first token on the host: TTFT), then _speculate_loop
        for the rest (timed: decode). The same tokens as generate() but for
        argmax near-ties between a [1, gamma + 1] verify pass and a [1, 1]
        step. `decode_steps` counts dispatches (lws_tpu/serving/engine.py:704)."""
        prompt = self._tokens(prompt)
        if self.batch_size != 1 or prompt.shape[0] != 1:
            raise ValueError("speculative decoding is single-sequence (B=1)")
        self._check_speculative()
        plen = prompt.shape[1]
        if plen + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        with trace.span("serve.request", engine="dense", speculative=True, prompt_len=plen,
                        max_new_tokens=max_new_tokens) as request_span, \
                _occupancy_gauge("dense"):
            timeline = slo.request("dense", klass=klass)
            t0 = time.perf_counter()
            with trace.span("serve.prefill", chunked=False, prompt_len=plen):
                token, cache = self.prefill(prompt)
                first = int(token[0])  # the first token's fence: TTFT
            ttft = time.perf_counter() - t0
            timeline.first_token(ttft)
            t1 = time.perf_counter()
            new, cache, _, acct = self._speculate_loop(
                cache, token, max(0, max_new_tokens - 1), gamma, ngram, plen, prompt[0], "dense")
            out = ([first] + new)[:max(1, max_new_tokens)]
            dt = time.perf_counter() - t1
            steps = len(out) - 1
            if steps:
                timeline.tokens(steps, dt)
            timeline.finish()
            request_span.set(ttft_s=round(ttft, 6), decode_s=round(dt, 6),
                             dispatches=acct["dispatches"], accepted=acct["accepted"])
        metrics.inc("serving_requests_total", {"engine": "dense"})
        return GenerationResult(
            tokens=np.asarray([out], np.int32),
            ttft_s=ttft,
            decode_s=dt,
            decode_steps=acct["dispatches"],
            decode_tokens_per_s=steps / dt if steps else 0.0,
            spec_stats={**acct, "tokens_per_dispatch": round(steps / max(acct["dispatches"], 1), 2)},
        )

    def generate(self, prompt, max_new_tokens: int, klass: str = "") -> GenerationResult:
        """Generation under the engine's SamplingParams (greedy by default):
        prefill (timed to the first token on the host: TTFT), then
        max_new_tokens - 1 decode steps in DECODE_CHUNK-step decode_n chunks
        and single steps, behind the in-flight ring (timed: decode)."""
        steps = max(0, max_new_tokens - 1)
        n_full, rem = divmod(steps, self.DECODE_CHUNK)
        prompt = self._tokens(prompt)
        with trace.span("serve.request", engine="dense", prompt_len=prompt.shape[1],
                        max_new_tokens=max_new_tokens) as request_span, \
                _occupancy_gauge("dense"):
            timeline = slo.request("dense", klass=klass)
            t0 = time.perf_counter()
            with trace.span("serve.prefill", chunked=False, prompt_len=prompt.shape[1]):
                token, cache = self.prefill(prompt)
                host_chunks = [token.cpu().numpy()[:, None]]  # the first token's fence: TTFT
            ttft = time.perf_counter() - t0
            timeline.first_token(ttft)

            t1 = time.perf_counter()
            pipe = DecodePipeline(depth=self.pipeline_depth, engine="dense")
            for _ in range(n_full):
                with trace.span("serve.decode_dispatch", engine="dense", steps=self.DECODE_CHUNK):
                    with pipe.host_section():
                        token, cache, toks = self.decode_n(token, cache, self.DECODE_CHUNK)
                    pipe.push(self.DECODE_CHUNK, toks, host_chunks.append)
            for _ in range(rem):
                with trace.span("serve.decode_dispatch", engine="dense", steps=1):
                    with pipe.host_section():
                        token, cache = self.decode(token, cache)
                    pipe.push(1, token[:, None], host_chunks.append)
            pipe.flush()
            dt = time.perf_counter() - t1
            if steps:
                timeline.tokens(steps, dt)
            timeline.finish()
            request_span.set(ttft_s=round(ttft, 6), decode_s=round(dt, 6))
        metrics.inc("serving_requests_total", {"engine": "dense"})
        metrics.observe("serving_admission_duration_seconds", ttft, {"engine": "dense"})
        return GenerationResult(
            tokens=np.concatenate(host_chunks, axis=1),
            ttft_s=ttft,
            decode_s=dt,
            decode_steps=steps,
            decode_tokens_per_s=(steps * self.batch_size) / dt if steps else 0.0,
        )
