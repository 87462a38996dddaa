"""Llama-class decoder: the port of lws_tpu/models/llama.py, its serving
forwards (the paged continuous-batching path and the dense Engine) and its
training forward (`forward`, `loss_fn`).

Parameters live in `nn.Module`s (`Llama` holding one `LlamaBlock` per
layer, weights in nn.Linear's [out, in] layout, or int8 `QuantizedWeight`s
with per-output-channel scales when built with `quantized=True`); the
forward functions are plain functions over a module and tensors, mirroring
the JAX functions of the same names. Caches are updated IN PLACE (JAX
returns new arrays): the pool is the largest tensor of a server after the
weights, and an in-place write is what the JAX package's buffer donation
buys it. With cfg.kv_quant the caches hold int8 K/V with per-(token, kv
head) f32 scales.

On CUDA tensors the kernels run: the flash kernel (prefill), the paged-decode
kernel (bf16 or int8 pool), the int8 dense-cache decode kernel, and the
int8_matmul kernel for quantized products of at most 256 rows; on CPU
tensors, their plain versions. `plain=True` runs the plain versions on any
device, products included; it exists so a comparison can hold the kernel
path against the plain path on the card, and the engines never pass it.

The speculative-decoding forward and primitives (`forward_verify_paged`,
`ngram_draft`, `speculative_accept`) and `forward_prefill_chunk` serve the
paged engine's speculative and chunked-admission modes and the dense
Engine's chunked, streamed and speculative paths; their attention is stock
torch, as JAX leaves it to XLA. `forward_decode_slotted` is the
BatchEngine's step: one token per slot at per-slot positions over a dense
cache (the int8 decode kernel with a [B] pos on CUDA for an int8 cache).

With cfg.n_experts the FFN is the GShard top-k MoE of
lws_tpu/models/llama.py:_moe_ffn: static-shape dispatch/combine with a
capacity of max(1, int(capacity_factor * S * top_k / n_experts)) tokens per
expert and batch row, computed from the S of each forward; expert weights
are stacked [E, out, in] (int8 with [E, out] scales when quantized) and the
router [E, D] stays in param_dtype.

Tensor parallelism (Megatron-style, lws_tpu/models/llama.py:param_shardings
made explicit): a `Llama` built with a `mesh` (parallel.mesh.Mesh) holds
rank r's tp shard of every weight, JAX's shard of the same index. Column-
parallel wq/wk/wv/w_gate/w_up keep their output channels [r*n/tp,
(r+1)*n/tp); row-parallel wo/w_down their input channels, each followed by
an all-reduce over the tp group; the embedding and lm_head their vocabulary
rows: a lookup masks the tokens the rank does not hold and all-reduces, the
head all-gathers the logits in rank order. Attention then runs on the
rank's H/tp query and Hkv/tp KV heads (G unchanged), and every cache holds
Hkv/tp heads, so each kernel sees the rank's local heads. With experts,
each rank holds E/tp experts; routing and capacity are computed whole on
every rank, each rank runs its own experts and the combined partial output
is all-reduced (expert parallelism). `shard_params` slices a full model
into a rank's shard (a quantized weight's scale splits with its output
channels and stays whole when its input channels split). The collectives
are stock torch.distributed (NCCL on the card, gloo on the CPU).

Training (lws_tpu/models/llama.py:378-438): `forward` is the no-cache
full-sequence forward with autograd, returning JAX's pair (logits f32, MoE
aux loss / n_layers), and `loss_fn` the causal LM loss over it. Attention is
`gqa_attention` (plain torch, JAX's XLA gqa_attention), or with
cfg.context_parallel the ring over the mesh's cp group (ops/ring.py);
cfg.remat recomputes each block in the backward
(torch.utils.checkpoint, JAX's jax.checkpoint of _block). Under a mesh the
collectives are parallel/collectives.py's autograd functions, with
sequence parallelism (JAX's _seq_shard, lws_tpu/models/llama.py:354):
between blocks each tp rank holds its share of the sequence,
[B, ceil(S / tp), D], S padded up to a multiple of tp with zero positions
that never reach attention, the MoE or the loss. The masked embedding is
reduce-scattered along S (`seq_scatter`), the norms and residuals run on
the share, `seq_gather` (an all-gather whose backward reduce-scatters)
feeds wq/wk/wv, the FFN and the lm_head with the whole sequence, and wo's
and the FFN's partial sums are reduce-scattered back to the share: the
all-gather and reduce-scatter GSPMD puts in place of Megatron's `copy_to`
and `psum`. So remat keeps 1/tp of each block's input, and every rank's
gradient of a tp-split parameter is the whole gradient of what its data
contributes; a norm's covers only the rank's positions, and the training
step sums the norms' over tp (models/train.py). The router sees the whole
gathered sequence on every tp rank and needs no such sum. The serving
forwards keep the whole sequence on every rank (`copy_to`, `psum`), as
JAX's call _block_core without seq_shard. With pp > 1 a `Llama` holds the
L/pp layers of its stage (JAX's P("pp") layer shard): `forward` gathers
the stack from every stage (the weight-gathered path,
lws_tpu/models/pipeline.py:1-4), or with cfg.pipeline_microbatches runs
GPipe (models/pipeline.py) on the tp shares. With cfg.context_parallel
rank r holds tokens [r * S/cp, (r + 1) * S/cp) of every row, and its tp
share of them (JAX's ("cp", "tp") split of S): RoPE positions start at r *
S/cp, and the MoE routes over the gathered sequence (JAX's _moe_ffn sees
the whole sequence: capacity and the expert queues are the sequence's). The
aux loss is computed over the global batch (token counts summed over dp),
each rank's share from its own tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
import itertools
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.core import trace
from lws_tpu_torch.models.quant import QuantizedWeight, embed_lookup, expert_einsum, matmul
from lws_tpu_torch.ops.attention import attention, reference_attention
from lws_tpu_torch.parallel.collectives import (
    all_gather,
    all_gather_partial,
    copy_to,
    group_size,
    psum,
    reduce_scatter,
)
from lws_tpu_torch.ops.int8_attention import (
    int8_decode_attention,
    int8_decode_attention_reference,
)
from lws_tpu_torch.ops.paged_attention import (
    cached_attention as _cached_attention,
    dequantize_kv as _dequantize_kv,
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_reference,
    paged_decode_attention_reference,
)

__all__ = [
    "LlamaConfig", "Llama", "LlamaBlock", "init_params", "rms_norm", "rope",
    "rope_tables", "apply_rope", "moe_capacity", "moe_ffn",
    "KVCache", "init_cache", "forward_prefill", "forward_with_cache", "forward_prefill_chunk",
    "forward_decode_slotted",
    "PagedKVCache", "init_paged_cache", "paged_insert", "forward_decode_paged",
    "forward_verify_paged", "ngram_draft", "speculative_accept", "_cached_attention",
    "_quantize_kv", "_dequantize_kv", "LAYER_PRODUCTS", "LAYER_NORMS", "forward",
    "shard_params", "shard_dim", "tp_size",
    "gqa_attention", "loss_fn", "moe_route", "moe_aux", "local_param_name",
    "global_param_name", "tp_shard", "seq_gather", "seq_scatter",
]

LAYER_PRODUCTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LAYER_NORMS = ("attn_norm", "ffn_norm")
# Megatron's split of the products over tp (lws_tpu/models/llama.py:127-151):
# column-parallel ones split their output channels, row-parallel ones their
# input channels (and are followed by an all-reduce).
COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_PARALLEL = ("wo", "w_down")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 5632
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    # MoE (0 experts = dense FFN everywhere).
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_loss_coef: float = 0.01
    # Training: recompute each block in the backward (activation memory).
    remat: bool = True
    # Long context: exact ring attention over the mesh's cp group.
    context_parallel: bool = False
    # Training: GPipe microbatches over pp (0 = the weight-gathered stack).
    pipeline_microbatches: int = 0
    # Serving: store the KV cache as int8 with per-(token, kv head) f32 scales.
    kv_quant: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d
        ffn = self.n_experts * 3 * d * f + d * self.n_experts if self.n_experts else 3 * d * f
        per_layer = attn + ffn + 2 * d
        return v * d * 2 + self.n_layers * per_layer + d


# ---------------------------------------------------------------------------
# Tensor parallelism


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def shard_dim(name: str, n_experts: int = 0) -> Optional[int]:
    """The dim of a `Llama` parameter or buffer (its name as
    named_parameters/named_buffers give it) that splits over tp, or None
    for a replicated one (norms, the router): the embedding and lm_head
    split the vocabulary (dim 0 of [V, D] and of the per-row scale [V]),
    column-parallel products their output channels (dim 0 of [out, in] and
    of the scale [out]), row-parallel ones their input channels (dim 1; the
    per-output-channel scale stays whole), expert products the experts
    (dim 0 of [E, out, in] and of the scale [E, out])."""
    parts = name.split(".")
    leaf, owner = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if owner in ("embed", "lm_head"):
        return 0
    if n_experts and owner in ("w_gate", "w_up", "w_down"):
        return 0
    if owner in COLUMN_PARALLEL:
        return 0
    if owner in ROW_PARALLEL:
        return None if leaf == "scale" else 1
    return None


def tp_shard(name: str, t: torch.Tensor, mesh, n_experts: int = 0) -> torch.Tensor:
    """The rank's tp slice of the full tensor `t` of parameter or buffer
    `name` (a view; `t` itself when it is replicated or tp = 1)."""
    dim = shard_dim(name, n_experts)
    if dim is None or mesh is None or mesh.tp == 1:
        return t
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_rank * n, n)


def local_param_name(name: str, n_layers: int, mesh) -> Optional[str]:
    """The name a rank's `Llama` gives the full model's tensor `name`, or
    None when the rank does not hold it: with pp > 1, stage s holds layers
    [s * L/pp, (s + 1) * L/pp) as its layers 0..L/pp-1 (JAX's P("pp")
    shard of the stacked layer axis)."""
    if mesh is None or mesh.pp == 1 or not name.startswith("layers."):
        return name
    _, idx, rest = name.split(".", 2)
    per = n_layers // mesh.pp
    stage, j = divmod(int(idx), per)
    return f"layers.{j}.{rest}" if stage == mesh.pp_rank else None


def global_param_name(name: str, n_layers: int, mesh) -> str:
    """The full model's name of a rank's tensor `name` (local_param_name's
    inverse)."""
    if mesh is None or mesh.pp == 1 or not name.startswith("layers."):
        return name
    _, idx, rest = name.split(".", 2)
    return f"layers.{mesh.pp_rank * (n_layers // mesh.pp) + int(idx)}.{rest}"


# ---------------------------------------------------------------------------
# Blocks


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, cast back, then scale in x's dtype (the cast order
    of lws_tpu/models/llama.py:186-189)."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight.to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, S, 1, hd/2] in f32 for `positions` [B, S]. A forward
    builds them once and every layer reuses them."""
    exponents = -torch.arange(0, hd // 2, dtype=torch.float32, device=positions.device) / (hd // 2)
    freqs = torch.pow(theta, exponents)  # a Python base: no host-to-device copy
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]: rotate-half RoPE in f32 with tables from rope_tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd], positions [B, S]: rotate-half RoPE in f32
    (lws_tpu/models/llama.py:192)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


class ExpertWeights(nn.Module):
    """E stacked product weights, `.weight` [E, d_out, d_in] in `dtype`:
    nn.Linear's layout per expert. Not initialized."""

    def __init__(self, n_experts: int, d_in: int, d_out: int, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_experts, d_out, d_in, device=device, dtype=dtype))


def _linear(d_in: int, d_out: int, device, dtype, quantized: bool = False,
            n_experts: int = 0) -> nn.Module:
    """A product weight [d_out, d_in] (with `n_experts`, [n_experts, d_out,
    d_in]): nn.Linear (ExpertWeights) in `dtype`, or int8 with
    per-output-channel scales. Not initialized: init_params,
    init_quantized_params or the weight bridge writes it."""
    if quantized:
        return QuantizedWeight(d_out, d_in, device, n_experts)
    if n_experts:
        return ExpertWeights(n_experts, d_in, d_out, device, dtype)
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False, device=device, dtype=dtype)


def moe_capacity(capacity_factor: float, S: int, top_k: int, n_experts: int) -> int:
    """Tokens each expert takes per batch row in a forward of S positions
    (lws_tpu/models/llama.py:232, Python's int truncation)."""
    return max(1, int(capacity_factor * S * top_k / n_experts))


def moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity_factor: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The GShard routing of lws_tpu/models/llama.py:_moe_ffn over x [B, S,
    D] and router [E, D]: returns (probs [B, S, E] f32, dispatch [B, S, E,
    C] in x's dtype, gates [B, S, E] f32: each kept expert's router
    probability renormalized over the token's kept experts). Each token's
    top-k experts are picked in order (argmax, first index on ties) and kept
    while the expert's running count in its batch row is below the capacity
    C (moe_capacity of this S)."""
    B, S, _ = x.shape
    E = router.shape[0]
    C = moe_capacity(capacity_factor, S, top_k, E)
    probs = torch.softmax(F.linear(x, router.to(x.dtype)).float(), dim=-1)  # [B, S, E]

    remaining = probs
    expert_count = torch.zeros(B, E, dtype=torch.float32, device=x.device)
    dispatch = torch.zeros(B, S, E, C, dtype=x.dtype, device=x.device)
    gates_sum = torch.zeros(B, S, dtype=torch.float32, device=x.device)
    combine_gates = torch.zeros(B, S, E, dtype=torch.float32, device=x.device)
    for _ in range(top_k):
        onehot = F.one_hot(torch.argmax(remaining, dim=-1), E).float()  # [B, S, E]
        pos = torch.cumsum(onehot, dim=1) - onehot + expert_count[:, None, :]
        keep = onehot * (pos < C)
        expert_count = expert_count + keep.sum(dim=1)
        gate = (probs * keep).sum(dim=-1)  # [B, S]
        pos_idx = (pos * keep).sum(dim=-1).long()
        slot = F.one_hot(pos_idx, C).to(x.dtype) * keep.sum(dim=-1, keepdim=True).to(x.dtype)
        dispatch = dispatch + keep.to(x.dtype)[..., None] * slot[:, :, None, :]
        combine_gates = combine_gates + keep * gate[..., None]
        gates_sum = gates_sum + gate
        remaining = remaining * (1.0 - onehot)
    return probs, dispatch, combine_gates / torch.clamp(gates_sum, min=1e-9)[..., None]


def _experts(x: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor, w_gate, w_up,
             w_down, plain: bool) -> torch.Tensor:
    """The experts' SwiGLU over their [B, C] slots and the combine:
    dispatch/combine [B, S, E_local, C] for the experts the weights hold.
    Its three phases are the live span's `moe_dispatch`, `moe_experts` and
    `moe_combine` sections (core/trace.py)."""
    with trace.section("moe_dispatch"):
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    with trace.section("moe_experts"):
        h = F.silu(expert_einsum(expert_in, w_gate, plain=plain)) \
            * expert_einsum(expert_in, w_up, plain=plain)
        expert_out = expert_einsum(h, w_down, plain=plain)  # [E, B, C, D]
    with trace.section("moe_combine"):
        return torch.einsum("bsec,ebcd->bsd", combine, expert_out)


def moe_aux(probs: torch.Tensor, own: slice, dp_group=None) -> torch.Tensor:
    """The Switch load-balancing loss of lws_tpu/models/llama.py:271-274,
    E * sum_e(token fraction_e * mean probability_e), over the global batch:
    probs [B, S, E] are the rank's rows over the whole sequence, their
    argmax counts are summed over `dp_group` (the rows of the other dp
    ranks). The result is the rank's share: its mean probabilities count
    only the positions `own` of the sequence (its cp chunk), so the shares
    of the ranks that split the data sum to JAX's aux."""
    B, S, E = probs.shape
    with torch.no_grad():
        counts = F.one_hot(torch.argmax(probs, dim=-1), E).float().sum(dim=(0, 1))
        if dp_group is not None:
            dist.all_reduce(counts, group=dp_group)
        n = B * S * (1 if dp_group is None else dist.get_world_size(dp_group))
    token_frac = counts / n
    prob_frac = probs[:, own].sum(dim=(0, 1)) / n
    return E * torch.sum(token_frac * prob_frac)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate, w_up, w_down, top_k: int,
            capacity_factor: float, plain: bool = False, expert_offset: int = 0) -> torch.Tensor:
    """GShard top-k MoE with static-shape dense dispatch/combine
    (lws_tpu/models/llama.py:_moe_ffn, without the aux loss): x [B, S, D],
    router [E, D], expert weights [E, out, in] plain or quantized. Each
    token's top-k experts are picked in order (argmax, first index on ties),
    kept while the expert's running count in its batch row is below the
    capacity C, and combined with their router probabilities renormalized
    over the kept ones. Every expert computes its [B, C] slots, filled or
    not. Returns [B, S, D] in x's dtype.

    Expert parallelism: the weights may hold only experts [expert_offset,
    expert_offset + E_local) of the router's E; routing and capacity are
    still computed over all E, and the result is those experts' share of
    the combined output (the caller sums the shares over the tp group)."""
    with trace.section("moe_route"):
        _, dispatch, gates = moe_route(x, router, top_k, capacity_factor)
        combine = gates.to(x.dtype)[..., None] * dispatch  # [B, S, E, C]
    local = slice(expert_offset, expert_offset + w_gate.shape[0])
    return _experts(x, dispatch[:, :, local], combine[:, :, local], w_gate, w_up, w_down, plain)


def seq_gather(x: torch.Tensor, group, S: int, partial: bool = True) -> torch.Tensor:
    """The n ranks' shares [B, ceil(S / n), D] of a sequence of S positions
    split over `group`, gathered in rank order and cut to S (the padding
    dropped). `partial`: the consumers are the ranks' parts of one
    computation (column-parallel products), so the backward reduce-scatters;
    else replicas, and it keeps the rank's slice (collectives.all_gather).
    The identity over no group or one rank."""
    if group_size(group) == 1:
        return x
    x = all_gather_partial(x, group, 1) if partial else all_gather(x, group, 1)
    return x if x.shape[1] == S else x[:, :S]


def seq_scatter(y: torch.Tensor, group) -> torch.Tensor:
    """Partial sums y [B, S, D] of the n ranks of `group` -> the rank's share
    [B, ceil(S / n), D] of their sum (reduce_scatter along the sequence, S
    padded with zero positions to a multiple of n, as GSPMD pads an uneven
    sharding constraint). The identity over no group or one rank."""
    n = group_size(group)
    if n == 1:
        return y
    pad = -y.shape[1] % n
    return reduce_scatter(F.pad(y, (0, 0, 0, pad)) if pad else y, group, 1)


class LlamaBlock(nn.Module):
    """One decoder layer: RMSNorm, GQA attention with RoPE, RMSNorm, SwiGLU
    FFN (dense, or cfg.n_experts experts behind a top-k router), both with
    residuals (lws_tpu/models/llama.py:_block_core). With a `mesh`, the
    rank's tp shard: H/tp and Hkv/tp heads, d_ff/tp FFN channels (or E/tp
    experts), and an all-reduce after wo and after the FFN (serving) or a
    reduce-scatter along the sequence (training, `forward(train=True)`)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device, quantized: bool = False,
                 mesh=None):
        super().__init__()
        tp = tp_size(mesh)
        d, hd, E = cfg.d_model, cfg.head_dim, cfg.n_experts
        f = cfg.d_ff if E else cfg.d_ff // tp  # experts split over E, a dense FFN over d_ff
        pd = cfg.param_dtype
        nh, nkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
        self.n_heads, self.n_kv_heads, self.head_dim = nh, nkv, hd
        self.mesh = mesh
        self.norm_eps = cfg.norm_eps
        self.top_k, self.capacity_factor = cfg.top_k, cfg.capacity_factor
        self.context_parallel = cfg.context_parallel
        self.expert_offset = (E // tp) * mesh.tp_rank if E and mesh is not None else 0
        self.attn_norm = nn.Parameter(torch.ones(d, dtype=pd, device=device))
        self.wq = _linear(d, nh * hd, device, pd, quantized)
        self.wk = _linear(d, nkv * hd, device, pd, quantized)
        self.wv = _linear(d, nkv * hd, device, pd, quantized)
        self.wo = _linear(nh * hd, d, device, pd, quantized)
        self.ffn_norm = nn.Parameter(torch.ones(d, dtype=pd, device=device))
        # The router stays in param_dtype when the model is quantized
        # (lws_tpu/models/quant.py:64: tiny and precision-critical).
        self.router = nn.Parameter(torch.empty(E, d, dtype=pd, device=device)) if E else None
        self.w_gate = _linear(d, f, device, pd, quantized, E // tp)
        self.w_up = _linear(d, f, device, pd, quantized, E // tp)
        self.w_down = _linear(f, d, device, pd, quantized, E // tp)

    def _group(self, axis: str):
        return None if self.mesh is None else self.mesh.groups[axis]

    def forward(self, x: torch.Tensor, rope_cs: tuple[torch.Tensor, torch.Tensor],
                attn_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                plain: bool = False, train: bool = False):
        """x [B, S, D] -> [B, S, D]; `rope_cs` = rope_tables(positions) for
        x's positions; `attn_fn(q, k, v)` is the one step the forward
        variants (prefill, cached, paged decode, training) parameterize;
        `plain` sends quantized products through int8_matmul's plain
        version. With `train` it returns (x, aux): the MoE aux loss share of
        the rank (moe_aux; 0 for a dense FFN), and with cfg.context_parallel
        the MoE routes over the sequence gathered from the cp group.

        With `train`, x is the rank's share of the sequence over tp
        (sequence parallelism, JAX's _seq_shard): [B, ceil(S / tp), D],
        where S = rope_cs's positions. The norms and residuals run on the
        share; seq_gather feeds wq/wk/wv and the FFN with the whole S, and
        wo's and the FFN's partial sums are reduce-scattered back to the
        share (seq_scatter), in place of copy_to and psum.

        The attention half and the dense FFN are the live span's `attn` and
        `ffn` sections (core/trace.py); an MoE FFN times its own phases
        (moe_ffn)."""
        B = x.shape[0]
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        tp = self._group("tp")
        if train:
            S = rope_cs[0].shape[1]
            gather, reduce = (lambda t: seq_gather(t, tp, S)), (lambda t: seq_scatter(t, tp))
        else:
            S = x.shape[1]
            gather, reduce = (lambda t: copy_to(t, tp)), (lambda t: psum(t, tp))
        with trace.section("attn"):
            h = gather(rms_norm(x, self.attn_norm, self.norm_eps))
            q = matmul(h, self.wq.weight, plain=plain).reshape(B, S, nh, hd)
            k = matmul(h, self.wk.weight, plain=plain).reshape(B, S, nkv, hd)
            v = matmul(h, self.wv.weight, plain=plain).reshape(B, S, nkv, hd)
            q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
            attn = attn_fn(q, k, v).reshape(B, S, nh * hd)
            x = x + reduce(matmul(attn, self.wo.weight, plain=plain))
        h = rms_norm(x, self.ffn_norm, self.norm_eps)
        aux = None
        if self.router is not None and train:
            y, aux = self._moe_train(h, S)
        elif self.router is not None:
            y = moe_ffn(h, self.router, self.w_gate.weight, self.w_up.weight, self.w_down.weight,
                        self.top_k, self.capacity_factor, plain, self.expert_offset)
        else:
            with trace.section("ffn"):
                h = gather(h)
                y = matmul(F.silu(matmul(h, self.w_gate.weight, plain=plain))
                           * matmul(h, self.w_up.weight, plain=plain),
                           self.w_down.weight, plain=plain)
        x = x + reduce(y)
        if not train:
            return x
        return x, (aux if aux is not None else torch.zeros((), device=x.device))

    def _moe_train(self, h: torch.Tensor, S: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The training MoE over h, the rank's share of its S positions
        over tp: the rank's experts' partial output for those S positions
        (the block reduce-scatters it over tp), and its aux share. Routing
        sees the whole sequence (the tp shares, then the cp group's chunks
        gathered in order, so capacity and queues are JAX's); the combine
        weights and the experts' input enter through copy_to over tp, since
        each tp rank's experts see only part of their gradient, while the
        router's aux path is replicated and counted once (so the tp gather
        is a replica's: its backward keeps the rank's slice)."""
        tp, cp = self._group("tp"), self._group("cp") if self.context_parallel else None
        own = slice(None) if cp is None else slice(self.mesh.cp_rank * S,
                                                    (self.mesh.cp_rank + 1) * S)
        hg = all_gather_partial(seq_gather(h, tp, S, partial=False), cp, dim=1)
        probs, dispatch, gates = moe_route(hg, self.router, self.top_k, self.capacity_factor)
        combine = copy_to(gates, tp).to(h.dtype)[..., None] * dispatch
        local = slice(self.expert_offset, self.expert_offset + self.w_gate.weight.shape[0])
        y = _experts(copy_to(hg, tp), dispatch[:, :, local], combine[:, :, local],
                     self.w_gate.weight, self.w_up.weight, self.w_down.weight, False)
        return y[:, own], moe_aux(probs, own, self._group("dp"))


class Llama(nn.Module):
    """The decoder's parameters: embed [V, D], layers, final norm, lm_head
    (D -> V, [V, D] as nn.Linear keeps it). Built uninitialized on `device`
    (CUDA by default); `init_params` or `models.convert.params_from_jax`
    fills it. With `quantized=True` every product weight, the lm_head and
    the embedding table are int8 `QuantizedWeight`s (the layout of
    lws_tpu/models/quant.py:quantize_params) and only the norms stay
    parameters; `init_quantized_params`, `quantize_params` or the weight
    bridge fills it. With a `mesh` (parallel.mesh.Mesh) every tensor has
    the shape of the rank's tp shard and, with pp > 1, `layers` holds the
    n_layers/pp layers of the rank's stage (module docstring);
    `shard_params` fills it from a full model. Parameters are built with
    requires_grad off (serving builds no autograd graph); the training
    step switches it on for the parameters it trains."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None, quantized: bool = False,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        tp = tp_size(mesh)
        pp = 1 if mesh is None else mesh.pp
        if cfg.n_layers % pp:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
        split = [("n_kv_heads", cfg.n_kv_heads), ("n_heads", cfg.n_heads),
                 ("vocab_size", cfg.vocab_size),
                 ("n_experts", cfg.n_experts) if cfg.n_experts else ("d_ff", cfg.d_ff)]
        for what, n in split:
            if n % tp:
                raise ValueError(f"{what}={n} not divisible by tp={tp}")
        self.cfg = cfg
        self.quantized = quantized
        self.mesh = mesh
        pd = cfg.param_dtype
        V = cfg.vocab_size // tp
        if quantized:
            self.embed = QuantizedWeight(V, cfg.d_model, device)
        else:
            self.embed = nn.utils.skip_init(nn.Embedding, V, cfg.d_model, device=device, dtype=pd)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device, quantized, mesh)
                                    for _ in range(cfg.n_layers // pp))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=pd, device=device))
        self.lm_head = _linear(cfg.d_model, V, device, pd, quantized)
        self.requires_grad_(False)  # serving only: no autograd graph on any forward

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def logits(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Final norm + lm_head in the compute dtype, returned as f32."""
        return self.head(rms_norm(x, self.final_norm, self.cfg.norm_eps), plain)

    def head(self, h: torch.Tensor, plain: bool = False, seq: Optional[int] = None
             ) -> torch.Tensor:
        """lm_head over already-normalized hidden states, returned as f32
        (under a mesh, every rank's vocabulary shard gathered in rank order).
        With `seq` = S, h is the rank's share of S positions over tp
        (training): the shares are gathered (seq_gather) in place of
        copy_to, and the logits cover all S. Timed as the live span's
        `lm_head` section (core/trace.py)."""
        tp = None if self.mesh is None else self.mesh.tp_group
        with trace.section("lm_head"):
            h = copy_to(h, tp) if seq is None else seq_gather(h, tp, seq)
            return all_gather(matmul(h, self.lm_head.weight, plain=plain), tp).float()

    def embed_tokens(self, tokens: torch.Tensor, share: bool = False) -> torch.Tensor:
        """The embedding rows of `tokens` in the compute dtype. Under a mesh
        the rank holds vocabulary rows [r*V/tp, (r+1)*V/tp): it looks up the
        tokens it holds, zeroes the rest and all-reduces, so exactly one
        rank contributes each row; with `share` (training) it reduce-scatters
        along the sequence instead and returns the rank's share over tp
        (seq_scatter). A negative id counts from the end of the vocabulary,
        as JAX's and torch's indexing of the whole table do."""
        dtype = self.cfg.dtype
        if self.mesh is None:
            return embed_lookup(self.embed.weight, tokens, dtype)
        n = self.cfg.vocab_size // self.mesh.tp
        ids = tokens.long()
        local = torch.where(ids < 0, ids + self.cfg.vocab_size, ids) - self.mesh.tp_rank * n
        held = (local >= 0) & (local < n)
        x = embed_lookup(self.embed.weight, torch.where(held, local, 0), dtype)
        x = x.masked_fill_(~held[..., None], 0)
        return seq_scatter(x, self.mesh.tp_group) if share else psum(x, self.mesh.tp_group)


@torch.no_grad()
def shard_params(model: Llama, mesh) -> Llama:
    """Rank mesh.tp_rank's tp shard of a full `model` (shard_dim's split of
    every tensor, JAX's NamedSharding shard of the same index), with pp > 1
    only the layers of its stage (local_param_name): a `Llama` built for
    `mesh`. Replicated tensors, and every tensor at tp = 1, are the full
    model's own; a split one is a contiguous copy of its shard. A model
    already sharded for `mesh` is returned as it is."""
    if model.mesh is not None:
        if model.mesh is mesh:
            return model
        raise ValueError("shard_params: the model is already sharded over another mesh")
    out = Llama(model.cfg, "meta", model.quantized, mesh)
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        local = local_param_name(name, model.cfg.n_layers, mesh)
        if local is None:
            continue
        shard = tp_shard(name, t, mesh, model.cfg.n_experts)
        if shard is not t:
            t = shard.clone(memory_format=torch.contiguous_format)
        name = local
        owner_name, _, leaf = name.rpartition(".")
        owner = out.get_submodule(owner_name)
        want = getattr(owner, leaf).shape
        if t.shape != want:
            raise ValueError(f"shard_params: {name} shard is {tuple(t.shape)}, "
                             f"the sharded model expects {tuple(want)}")
        if leaf in owner._parameters:
            owner._parameters[leaf] = nn.Parameter(t, requires_grad=False)
        else:
            owner._buffers[leaf] = t
    return out


@torch.no_grad()
def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, mesh=None) -> Llama:
    """Random dense weights with the scales of lws_tpu/models/llama.py:86-124
    (N(0,1) * fan_in**-0.5; wo and w_down further damped by (2L)**-0.5;
    embed unscaled; norms ones; with experts, the router and every expert's
    products the same way), drawn from `generator` (seed 0 if None) in
    f32 on `device` and stored in cfg.param_dtype. The streams differ from
    jax.random's: tests that compare with JAX convert JAX's weights instead.
    With a `mesh`, the rank's shard of those same weights
    (shard_params(init_params(cfg, generator)) without the full model: each
    tensor is drawn whole in turn, its shard kept, the rest dropped)."""
    model = Llama(cfg, device, mesh=mesh)
    full = model if mesh is None else Llama(cfg, "meta")
    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def fill(name: str, fan_in: int, damp: float = 1.0) -> None:
        shape = full.get_parameter(name).shape
        draw = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        local = local_param_name(name, cfg.n_layers, mesh)
        if local is not None:
            draw = tp_shard(name, draw, mesh, cfg.n_experts)
            model.get_parameter(local).copy_(draw.mul_(fan_in**-0.5 * damp))

    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    depth_damp = (2 * L) ** -0.5
    for i in range(L):
        fill(f"layers.{i}.wq.weight", d)
        fill(f"layers.{i}.wk.weight", d)
        fill(f"layers.{i}.wv.weight", d)
        fill(f"layers.{i}.wo.weight", cfg.n_heads * cfg.head_dim, depth_damp)
        if cfg.n_experts:
            fill(f"layers.{i}.router", d)
        fill(f"layers.{i}.w_gate.weight", d)
        fill(f"layers.{i}.w_up.weight", d)
        fill(f"layers.{i}.w_down.weight", f, depth_damp)
    fill("embed.weight", 1)
    fill("lm_head.weight", d)
    return model


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention with an f32 softmax, with autograd
    (lws_tpu/models/llama.py:203): reference_attention, whose arithmetic is
    JAX's gqa_attention's (scores in the input dtype cast to f32 and scaled,
    the tril mask at -1e30, probabilities cast to v's dtype)."""
    return reference_attention(q, k, v, causal=True)


def _warn_if_trivial_cp(mesh) -> None:
    """context_parallel over a cp of one rank degrades to a one-rank ring
    (attention memory stays O(S)); say so (lws_tpu/models/llama.py:298)."""
    import warnings

    if mesh is None or mesh.cp <= 1:
        warnings.warn(
            "cfg.context_parallel=True but the mesh's cp axis has size 1 — "
            "ring attention degenerates to dense attention; build the mesh "
            "with MeshSpec(cp=...) or mesh_from_bootstrap(..., cp=...)",
            stacklevel=3,
        )


def _attention_fn(cfg: LlamaConfig, mesh) -> Callable:
    """_block's choice of attention (lws_tpu/models/llama.py:282): the ring
    over the cp group with cfg.context_parallel, else gqa_attention."""
    if not cfg.context_parallel:
        return gqa_attention
    from lws_tpu_torch.ops.ring import ring_attention

    _warn_if_trivial_cp(mesh)
    group = None if mesh is None else mesh.cp_group
    return lambda q, k, v: ring_attention(q, k, v, group)


def run_block(block: LlamaBlock, x: torch.Tensor, rope_cs, attn_fn, remat: bool,
              weights: Optional[dict] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One training block: (x, aux) = block(x, train=True), its parameters
    replaced by `weights` (name -> tensor, torch.func.functional_call) when
    given; with `remat`, recomputed in the backward
    (torch.utils.checkpoint, non-reentrant)."""
    def run(x):
        if weights is None:
            return block(x, rope_cs, attn_fn, train=True)
        return torch.func.functional_call(block, weights, (x, rope_cs, attn_fn), {"train": True})

    if remat:
        from torch.utils.checkpoint import checkpoint

        return checkpoint(run, x, use_reentrant=False)
    return run(x)


def _layer_stack(params: Llama) -> list[tuple[LlamaBlock, Optional[dict]]]:
    """The layers in order, each a (block, weights) pair. With pp > 1 every
    stage's layers are gathered over the pp group (all_gather: each stage
    keeps its own layers' gradient, since every stage computes the same
    loss) and run through the rank's block of the same local index."""
    mesh = params.mesh
    local = list(params.layers)
    if mesh is None or mesh.pp == 1:
        return [(blk, None) for blk in local]
    stacks = [{n: all_gather(p[None], mesh.pp_group, 0) for n, p in blk.named_parameters()}
              for blk in local]
    return [(local[j], {n: t[s] for n, t in stacks[j].items()})
            for s in range(mesh.pp) for j in range(len(local))]


def forward(params: Llama, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The no-cache full-sequence forward with autograd
    (lws_tpu/models/llama.py:378): tokens [B, S] -> (logits [B, S, V] f32,
    the MoE aux loss / n_layers, f32 scalar; 0 for a dense model).

    Under a mesh, `tokens` are the rank's: its dp rows and, with
    cfg.context_parallel, its cp chunk of the sequence (positions start at
    cp_rank * S); the logits are those of its tokens, and the aux is the
    global batch's (psum of the ranks' shares over the data group). With
    cfg.pipeline_microbatches the layers run as GPipe over pp
    (models/pipeline.py), which context_parallel refuses, as JAX does. Call
    it under torch.no_grad to build no graph.

    Between the embedding and the final norm each tp rank holds its share
    of those S positions, [B, ceil(S / tp), D] (JAX's _seq_shard: the
    embedding reduce-scattered along S, the blocks fed and left so, the
    final norm on the share, the shares gathered into the lm_head), so
    remat keeps 1/tp of each block's input."""
    cfg, mesh = params.cfg, params.mesh
    B, S = tokens.shape
    offset = mesh.cp_rank * S if (mesh is not None and cfg.context_parallel) else 0
    positions = (offset + torch.arange(S, device=tokens.device)).expand(B, S)
    x = params.embed_tokens(tokens, share=True)
    if cfg.pipeline_microbatches > 0:
        if cfg.context_parallel:
            raise NotImplementedError("pipeline_microbatches with context_parallel")
        from lws_tpu_torch.models.pipeline import pipeline_forward

        x, aux = pipeline_forward(params, x, positions)
    else:
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        attn_fn = _attention_fn(cfg, mesh)
        aux = torch.zeros((), device=x.device)
        for block, weights in _layer_stack(params):
            x, a = run_block(block, x, rope_cs, attn_fn, cfg.remat, weights)
            aux = aux + a
    logits = params.head(rms_norm(x, params.final_norm, cfg.norm_eps), seq=S)
    data = None if mesh is None else mesh.data_group(cfg.context_parallel)
    return logits, psum(aux / cfg.n_layers, data)


def loss_fn(params: Llama, batch: dict) -> tuple[torch.Tensor, dict]:
    """Causal LM loss (lws_tpu/models/llama.py:422): batch = {"tokens":
    [B, S+1] integer} (a tensor on the model's device), shifted inside;
    targets < 0 are masked; the NLL is summed and divided by the count of
    unmasked targets, and aux_loss_coef * aux added. Returns (total,
    {"ce", "aux"}).

    Under a mesh, `tokens` are the rank's dp rows over the whole sequence;
    with cfg.context_parallel the rank takes its cp chunk of inputs and
    targets. The count is the global one (summed over the data group), the
    rank's NLL sum over it is its share, and the shares are summed by psum,
    whose backward is the identity: the returned values are the global
    loss, and the gradient each rank computes is its data's share of the
    global gradient (the training step sums the shares over the data
    group)."""
    cfg, mesh = params.cfg, params.mesh
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    data = None if mesh is None else mesh.data_group(cfg.context_parallel)
    if mesh is not None and cfg.context_parallel:
        S = inputs.shape[1]
        if S % mesh.cp:
            raise ValueError(f"sequence {S} not divisible by cp={mesh.cp}")
        chunk = slice(mesh.cp_rank * (S // mesh.cp), (mesh.cp_rank + 1) * (S // mesh.cp))
        inputs, targets = inputs[:, chunk], targets[:, chunk]
    logits, aux = forward(params, inputs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.clamp(min=0).long()[..., None])[..., 0]
    mask = (targets >= 0).float()
    count = mask.sum()
    if data is not None:
        dist.all_reduce(count, group=data)
    ce = psum((nll * mask).sum() / torch.clamp(count, min=1.0), data)
    return ce + cfg.aux_loss_coef * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Dense KV cache (the prefill cache, and the dense Engine's cache)


@dataclass
class KVCache:
    """k/v [L, B, T, Hkv, hd]; pos = tokens filled. With cfg.kv_quant, k/v
    are int8 and k_scale/v_scale [L, B, T, Hkv] hold the per-(token, kv
    head) dequantization scales."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device: DeviceLike = None,
               mesh=None) -> KVCache:
    """An empty dense cache; under a mesh, on the rank's Hkv/tp heads."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads // tp_size(mesh), cfg.head_dim)
    if cfg.kv_quant:
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] -> (int8 values, per-(...) amax/127 scales)
    (lws_tpu/models/llama.py:475)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _write_kv(cache, layer_idx: int, index: tuple, k: torch.Tensor, v: torch.Tensor,
              dropped: Optional[torch.Tensor] = None) -> None:
    """Write K/V rows into `cache` (dense or paged) at cache.k[layer_idx][index],
    quantizing them first when the cache holds int8. Where the bool mask
    `dropped` (over the index's leading dims) is set, the row keeps what it
    holds."""
    if cache.k_scale is not None:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        pairs = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs))
    else:
        pairs = ((cache.k, k.to(cache.k.dtype)), (cache.v, v.to(cache.v.dtype)))
    for pool, new in pairs:
        if dropped is not None:
            keep = dropped.reshape(dropped.shape + (1,) * (new.dim() - dropped.dim()))
            new = torch.where(keep, pool[layer_idx][index], new)
        pool[layer_idx][index] = new


@torch.no_grad()
def forward_prefill(params: Llama, tokens: torch.Tensor, cache: KVCache,
                    last_pos: Optional[int] = None, plain: bool = False
                    ) -> tuple[torch.Tensor, KVCache]:
    """Prefill an EMPTY cache (pos == 0) with tokens [B, S]: plain causal
    attention over the prompt (the flash kernel on CUDA), each layer's K/V
    written into cache[:, :, :S] in place (quantized per token and head for
    an int8 cache, the same values as JAX's whole-stack quantization).
    Returns (logits [B, V] f32 at `last_pos` — the true last token of a
    padded prompt; S-1 if None — and the cache with pos advanced to
    last_pos+1). lws_tpu/models/llama.py:622."""
    cfg = params.cfg
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = params.embed_tokens(tokens)
    attn_op = reference_attention if plain else attention
    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, (slice(None), slice(0, S)), k, v)
            return attn_op(q, k, v, causal=True)

        x = block(x, rope_cs, attn_fn, plain)
    if last_pos is None:
        last, advanced = x[:, -1], S
    else:
        last, advanced = x[:, int(last_pos)], int(last_pos) + 1
    cache.pos += advanced
    return params.logits(last, plain), cache


def _forward_cached(params: Llama, tokens: torch.Tensor, cache: KVCache,
                    plain: bool, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layers over tokens [B, S] appended at cache.pos: each layer writes
    its K/V at [pos, pos + S) in place, then its queries attend to keys <=
    their position (lws_tpu/models/llama.py:_block_with_cache :504): with an
    int8 cache and S == 1 the int8 decode kernel on CUDA; with an int8 cache
    otherwise, the dequantized layer through cached attention; with a bf16
    cache, cached attention (the path JAX leaves to XLA). Advances cache.pos
    by S and returns the last layer's output [B, S, D], before the final
    norm. Writes must fit: pos + S past the cache's length raises (JAX would
    clamp the write's start instead).

    `pos`, a [B] int32 device tensor, appends at those positions instead
    (RoPE, the K/V writes and the mask all read it, with no host read) and
    leaves cache.pos as it is: the caller owns the position. A position
    past the cache writes nothing, as JAX's scatter drops an out-of-range
    update (its row T-1 is written back with what it holds), and its query
    attends to every key, which the int8 kernel reads as pos T-1. With
    S > 1 the caller keeps the writes inside the cache."""
    cfg = params.cfg
    B, S = tokens.shape
    steps = torch.arange(S, device=tokens.device)
    if pos is None:
        start = cache.pos
        if start + S > cache.max_len:
            raise ValueError(f"{S} tokens at {start} overflow a cache of {cache.max_len}")
        positions = start + steps.expand(B, S)
        index = (slice(None), slice(start, start + S))
        dropped, kernel_pos = None, start
    else:
        start = pos
        positions = pos.long()[:, None] + steps[None, :]
        T = cache.max_len
        dropped = positions >= T
        index = (torch.arange(B, device=tokens.device)[:, None], positions.clamp(max=T - 1))
        kernel_pos = pos.clamp(max=T - 1)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = params.embed_tokens(tokens)
    decode_op = int8_decode_attention_reference if plain else int8_decode_attention
    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, index, k, v, dropped)
            if cache.k_scale is None:
                return _cached_attention(q, cache.k[layer_idx], cache.v[layer_idx], start)
            layer = (cache.k[layer_idx], cache.k_scale[layer_idx],
                     cache.v[layer_idx], cache.v_scale[layer_idx])
            if S == 1:
                return decode_op(q, *layer, kernel_pos)
            return _cached_attention(q, _dequantize_kv(layer[0], layer[1], cfg.dtype),
                                     _dequantize_kv(layer[2], layer[3], cfg.dtype), start)

        x = block(x, rope_cs, attn_fn, plain)
    if pos is None:
        cache.pos += S
    return x


@torch.no_grad()
def forward_with_cache(params: Llama, tokens: torch.Tensor, cache: KVCache,
                       plain: bool = False, last_offset=None, all_logits: bool = False,
                       pos: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, KVCache]:
    """Append tokens [B, S] at cache.pos; returns (logits [B, V] f32 of the
    appended position `last_offset` (an int, or a [B] tensor of per-row
    offsets; S-1 if None: the true end of a padded suffix), the cache with
    pos advanced by S). With `all_logits`, the logits of every appended
    position [B, S, V], the verification shape. With `pos` ([B] int32 on the
    device), append there and leave cache.pos alone (_forward_cached).
    lws_tpu/models/llama.py:561."""
    x = _forward_cached(params, tokens, cache, plain, pos)
    if all_logits:
        return params.logits(x, plain), cache
    if last_offset is None:
        last = x[:, -1]
    elif isinstance(last_offset, int):
        last = x[:, last_offset]
    else:
        idx = last_offset.long().reshape(-1, 1, 1).expand(x.shape[0], 1, x.shape[-1])
        last = x.gather(1, idx)[:, 0]
    return params.logits(last, plain), cache


@torch.no_grad()
def forward_prefill_chunk(params: Llama, tokens: torch.Tensor, cache: KVCache,
                          plain: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One chunk of chunked prefill: append tokens [B, C] at cache.pos and
    return the final-normalized hidden states [B, C, D] (not logits), so the
    caller can take the true last prompt position out of a padded final
    chunk. lws_tpu/models/llama.py:599."""
    x = _forward_cached(params, tokens, cache, plain)
    return rms_norm(x, params.final_norm, params.cfg.norm_eps), cache


def forward_decode_slotted(params: Llama, tokens: torch.Tensor, cache: KVCache,
                           pos_b: torch.Tensor, plain: bool = False
                           ) -> tuple[torch.Tensor, KVCache]:
    """One decode step with per-slot positions over a dense cache (the
    BatchEngine's step): tokens [B], pos_b [B] int32, each slot's current
    length; forward_with_cache with `pos=pos_b` (a slot past the cache
    writes nothing). Returns (logits [B, V] f32, cache).
    lws_tpu/models/llama.py:696."""
    return forward_with_cache(params, tokens[:, None], cache, plain=plain, pos=pos_b)


# ---------------------------------------------------------------------------
# Paged KV cache


@dataclass
class PagedKVCache:
    """k/v pools [L, num_blocks, block_size, Hkv, hd]. Block 0 is the NULL
    block: unallocated table entries point at it, its contents are never
    attendable (positions mask them), and inactive slots' dead writes land
    there. With cfg.kv_quant, k/v are int8 and k_scale/v_scale
    [L, num_blocks, block_size, Hkv] hold the per-(token, kv head) scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None, mesh=None) -> PagedKVCache:
    """An empty block pool; under a mesh, on the rank's Hkv/tp heads."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads // tp_size(mesh),
             cfg.head_dim)
    if cfg.kv_quant:
        return PagedKVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                            v=torch.zeros(shape, dtype=torch.int8, device=device),
                            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return PagedKVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                        v=torch.zeros(shape, dtype=cfg.dtype, device=device))


@torch.no_grad()
def paged_insert(cache: PagedKVCache, stacked_k: torch.Tensor, stacked_v: torch.Tensor,
                 block_ids: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Scatter a prefilled sequence's K/V [L, S, Hkv, hd] (S a multiple of
    block_size) into pool blocks `block_ids` [S/bs], in place. A quantized
    pool takes the prefill cache's int8 values WITH their scales [L, S, Hkv]:
    values are never re-quantized on the way in."""
    L, S = stacked_k.shape[0], stacked_k.shape[1]
    bs = cache.block_size
    if S % bs or block_ids.numel() != S // bs:
        raise ValueError(f"paged_insert: {S} rows do not fill {block_ids.numel()} blocks of {bs}")
    if cache.k_scale is not None and (k_scale is None or v_scale is None):
        raise ValueError("quantized paged pool: insert requires k_scale/v_scale")
    idx = block_ids.long()
    cache.k[:, idx] = stacked_k.reshape(L, S // bs, bs, *stacked_k.shape[2:]).to(cache.k.dtype)
    cache.v[:, idx] = stacked_v.reshape(L, S // bs, bs, *stacked_v.shape[2:]).to(cache.v.dtype)
    if cache.k_scale is not None:
        cache.k_scale[:, idx] = k_scale.reshape(L, S // bs, bs, -1)
        cache.v_scale[:, idx] = v_scale.reshape(L, S // bs, bs, -1)
    return cache


@torch.no_grad()
def forward_decode_paged(params: Llama, tokens: torch.Tensor, cache: PagedKVCache,
                         block_table: torch.Tensor, pos_b: torch.Tensor, plain: bool = False
                         ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step over paged slots: tokens [B], block_table [B,
    max_blocks] int32, pos_b [B] int32 (each slot's current length). Each
    layer writes the new K/V at (table[b, pos//bs], pos % bs) in place
    (quantized for an int8 pool), then attends through the paged-decode
    kernel (CUDA; the bf16 or the int8 entry) or its plain version (gather,
    dequantize, dense attention). Returns (logits [B, V] f32, cache).
    lws_tpu/models/llama.py:877."""
    cfg = params.cfg
    bs = cache.block_size
    rope_cs = rope_tables(pos_b[:, None], cfg.head_dim, cfg.rope_theta)
    x = params.embed_tokens(tokens[:, None])
    # pos < max_len keeps pos//bs inside the table; the clamp only keeps a
    # bad caller from reading past it.
    blk_idx = torch.clamp(pos_b.long() // bs, max=block_table.shape[1] - 1)
    write_blk = block_table.long().gather(1, blk_idx[:, None])[:, 0]
    write_off = pos_b.long() % bs
    if cache.k_scale is None:
        attn_op = paged_decode_attention_reference if plain else paged_decode_attention
    else:
        attn_op = paged_decode_attention_int8_reference if plain else paged_decode_attention_int8
    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, (write_blk, write_off), k[:, 0], v[:, 0])
            if cache.k_scale is None:
                return attn_op(q, cache.k, cache.v, block_table, pos_b, layer_idx)
            return attn_op(q, cache.k, cache.k_scale, cache.v, cache.v_scale, block_table,
                           pos_b, layer_idx)

        x = block(x, rope_cs, attn_fn, plain)
    return params.logits(x[:, -1], plain), cache


@torch.no_grad()
def forward_verify_paged(params: Llama, tokens: torch.Tensor, cache: PagedKVCache,
                         block_table: torch.Tensor, pos_b: torch.Tensor, plain: bool = False
                         ) -> tuple[torch.Tensor, PagedKVCache]:
    """Speculative verification over paged slots: append tokens [B, S] (the
    running token and S-1 drafts per slot) at positions pos_b..pos_b+S-1 and
    return the logits of all S positions [B, S, V] f32. Each layer scatters
    its S new K/V rows per slot into the slot's table blocks in place
    (quantized for an int8 pool), then attends through the gathered table
    view (dequantized for an int8 pool) with per-slot positions. Rows past
    the accepted prefix go stale and are overwritten by later appends: pos_b
    is the rewind. Positions past a slot's allocated blocks hit table
    entries of 0, the null block, never attended. The gather path of
    lws_tpu/models/llama.py:1002 (JAX runs no kernel here either); with
    quantized weights the products still take the int8_matmul kernel on
    CUDA (B * S rows)."""
    cfg = params.cfg
    B, S = tokens.shape
    bs = cache.block_size
    hkv, hd = cache.k.shape[3], cfg.head_dim  # the rank's KV heads under a mesh
    positions = pos_b.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
    rope_cs = rope_tables(positions, hd, cfg.rope_theta)
    x = params.embed_tokens(tokens)
    # Callers keep every live row below max_len (the engine's _spec_fits);
    # the clamp only keeps a released slot's stale position inside the table.
    blk_idx = torch.clamp(positions // bs, max=block_table.shape[1] - 1)
    write_blk = block_table.long().gather(1, blk_idx)
    write_off = positions % bs
    idx = block_table.long()

    def view(pool, layer_idx, scale=None):
        rows = pool[layer_idx][idx]  # [B, max_blocks, bs, Hkv, hd]
        if scale is not None:
            rows = _dequantize_kv(rows, scale[layer_idx][idx], cfg.dtype)
        return rows.reshape(B, -1, hkv, hd)

    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, (write_blk, write_off), k, v)
            return _cached_attention(q, view(cache.k, layer_idx, cache.k_scale),
                                     view(cache.v, layer_idx, cache.v_scale), pos_b)

        x = block(x, rope_cs, attn_fn, plain)
    return params.logits(x, plain), cache


# ---------------------------------------------------------------------------
# Device-resident speculative decoding primitives (lws_tpu/models/llama.py:1082-1135)


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, ngram: int, gamma: int
                ) -> torch.Tensor:
    """Prompt-lookup drafts for a batch of slots: hist [B, H] int32 holds
    global token t of each slot at column t % H, hist_len [B] the tokens ever
    recorded, so the live window is the last min(hist_len, H). The latest
    earlier occurrence of the window's trailing `ngram` wins and the `gamma`
    tokens after it are the draft; short or absent candidates pad with the
    last token. Returns [B, gamma] int32. Equals Engine._draft_ngram whenever
    the window holds the whole context (lws_tpu/models/llama.py:1087, vmapped
    over slots)."""
    B, H = hist.shape
    dev = hist.device
    total = hist_len.long()
    W = torch.clamp(total, max=H)  # live window length
    start = total - W  # global index of window[0]
    j = torch.arange(H, device=dev)
    lin = hist.gather(1, (start[:, None] + j[None, :]) % H)  # lin[:, j] valid for j < W
    last = lin.gather(1, torch.clamp(W - 1, 0, H - 1)[:, None])  # [B, 1]
    k = torch.arange(ngram, device=dev)
    tail = lin.gather(1, torch.clamp(W[:, None] - ngram + k[None, :], 0, H - 1))  # [B, ngram]
    cand = lin[:, torch.clamp(j[:, None] + k[None, :], 0, H - 1)]  # [B, H, ngram]
    # A start must be a strictly EARLIER occurrence; short windows match nothing.
    ok = (cand == tail[:, None, :]).all(dim=-1) & (j[None, :] <= W[:, None] - ngram - 1)
    best = torch.where(ok, j[None, :], -1).amax(dim=1)  # [B]
    idx = best[:, None] + ngram + torch.arange(gamma, device=dev)[None, :]
    in_window = (best[:, None] >= 0) & (idx < W[:, None])
    drafts = torch.where(in_window, lin.gather(1, torch.clamp(idx, 0, H - 1)), last)
    return drafts.to(torch.int32)


def speculative_accept(drafts: torch.Tensor, greedy: torch.Tensor, rem: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Acceptance of a verify pass: drafts [B, gamma], greedy [B, gamma+1]
    (the verify logits' argmax), rem [B] remaining budgets. The accepted
    prefix is the run of leading matches; returns (take [B] int32,
    out [B, gamma+1]) where out[b, :take[b]] are the slot's tokens this
    dispatch: the accepted drafts and the model's own next token, clamped to
    the budget (lws_tpu/models/llama.py:1117)."""
    gamma = drafts.shape[1]
    matches = (drafts == greedy[:, :gamma]).to(torch.int32)
    a = torch.cumprod(matches, dim=1).sum(dim=1)  # [B] accepted prefix
    pos = torch.arange(gamma + 1, device=drafts.device)[None, :]
    ext = torch.cat([drafts, drafts[:, -1:]], dim=1)  # [B, gamma+1]
    bonus = greedy.gather(1, a[:, None].long())  # [B, 1]
    out = torch.where(pos == a[:, None], bonus, ext)
    take = torch.minimum(a + 1, rem.to(a.dtype)).to(torch.int32)
    return take, out
