"""Ring attention: exact causal attention over a context-parallel group, the
port of lws_tpu/ops/ring.py.

The sequence is split over the group in equal contiguous chunks: rank r
holds tokens [r * chunk, (r + 1) * chunk) of q, k and v. K/V chunks rotate
around the group (parallel.collectives.ppermute, one hop to the next rank a
step); each rank folds every chunk into its online-softmax accumulators,
so the [S, S] matrix never exists anywhere and attention memory stays
O(S / n) per rank. The per-chunk step is plain torch in f32, as JAX's is
XLA: JAX's flash kernel returns no log-sum-exp and has no backward, so no
kernel stands in for it. Gradients flow through autograd: the ppermute's
backward sends each chunk's gradient back the way the chunk came.

There is no shard_map in torch: the tensors a rank passes ARE its chunks,
and `group` is the cp process group (None, or a group of one rank: the ring
of one rank, dense attention in chunked form).
"""

from __future__ import annotations

import torch

from lws_tpu_torch.parallel.collectives import group_rank, group_size, ppermute

NEG_INF = -1e30

__all__ = ["NEG_INF", "ring_attention", "ring_attention_inner"]


def _chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                     k_offset: int, causal: bool):
    """Partial (unnormalized) attention of a q chunk against one k/v chunk
    (lws_tpu/ops/ring.py:23). Returns (m, l, acc): the row max, the row sum
    and the weighted values, f32, [B, Hkv, G, Sq] and [B, Hkv, G, Sq, D]."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float() * D**-0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return m, l, acc


def ring_attention_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                         causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sq, Hkv, D]: this rank's chunks of the
    sequence; returns its chunk of the attention output [B, Sq, H, D] in q's
    dtype (lws_tpu/ops/ring.py:43). Chunks are equal and rank r's offset is
    r * Sq; step i folds in the chunk of rank (r - i) % n. JAX rotates K/V
    once more after the last step and drops the result; the port does not
    send it."""
    n, rank = group_size(group), group_rank(group)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    chunk = Sq
    q_offset = rank * chunk
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src_rank = (rank - i) % n
        cm, cl, cacc = _chunk_attention(q, k_cur, v_cur, q_offset, src_rank * chunk, causal)
        m_new = torch.maximum(m, cm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(cm - m_new)
        l = l * alpha + cl * beta
        acc = acc * alpha[..., None] + cacc * beta[..., None]
        m = m_new
        if i < n - 1:
            k_cur, v_cur = ppermute((k_cur, v_cur), group, 1)
    l = torch.clamp(l, min=1e-30)  # fully-masked rows (never in causal self-attention)
    out = (acc / l[..., None]).to(q.dtype)  # [B, Hkv, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   causal: bool = True) -> torch.Tensor:
    """The ring over `group` (lws_tpu/ops/ring.py:79): q [B, S/n, H, D] and
    k/v [B, S/n, Hkv, D] are this rank's chunks (under tp, its heads), the
    result its chunk of the output. JAX's `batch_axis`/`head_axis` have no
    counterpart: a rank's batch rows and heads are simply the tensors it
    holds."""
    return ring_attention_inner(q, k, v, group, causal)
