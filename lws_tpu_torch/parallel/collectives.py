"""The collectives the training path differentiates through, each a
torch.autograd.Function whose backward is the transpose JAX gives the same
collective inside shard_map (lws_tpu/ops/ring.py, lws_tpu/models/pipeline.py)
or that GSPMD gives the Megatron layout of lws_tpu/models/llama.py:
param_shardings.

  * `copy_to(x, group)`: identity forward, all-reduce backward. It stands at
    the input of a computation split over the group (the column-parallel
    products, a rank's experts, the pipeline's replicated input), whose
    ranks each see a part of the input's gradient.
  * `psum(x, group)`: all-reduce forward, identity backward. It ends a
    computation split over the group (after wo, the FFN, the masked
    embedding, the pipeline's broadcast from the last stage and its aux):
    the sum is then replicated, every rank computes the same loss from it,
    and the gradient each rank holds is the one gradient of the sum.
  * `all_gather(x, group, dim)`: the group's tensors concatenated along
    `dim` in rank order; backward, the rank's own slice of the gradient
    (the lm_head's vocabulary shards, the weight-gathered layer stack: every
    rank's consumer is a replica of the same computation).
  * `all_gather_partial(x, group, dim)`: the same forward; backward, a
    reduce-scatter (the gradient summed over the group, each rank keeping
    its slice): the consumers are not replicas (the column-parallel
    products a training block feeds from its sequence share, the lm_head
    fed from the final norm's share, the MoE's dispatch over a cp-split
    sequence, where each rank keeps its own chunk of the output).
  * `reduce_scatter(x, group, dim)`: the group's tensors summed and split
    evenly along `dim`, rank r keeping part r; backward, an all-gather. It
    ends a computation split over the group in place of `psum` when each
    rank goes on with its share of the sequence (JAX's _seq_shard after
    wo, the FFN and the masked embedding in training).
  * `ppermute(tensors, group, shift)`: rank r's tensors go to rank
    (r + shift) % n of the group, one batch of sends and receives; backward,
    the gradients travel the other way.

Three host-driven helpers serve the disaggregated handoff under a mesh,
outside autograd (they move K/V, not activations):

  * `broadcast_object(obj, group)`: a small picklable host object (a
    command, a bundle's array specs, a prefix fetch's result) from the
    group's rank 0 to every rank;
  * `gather_heads(x, group, dim)`: KV-head shards ([L, B, T, Hkv/tp, hd]
    values or [L, B, T, Hkv/tp] scales, heads at `dim`) into the full
    heads, in rank order, on every rank: what JAX's np.asarray of a
    tp-sharded cache gives;
  * `scatter_heads(full, shape, dtype, device, group, dim)`: its inverse,
    rank 0's full heads split by head, rank r receiving slice r (of local
    `shape`): what jax.device_put onto the cache's shardings does.

They run over NCCL on CUDA tensors and over gloo on the CPU.

`group=None` means no group: every function returns its input. A group of
one rank still runs its collective (a copy), except `ppermute`, whose
one-rank shift is the identity, and `reduce_scatter` and
`all_gather_partial`, whose one-rank forms are the identity (so sequence
parallelism at tp = 1 runs no collective). Peers of a point-to-point are named by
their global rank (dist.get_global_rank), as batch_isend_irecv requires
over a subgroup.

Under torch.no_grad (serving) `psum` all-reduces its argument in place and
returns it, and `all_gather`, `all_gather_partial` and `reduce_scatter` run
their collective without the autograd Function's host cost: no autograd
node is built.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

# all_gather_into_tensor was renamed all_gather_single (torch 2.13).
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
# reduce_scatter_tensor likewise became reduce_scatter_single.
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    flat = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _all_gather_single(flat, x.contiguous(), group=group)
    # [n, ...x] in rank order; n moves in front of `dim` and merges with it.
    parts = flat.reshape(n, *x.shape).movedim(0, dim)
    return parts.reshape(*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])


def _own_slice(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    return g.chunk(n, dim=dim)[group_rank(group)].contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """x summed over the group, rank r keeping part r of n equal parts
    along `dim` (the size at `dim` must divide by n)."""
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: size {x.shape[dim]} at dim {dim} "
                         f"not divisible by the group's {n} ranks")
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    _reduce_scatter_single(out, front, group=group)
    return out.movedim(0, dim)


def _shift(tensors: Sequence[torch.Tensor], group, shift: int) -> list[torch.Tensor]:
    n = group_size(group)
    me = group_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _own_slice(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(_shift(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        # Unused outputs arrive as zeros (materialized grads), so every rank
        # of the group posts the same shift.
        return (None, None, *_shift(grads, ctx.group, -ctx.shift))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    if not torch.is_grad_enabled():
        dist.all_reduce(x, group=group)
        return x
    return _Psum.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group is None:
        return x
    if not torch.is_grad_enabled():
        return _gather(x, group, dim % x.dim())
    return _AllGather.apply(x, group, dim % x.dim(), False)


def all_gather_partial(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    if not torch.is_grad_enabled():
        return _gather(x, group, dim % x.dim())
    return _AllGather.apply(x, group, dim % x.dim(), True)


def reduce_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    if not torch.is_grad_enabled():
        return _reduce_scatter(x, group, dim % x.dim())
    return _ReduceScatter.apply(x, group, dim % x.dim())


def ppermute(tensors: Sequence[torch.Tensor], group: Optional[object],
             shift: int = 1) -> tuple[torch.Tensor, ...]:
    if group_size(group) == 1:
        return tuple(tensors)
    return _Ppermute.apply(group, shift, *tensors)


def broadcast_object(obj, group):
    """`obj` as the group's rank 0 holds it, on every rank of `group`
    (the other ranks' argument is ignored)."""
    if group is None:
        return obj
    box = [obj if group_rank(group) == 0 else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def gather_heads(x: torch.Tensor, group, dim: int = 3) -> torch.Tensor:
    """Every rank's head shard `x` concatenated along `dim` in rank order,
    on every rank."""
    if group is None:
        return x
    with torch.no_grad():
        return _gather(x, group, dim % x.dim())


def scatter_heads(full: Optional[torch.Tensor], shape: Sequence[int], dtype: torch.dtype,
                  device, group, dim: int = 3) -> torch.Tensor:
    """Rank r of `group` gets slice r (of `shape`) of rank 0's `full` split
    evenly along `dim`; the other ranks pass full=None."""
    if group is None:
        return full
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    parts = None
    if group_rank(group) == 0:
        parts = [c.contiguous() for c in full.chunk(group_size(group), dim=dim)]
    dist.scatter(out, parts, src=dist.get_global_rank(group, 0), group=group)
    return out
