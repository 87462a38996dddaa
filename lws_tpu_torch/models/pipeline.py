"""GPipe microbatch pipelining over the mesh's pp group: the port of
lws_tpu/models/pipeline.py.

Each pp rank holds the L/pp layers of its stage (models/llama.py: a `Llama`
under a pp mesh) and runs JAX's schedule:

    step t: stage 0 ingests microbatch t; every stage applies its local
    layers; activations ppermute to the next stage; the last stage banks
    microbatch t-(pp-1).

M + pp - 1 steps, bubble fraction (pp-1)/(M+pp-1). As in JAX every stage
computes at every step, bubble steps on stale or zero activations, and
their aux is masked; the choice of a stage's input and the banking are
selects on a per-rank mask (torch.where), so every stage builds the same
autograd graph and posts the same collectives in the backward, which then
runs the mirrored reverse schedule (ppermute's backward shifts the other
way). JAX's last ppermute, whose result no stage reads, is not sent. The
last stage's banked outputs reach every stage through `psum` of a masked
value (JAX's _bcast_from_last), and the stages' aux through `psum`, both
with the identity backward: every stage then computes the same loss, and
its gradient is that loss's. The embedded input enters through `copy_to`
over pp: only stage 0 reads it, so its gradient is summed over the stages.

JAX's _cpu_safe_dtype has no counterpart: it works around an XLA CPU abort
on the transpose of bf16 collectives that torch does not have.
"""

from __future__ import annotations

import torch

from lws_tpu_torch.models.llama import rope_tables, run_block, _attention_fn
from lws_tpu_torch.parallel.collectives import copy_to, group_rank, group_size, ppermute, psum


def pipeline_forward(params, x: torch.Tensor, positions: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, s, D] embedded activations (the rank's dp rows and its share
    of the sequence over tp, s = ceil(S / tp); replicated over pp),
    positions [B, S]; returns (x after every layer [B, s, D], the layers'
    aux summed over stages, averaged over microbatches). Splits B into
    cfg.pipeline_microbatches = M microbatches of B/M rows
    (lws_tpu/models/pipeline.py:41); a stage's layers are params.layers,
    each run with cfg.remat as the weight-gathered path runs it. The
    microbatch state and each ppermute carry the tp share, as JAX keeps the
    pipeline's activations sharded over tp and never over cp
    (_no_cp_activations), so a hop moves 1/tp of the bytes."""
    cfg, mesh = params.cfg, params.mesh
    M = cfg.pipeline_microbatches
    B, S, D = x.shape
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by pipeline_microbatches={M}")
    group = None if mesh is None else mesh.pp_group
    stage, n_stage = group_rank(group), group_size(group)
    attn_fn = _attention_fn(cfg, mesh)
    x_mb = copy_to(x, group).reshape(M, B // M, S, D)
    pos_mb = positions.reshape(M, B // M, positions.shape[1])
    is_first = torch.tensor(stage == 0, device=x.device)
    is_last = torch.tensor(stage == n_stage - 1, device=x.device)

    def apply_stage(h, pos):
        rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        aux = torch.zeros((), device=h.device)
        for block in params.layers:
            h, a = run_block(block, h, rope_cs, attn_fn, cfg.remat)
            aux = aux + a
        return h, aux

    state = torch.zeros_like(x_mb[0])
    aux_total = torch.zeros((), device=x.device)
    banked = [None] * M
    steps = M + n_stage - 1
    for t in range(steps):
        inp = torch.where(is_first, x_mb[min(t, M - 1)], state)
        # Positions travel with the schedule: the microbatch reaching stage s
        # at step t entered at step t - s.
        out, aux = apply_stage(inp, pos_mb[min(max(t - stage, 0), M - 1)])
        valid = torch.tensor(0 <= t - stage < M, device=x.device)
        aux_total = aux_total + torch.where(valid, aux, torch.zeros_like(aux))
        mb_out = t - (n_stage - 1)
        if mb_out >= 0:  # the last stage banks its finished microbatch
            banked[mb_out] = torch.where(is_last, out, torch.zeros_like(out))
        if t < steps - 1:
            (state,) = ppermute((out,), group, 1)
    out_mb = psum(torch.stack(banked), group)  # replicate the last stage's value
    return out_mb.reshape(B, S, D), psum(aux_total, group) / M
