"""Training step: AdamW and the gradient over the (sharded) model, the port
of lws_tpu/models/train.py.

`make_optimizer` is optax's chain(clip_by_global_norm(1.0), adamw(lr,
b1=0.9, b2=0.95, eps=1e-8, weight_decay)) written on tensors, step for step:
the global norm is sqrt(sum of squares) over every gradient, and the clip
is optax's select(norm < 1, g, g / norm * 1) (not clip_grad_norm_, whose
+1e-6 differs); the moments are (1 - b) * g^order + b * moment; bias
correction divides by 1 - b^count with optax's count (incremented first);
the update is mu_hat / (sqrt(nu_hat) + eps) plus weight_decay * param,
decoupled and applied to every parameter, norms included (optax's unmasked
adamw), times -lr, added to the parameter.

Under a mesh the state is sharded as the parameters are (JAX's
state_shardings: the moments inherit the parameter layout): each rank holds
the moments of the parameter shards it holds (`state_shardings` names
them). A step sums each gradient over the data group (dp, and cp with
cfg.context_parallel: the ranks that saw different tokens; the loss was
normalized by the global token count, so the sum is the gradient), and the
norms' gradients over tp too (sequence parallelism: each tp rank
normalizes its share of the positions); the norm for the clip counts every
tp or pp shard once and every replicated tensor once. The parameters are updated in place: `run` returns the same
`Llama` (JAX returns new, donated buffers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.models.llama import (
    LAYER_NORMS,
    Llama,
    LlamaConfig,
    init_params,
    loss_fn,
    shard_dim,
)

__all__ = ["TrainState", "AdamW", "make_optimizer", "state_shardings", "init_train_state",
           "make_train_step", "dp_rows", "global_norm", "value_and_grad"]


@dataclass
class TrainState:
    step: int
    params: Llama
    opt_state: dict


@dataclass(frozen=True)
class AdamW:
    """optax.chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.95,
    eps=1e-8, weight_decay)) on dicts of tensors keyed by parameter name
    (lws_tpu/models/train.py:make_optimizer's constants)."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    b1 = 0.9
    b2 = 0.95
    eps = 1e-8
    max_norm = 1.0

    def init(self, params) -> dict:
        """{"count": int32 0, "mu": zeros, "nu": zeros} (optax's
        ScaleByAdamState; clip and decay keep no state) for a dict of
        tensors or a `Llama`'s parameters."""
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        some = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32, device=some.device),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict,
               g_norm: Optional[torch.Tensor] = None) -> tuple[dict, dict]:
        """optax's update: (updates, new state). `g_norm` is the global
        norm of the gradients (global_norm over these if None; a sharded
        step passes the mesh's)."""
        names = list(grads)
        g = [grads[n] for n in names]
        if g_norm is None:
            g_norm = global_norm(g)
        trigger = g_norm < self.max_norm
        one = torch.ones((), device=g_norm.device)
        # select(trigger, t, (t / norm) * max_norm): t / 1 * 1 is t exactly.
        # In-place steps on fresh lists keep fewer full-size temporaries
        # alive; each computes what optax's expression does, in its order.
        g = torch._foreach_div(g, torch.where(trigger, one, g_norm))
        torch._foreach_mul_(g, torch.where(trigger, one, one * self.max_norm))
        mu = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul([state["mu"][n] for n in names], self.b1))
        torch._foreach_mul_(g, g)  # g ** 2
        torch._foreach_mul_(g, 1 - self.b2)
        torch._foreach_add_(g, torch._foreach_mul([state["nu"][n] for n in names], self.b2))
        nu, g = g, None
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - torch.pow(torch.full((), self.b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), self.b2, device=c.device), c)
        upd = torch._foreach_div(mu, bc1)  # mu_hat
        den = torch._foreach_div(nu, bc2)  # nu_hat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul([params[n] for n in names], self.weight_decay))
        torch._foreach_mul_(upd, -self.lr)
        return (dict(zip(names, upd)),
                {"count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))})


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def global_norm(grads: list, counted: Optional[list] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of `grads` (optax.global_norm); with
    `counted`, only the tensors flagged True enter this rank's sum, which is
    then summed over `group` (every rank of the mesh)."""
    dev = grads[0].device
    if counted is not None:
        grads = [t for t, c in zip(grads, counted) if c]
    sq = torch.zeros((), device=dev)
    for t in grads:
        sq = sq + torch.sum(t.float() * t.float())
    if group is not None:
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def state_shardings(cfg: LlamaConfig, mesh) -> dict:
    """For every parameter name a rank's `Llama` holds: the mesh axes its
    tensor (and its two moments) is split over ("tp" when shard_dim splits
    it, "pp" for a layer when pp > 1) and the axes it is replicated over.
    The norm counts a tensor on a rank only at index 0 of each axis it is
    replicated over."""
    out = {}
    for name, _ in Llama(cfg, "meta", mesh=mesh).named_parameters():
        split = set()
        if mesh is not None and mesh.tp > 1 and shard_dim(name, cfg.n_experts) is not None:
            split.add("tp")
        if mesh is not None and mesh.pp > 1 and name.startswith("layers."):
            split.add("pp")
        out[name] = {"split": sorted(split),
                     "replicated": sorted({"dp", "pp", "cp", "tp"} - split)}
    return out


def _counted(cfg: LlamaConfig, mesh) -> list[bool]:
    sh = state_shardings(cfg, mesh)
    return [all(mesh.coords[a] == 0 for a in s["replicated"]) for s in sh.values()]


def init_train_state(cfg: LlamaConfig, mesh=None, optimizer: Optional[AdamW] = None,
                     seed: int = 0, device: DeviceLike = None) -> TrainState:
    """Parameters drawn from a torch.Generator seeded `seed` (init_params:
    each rank keeps its own shards of the same full weights, never holding
    the full model) and zero moments on `device` (the GPU unless asked)."""
    optimizer = optimizer or make_optimizer()
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev, mesh=mesh)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def dp_rows(tokens: torch.Tensor, cfg: LlamaConfig, mesh) -> torch.Tensor:
    """The rank's rows of a global batch [B, ...] split over dp: contiguous
    blocks of B/dp rows, or with cfg.pipeline_microbatches = M the rank's
    B/(M dp) rows of each microbatch of B/M rows, so the rank's microbatch m
    is its share of JAX's microbatch m (the MoE aux is per microbatch)."""
    if mesh is None or mesh.dp == 1:
        return tokens
    B, dp, d = tokens.shape[0], mesh.dp, mesh.dp_rank
    M = max(cfg.pipeline_microbatches, 1)
    if B % (M * dp):
        raise ValueError(f"batch {B} not divisible by dp={dp} x microbatches={M}")
    per = B // (M * dp)
    mbs = tokens.reshape(M, dp, per, *tokens.shape[1:])
    return mbs[:, d].reshape(M * per, *tokens.shape[1:])


def _sequence_split(name: str) -> bool:
    """Whether a parameter acts on the rank's sequence share over tp in
    training: the norms (tp-replicated, applied between the sequence
    all-gathers and reduce-scatters), whose gradient on a tp rank covers
    only its positions."""
    return name == "final_norm" or name.rpartition(".")[2] in LAYER_NORMS


def value_and_grad(params: Llama, tokens: torch.Tensor, mesh=None) -> tuple:
    """(loss, {"ce", "aux"}, grads): loss_fn over the rank's rows of the
    global batch `tokens` and the gradient of every parameter the rank
    holds, summed over the data group (jax.value_and_grad(loss_fn) under
    the mesh). The norms' gradients are also summed over tp, in one
    all-reduce: with sequence parallelism each tp rank normalizes only its
    share of the positions. Leaves no .grad behind."""
    cfg = params.cfg
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = loss_fn(params, {"tokens": dp_rows(tokens, cfg, mesh)})
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named.items()}
    for p in named.values():
        p.grad = None
    data = None if mesh is None else mesh.data_group(cfg.context_parallel)
    if data is not None and dist.get_world_size(data) > 1:
        for g in grads.values():
            dist.all_reduce(g, group=data)
    if mesh is not None and mesh.tp > 1:
        norms = [g for n, g in grads.items() if _sequence_split(n)]
        flat = torch.cat([g.reshape(-1) for g in norms])
        dist.all_reduce(flat, group=mesh.tp_group)
        for g, f in zip(norms, flat.split([g.numel() for g in norms])):
            g.copy_(f.view_as(g))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: LlamaConfig, mesh=None, optimizer: Optional[AdamW] = None):
    """`run(params, opt_state, batch) -> (params, opt_state, loss,
    {"ce", "aux"})` (lws_tpu/models/train.py:98): batch = {"tokens": the
    global [B, S+1] batch} (numpy or a tensor); every rank passes the same
    batch and takes its rows (dp_rows). `mesh=None` is one device with no
    collective. The loss and metrics are the global batch's; params are
    updated in place."""
    optimizer = optimizer or make_optimizer()
    counted = None if mesh is None else _counted(cfg, mesh)

    def run(params: Llama, opt_state: dict, batch: dict):
        tokens = torch.as_tensor(batch["tokens"]).to(params.device)
        loss, metrics, grads = value_and_grad(params, tokens, mesh)
        g_norm = global_norm(list(grads.values()), counted,
                             None if mesh is None else dist.group.WORLD)
        named = dict(params.named_parameters())
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, named, g_norm)
            torch._foreach_add_([named[n] for n in updates], list(updates.values()))
        return params, opt_state, loss, metrics

    return run
