"""Checkpoint and restore of a training state, the port of
lws_tpu/models/checkpoint.py (orbax there).

A checkpoint is a directory of per-rank files, `shard-<rank>-of-<world>.pt`
(torch.save). Each entry is one shard of one global tensor, stored with its
global placement: the parameter's full-model name (a pp stage's layer j is
the model's layer s * L/pp + j), the offset of the shard in every dim and
the global shape. A tensor is written once: by the rank at index 0 of every
mesh axis it is replicated over (models/train.state_shardings), so dp and
cp replicas, tp-replicated norms and pp-replicated embeddings are not
stored again. Restoring builds the target mesh's shards and copies into each
the parts of the stored shards that overlap it, so a checkpoint restores
into the mesh it was saved from and into another factorization of the
model, as orbax does. Files are opened with torch.load(mmap=True): a rank
pages in only the bytes of the shards it copies from.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import torch
import torch.distributed as dist

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.models.llama import Llama, global_param_name, shard_dim
from lws_tpu_torch.models.train import AdamW, TrainState, state_shardings

__all__ = ["save_checkpoint", "restore_checkpoint"]


def _placement(name: str, local: torch.Tensor, cfg, mesh) -> tuple[str, tuple, tuple]:
    """(global name, offset, global shape) of a rank's tensor `name`."""
    gname = global_param_name(name, cfg.n_layers, mesh)
    offset, shape = [0] * local.dim(), list(local.shape)
    dim = shard_dim(gname, cfg.n_experts)
    if mesh is not None and mesh.tp > 1 and dim is not None:
        offset[dim] = mesh.tp_rank * local.shape[dim]
        shape[dim] = local.shape[dim] * mesh.tp
    return gname, tuple(offset), tuple(shape)


def _sync(mesh) -> None:
    if mesh is not None:
        dist.barrier()


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write `state` under directory `path` (replacing a checkpoint there).
    Every rank of the mesh calls it."""
    params = state.params
    cfg, mesh = params.cfg, params.mesh
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.spec.size)
    shardings = state_shardings(cfg, mesh)
    entries = {}
    for name, p in params.named_parameters():
        if mesh is not None and any(mesh.coords[a] for a in shardings[name]["replicated"]):
            continue  # another rank writes this replica
        gname, offset, shape = _placement(name, p, cfg, mesh)
        for kind, t in (("params", p), ("mu", state.opt_state["mu"][name]),
                        ("nu", state.opt_state["nu"][name])):
            entries[f"{kind}/{gname}"] = {"offset": offset, "shape": shape,
                                          "tensor": t.detach().cpu()}
    if rank == 0:
        entries["count"] = {"tensor": state.opt_state["count"].cpu()}
        entries["step"] = {"tensor": torch.tensor(int(state.step))}
        os.makedirs(path, exist_ok=True)
        for old in glob.glob(os.path.join(path, "shard-*.pt")):
            os.remove(old)
    _sync(mesh)
    torch.save(entries, os.path.join(path, f"shard-{rank:05d}-of-{world:05d}.pt"))
    _sync(mesh)


def _overlap(dst: torch.Tensor, d_off: tuple, src: torch.Tensor, s_off: tuple) -> int:
    """Copy the part of `src` (placed at s_off) that overlaps `dst` (placed
    at d_off) into `dst`; returns the elements copied."""
    d_idx, s_idx = [], []
    for do, dn, so, sn in zip(d_off, dst.shape, s_off, src.shape):
        lo, hi = max(do, so), min(do + dn, so + sn)
        if lo >= hi:
            return 0
        d_idx.append(slice(lo - do, hi - do))
        s_idx.append(slice(lo - so, hi - so))
    part = src[tuple(s_idx)]
    dst[tuple(d_idx)] = part.to(dst.device)
    return part.numel()


@torch.no_grad()
def restore_checkpoint(path: str, cfg, mesh=None, optimizer: Optional[AdamW] = None,
                       device: DeviceLike = None) -> TrainState:
    """The TrainState saved under `path`, as the shards of `mesh` (the one
    it was saved from, or another factorization) on `device` (the GPU unless
    asked)."""
    optimizer = optimizer or AdamW()
    dev = resolve_device(device)
    params = Llama(cfg, dev, mesh=mesh)
    opt_state = optimizer.init(params)
    targets = {}
    for name, p in params.named_parameters():
        gname, offset, _ = _placement(name, p, cfg, mesh)
        for kind, t in (("params", p), ("mu", opt_state["mu"][name]),
                        ("nu", opt_state["nu"][name])):
            targets[f"{kind}/{gname}"] = (t, offset)
    files = sorted(glob.glob(os.path.join(path, "shard-*.pt")))
    if not files:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    step, copied = None, dict.fromkeys(targets, 0)
    for f in files:
        entries = torch.load(f, mmap=True, weights_only=True)
        for key, e in entries.items():
            if key == "count":
                opt_state["count"] = e["tensor"].to(dev)
            elif key == "step":
                step = int(e["tensor"])
            elif key in targets:
                dst, offset = targets[key]
                if tuple(e["shape"]) != tuple(_global_shape(dst, key, cfg, mesh)):
                    raise ValueError(f"checkpoint {key} is {tuple(e['shape'])}, "
                                     f"the config gives {_global_shape(dst, key, cfg, mesh)}")
                copied[key] += _overlap(dst, offset, e["tensor"], e["offset"])
    if step is None:
        raise ValueError(f"checkpoint under {path} has no rank-0 file")
    missing = [k for k, n in copied.items() if n != targets[k][0].numel()]
    if missing:
        raise ValueError(f"checkpoint under {path} does not cover {missing[:4]}")
    return TrainState(step=step, params=params, opt_state=opt_state)


def _global_shape(t: torch.Tensor, key: str, cfg, mesh) -> tuple:
    gname = key.split("/", 1)[1]
    shape = list(t.shape)
    dim = shard_dim(gname, cfg.n_experts)
    if mesh is not None and mesh.tp > 1 and dim is not None:
        shape[dim] *= mesh.tp
    return tuple(shape)
