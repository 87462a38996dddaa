"""The group's mesh: the port of lws_tpu/parallel/mesh.py.

Axis conventions are the JAX package's: dp (data parallel), pp (pipeline
stages; subgroup i = stage i), cp (context parallel) and tp (tensor
parallel; expert parallelism rides tp). `MeshSpec`, `auto_meshspec` and the
contract-to-shape rule of `mesh_from_bootstrap` (`meshspec_from_bootstrap`)
are JAX's arithmetic with JAX's errors. JAX lays devices out as
reshape(dp, pp, cp, tp); the port lays out the group's ranks the same way
(one rank = one process = one device), so rank r sits at tp index r % tp
and holds JAX's tp shard of that index.

`build_mesh` returns a `Mesh` over every rank of the started group: this
rank's coordinates plus one process group along each axis (tp for the
all-reduces and the vocab all-gather, dp for the dense engine's token
gather and the training batch, pp for the pipeline's stages and the
weight-gathered layer stack, cp for the ring) and one over dp and cp
together (the ranks whose gradients a training step sums when the sequence
splits over cp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    pp: int = 1
    tp: int = 1
    cp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp * self.cp

    def axis_names(self) -> tuple[str, ...]:
        return ("dp", "pp", "cp", "tp")


def auto_meshspec(n_devices: int, prefer_tp: int = 0, pp: int = 1, cp: int = 1) -> MeshSpec:
    """Factor n_devices into (dp, pp, cp, tp): tp gets the largest power-of-two
    up to prefer_tp (or up to n/(pp*cp) if unset), dp absorbs the rest."""
    assert n_devices % (pp * cp) == 0, f"{n_devices} devices not divisible by pp*cp={pp * cp}"
    rest = n_devices // (pp * cp)
    tp = prefer_tp or rest
    while rest % tp != 0:
        tp //= 2
    tp = max(1, tp)
    return MeshSpec(dp=rest // tp, pp=pp, cp=cp, tp=tp)


class Mesh:
    """Rank `rank`'s place on the (dp, pp, cp, tp) grid of the group's ranks
    0..size-1: `coords[axis]` is its index along each axis, `groups[axis]`
    the process group of its row along that axis (and `groups["dp_cp"]` the
    ranks that share its pp and tp coordinates)."""

    def __init__(self, spec: MeshSpec, rank: int, groups: dict) -> None:
        self.spec = spec
        self.rank = rank
        grid = np.arange(spec.size).reshape(spec.dp, spec.pp, spec.cp, spec.tp)
        where = np.argwhere(grid == rank)[0]
        self.coords = dict(zip(spec.axis_names(), (int(i) for i in where)))
        self.groups = groups

    @property
    def shape(self) -> dict[str, int]:
        return {a: getattr(self.spec, a) for a in self.spec.axis_names()}

    @property
    def tp(self) -> int:
        return self.spec.tp

    @property
    def dp(self) -> int:
        return self.spec.dp

    @property
    def pp(self) -> int:
        return self.spec.pp

    @property
    def cp(self) -> int:
        return self.spec.cp

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def dp_rank(self) -> int:
        return self.coords["dp"]

    @property
    def pp_rank(self) -> int:
        return self.coords["pp"]

    @property
    def cp_rank(self) -> int:
        return self.coords["cp"]

    @property
    def tp_group(self):
        return self.groups["tp"]

    @property
    def dp_group(self):
        return self.groups["dp"]

    @property
    def pp_group(self):
        return self.groups["pp"]

    @property
    def cp_group(self):
        return self.groups["cp"]

    def data_group(self, context_parallel: bool):
        """The ranks that hold different data of one step: dp, and cp too
        when the sequence splits over it (cfg.context_parallel); otherwise
        cp ranks hold the same sequence and compute the same numbers."""
        return self.groups["dp_cp"] if context_parallel else self.groups["dp"]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def build_mesh(spec: MeshSpec) -> Mesh:
    """The mesh `spec` over every rank of the started group, in rank order.
    Every rank must call it, in the same order as its other group creations
    (torch.distributed.new_group's rule)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("build_mesh: torch.distributed is not initialized "
                           "(parallel.initialize_from_env, group_of_one=True for one process)")
    world = dist.get_world_size()
    if world != spec.size:
        raise ValueError(f"mesh spec {spec} needs {spec.size} devices, have {world}")
    me = dist.get_rank()
    grid = np.arange(world).reshape(spec.dp, spec.pp, spec.cp, spec.tp)
    groups = {}
    names = spec.axis_names()
    for key, axes in (("dp", ("dp",)), ("pp", ("pp",)), ("cp", ("cp",)), ("tp", ("tp",)),
                      ("dp_cp", ("dp", "cp"))):
        idx = [names.index(a) for a in axes]
        size = int(np.prod([grid.shape[i] for i in idx]))
        rows = np.moveaxis(grid, idx, list(range(4 - len(idx), 4))).reshape(-1, size)
        for row in rows:
            row = [int(r) for r in row]
            g = dist.new_group(row)
            if me in row:
                groups[key] = g
    return Mesh(spec, me, groups)


def meshspec_from_bootstrap(info, n: int, pp_from_subgroups: bool = True, cp: int = 1) -> MeshSpec:
    """The mesh shape the contract gives a group of `n` devices
    (lws_tpu/parallel/mesh.py:mesh_from_bootstrap's rule and errors): with
    subgroups, pp = number of subgroups and tp = devices per subgroup;
    otherwise tp = every device; `cp` is carved out of tp."""
    if n % cp != 0:
        raise ValueError(f"{n} devices not divisible by cp={cp}")
    if pp_from_subgroups and info.subgroup_size and info.num_processes > info.subgroup_size:
        n_subgroups = info.num_processes // info.subgroup_size
        if n % (n_subgroups * cp) != 0:
            raise ValueError(
                f"{n} devices not divisible by subgroups({n_subgroups}) x cp({cp}); "
                "adjust cp or the subgroup layout"
            )
        return MeshSpec(dp=1, pp=n_subgroups, cp=cp, tp=n // n_subgroups // cp)
    return MeshSpec(dp=1, pp=1, cp=cp, tp=n // cp)


def mesh_from_bootstrap(info, pp_from_subgroups: bool = True, cp: int = 1) -> Mesh:
    """The group-wide mesh from the bootstrap contract, over every rank of
    the started group (one device each)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("mesh_from_bootstrap: torch.distributed is not initialized "
                           "(parallel.initialize_from_env, group_of_one=True for one process)")
    return build_mesh(meshspec_from_bootstrap(info, dist.get_world_size(), pp_from_subgroups,
                                              cp))
