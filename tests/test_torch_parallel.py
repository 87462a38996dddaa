"""The port's multi-process bootstrap and mesh (lws_tpu_torch/parallel/)
against the JAX package's (lws_tpu/parallel/, lws_tpu/api/contract.py).

The contract constants equal JAX's; `bootstrap_info_from_env` gives JAX's
BootstrapInfo on a table of env dicts; `auto_meshspec` and the
contract-to-shape rule of `mesh_from_bootstrap` give JAX's shapes and
errors (JAX's side on the 8-device virtual CPU mesh of tests/conftest.py);
a rank's mesh coordinates are its device's place in JAX's mesh array.
Then the port alone: a one-rank gloo group (group_of_one) builds a mesh
(pp and cp > 1 are refused only for want of ranks: the training slice runs
them), and a missing GPU raises; two spawned gloo ranks all-
reduce and gather over their axes, and rank 0 builds the kernels while rank
1 waits at the barrier.

The spawned members' functions live at this module's top level and import
only the port (spawn imports this module by name in each child, and the
port never imports JAX).
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from lws_tpu_torch.parallel import (
    MeshSpec,
    auto_meshspec,
    bootstrap_info_from_env,
    build_mesh,
    initialize_from_env,
    meshspec_from_bootstrap,
)
from lws_tpu_torch.parallel import contract as port_contract
from lws_tpu_torch.parallel import launch
from lws_tpu_torch.parallel.mesh import Mesh

ENVS = {
    "empty": {},
    "leader_only": {"LWS_LEADER_ADDRESS": "grp-0.svc.default"},
    "lws_contract": {"LWS_LEADER_ADDRESS": "grp-0.svc.default", "LWS_GROUP_SIZE": "4",
                     "LWS_WORKER_INDEX": "2"},
    "jax_over_lws": {"LWS_LEADER_ADDRESS": "grp-0.svc.default", "LWS_GROUP_SIZE": "4",
                     "LWS_WORKER_INDEX": "1", "JAX_COORDINATOR_ADDRESS": "10.0.0.7:9999",
                     "JAX_NUM_PROCESSES": "8", "JAX_PROCESS_ID": "5"},
    "subgroups": {"LWS_LEADER_ADDRESS": "grp-0.svc.default", "LWS_GROUP_SIZE": "8",
                  "LWS_WORKER_INDEX": "6", "LWS_SUBGROUP_SIZE": "4",
                  "LWS_SUBGROUP_INDEX": "1"},
}


def test_contract_constants_equal_jax():
    from lws_tpu.api import contract

    names = ("LWS_LEADER_ADDRESS", "LWS_GROUP_SIZE", "LWS_WORKER_INDEX",
             "JAX_COORDINATOR_ADDRESS", "JAX_COORDINATOR_PORT_DEFAULT", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID", "LWS_SUBGROUP_SIZE", "LWS_SUBGROUP_INDEX")
    for name in names:
        assert getattr(port_contract, name) == getattr(contract, name), name
    public = {n for n in vars(port_contract) if n.isupper()}
    assert public == set(names)


@pytest.mark.parametrize("case", sorted(ENVS))
def test_bootstrap_info_from_env_equals_jax(case):
    from lws_tpu.parallel import bootstrap_info_from_env as jax_info

    got = bootstrap_info_from_env(ENVS[case])
    want = jax_info(ENVS[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_distributed == want.is_distributed


def test_group_env_is_the_control_plane_contract():
    """launch.group_env gives member r what the pod webhook gives it
    (lws_tpu/utils/podutils.py): the LWS_* contract and the JAX_* names
    over it, with the coordinator at the given port."""
    env = launch.group_env(3, 4, 12345)
    info = bootstrap_info_from_env(env)
    assert (info.coordinator_address, info.num_processes, info.process_id) == \
        ("127.0.0.1:12345", 4, 3)
    assert env["LWS_GROUP_SIZE"] == env["JAX_NUM_PROCESSES"] == "4"
    assert env["LWS_WORKER_INDEX"] == env["JAX_PROCESS_ID"] == "3"
    assert env["JAX_COORDINATOR_ADDRESS"].startswith(env["LWS_LEADER_ADDRESS"] + ":")


@pytest.mark.parametrize("n,prefer_tp,pp,cp", [
    (8, 0, 1, 1), (8, 4, 1, 1), (8, 2, 2, 1), (8, 0, 2, 2), (6, 4, 1, 1), (12, 8, 1, 3),
    (1, 0, 1, 1), (4, 3, 1, 1),
])
def test_auto_meshspec_equals_jax(n, prefer_tp, pp, cp):
    from lws_tpu.parallel.mesh import auto_meshspec as jax_auto

    assert dataclasses.asdict(auto_meshspec(n, prefer_tp, pp, cp)) == \
        dataclasses.asdict(jax_auto(n, prefer_tp, pp, cp))


def test_auto_meshspec_refuses_like_jax():
    from lws_tpu.parallel.mesh import auto_meshspec as jax_auto

    with pytest.raises(AssertionError) as want:
        jax_auto(6, 0, 4, 1)
    with pytest.raises(AssertionError) as got:
        auto_meshspec(6, 0, 4, 1)
    assert str(got.value) == str(want.value)


MESH_CASES = [  # (env case, devices, pp_from_subgroups, cp)
    ("lws_contract", 4, True, 1), ("lws_contract", 8, True, 2), ("subgroups", 8, True, 1),
    ("subgroups", 8, False, 1), ("subgroups", 8, True, 2), ("empty", 2, True, 1),
]


@pytest.mark.parametrize("case,n,pp_from_subgroups,cp", MESH_CASES)
def test_mesh_shape_from_bootstrap_equals_jax(case, n, pp_from_subgroups, cp):
    import jax

    from lws_tpu.parallel import bootstrap_info_from_env as jax_info
    from lws_tpu.parallel import mesh_from_bootstrap as jax_mesh

    want = jax_mesh(jax_info(ENVS[case]), jax.devices()[:n], pp_from_subgroups, cp)
    got = meshspec_from_bootstrap(bootstrap_info_from_env(ENVS[case]), n, pp_from_subgroups, cp)
    assert dict(zip(want.axis_names, want.devices.shape)) == \
        {a: getattr(got, a) for a in got.axis_names()}


@pytest.mark.parametrize("case,n,cp", [("lws_contract", 6, 4), ("subgroups", 6, 2),
                                       ("subgroups", 8, 3)])
def test_mesh_from_bootstrap_errors_equal_jax(case, n, cp):
    import jax

    from lws_tpu.parallel import bootstrap_info_from_env as jax_info
    from lws_tpu.parallel import mesh_from_bootstrap as jax_mesh

    with pytest.raises(ValueError) as want:
        jax_mesh(jax_info(ENVS[case]), jax.devices()[:n], True, cp)
    with pytest.raises(ValueError) as got:
        meshspec_from_bootstrap(bootstrap_info_from_env(ENVS[case]), n, True, cp)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [MeshSpec(dp=2, tp=2), MeshSpec(tp=4), MeshSpec(dp=4, tp=2),
                                  MeshSpec(dp=8)])
def test_rank_coordinates_follow_jax_device_layout(spec):
    """Rank r sits where JAX's build_mesh puts device r, so the rank at tp
    index i holds JAX's tp shard i."""
    import jax

    from lws_tpu.parallel.mesh import MeshSpec as JaxSpec
    from lws_tpu.parallel.mesh import build_mesh as jax_build

    jm = jax_build(JaxSpec(dp=spec.dp, pp=spec.pp, tp=spec.tp, cp=spec.cp),
                   jax.devices()[:spec.size])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(spec.size):
        m = Mesh(spec, r, {})
        where = dict(zip(jm.axis_names, (int(i) for i in np.argwhere(ids == r)[0])))
        assert m.coords == where, (r, m.coords, where)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, torn down after the test."""
    import torch.distributed as dist

    info = initialize_from_env(env={}, device="cpu", group_of_one=True)
    try:
        yield info
    finally:
        dist.destroy_process_group()


def test_one_process_is_a_noop_unless_asked():
    import torch.distributed as dist

    info = initialize_from_env(env={}, device="cpu")
    assert not info.is_distributed and not dist.is_initialized()


def test_group_of_one_builds_a_mesh_and_refuses_pp_cp(one_rank_group):
    import torch.distributed as dist

    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = build_mesh(MeshSpec())
    assert (mesh.tp, mesh.dp, mesh.tp_rank, mesh.dp_rank) == (1, 1, 0, 0)
    assert (mesh.pp, mesh.cp, mesh.pp_rank, mesh.cp_rank) == (1, 1, 0, 0)
    x = torch.ones(3)
    for axis in ("dp", "pp", "cp", "tp", "dp_cp"):
        dist.all_reduce(x, group=mesh.groups[axis])  # each one-rank group's collective runs
    assert x.tolist() == [1.0, 1.0, 1.0]
    for spec in (MeshSpec(pp=2), MeshSpec(cp=2)):
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            build_mesh(spec)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        build_mesh(MeshSpec(tp=2))
    with pytest.raises(RuntimeError, match="already initialized"):
        initialize_from_env(env={}, device="cpu", group_of_one=True)


def test_build_mesh_refuses_without_a_group():
    with pytest.raises(RuntimeError, match="not initialized"):
        build_mesh(MeshSpec())


def test_a_missing_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_from_env(env={}, group_of_one=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_from_env(env=launch.group_env(0, 2, 1))


# ---------------------------------------------------------------------------
# Spawned gloo members


def _collectives_member(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from lws_tpu_torch.parallel import mesh_from_bootstrap
    from lws_tpu_torch.parallel.bootstrap import bootstrap_info_from_env as info_from_env
    from lws_tpu_torch.parallel.collectives import all_gather, psum

    info = initialize_from_env(device="cpu")
    mesh = mesh_from_bootstrap(info)
    with torch.no_grad():  # as the serving engines call them
        x = psum(torch.full((2,), float(rank + 1)), mesh.tp_group)
        g = all_gather(torch.full((1, 2), float(rank)), mesh.tp_group)
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump({"info": dataclasses.asdict(info_from_env()), "tp": mesh.tp,
                   "tp_rank": mesh.tp_rank, "sum": x.tolist(), "gather": g.tolist()}, f)
    dist.destroy_process_group()


def test_spawned_members_bootstrap_from_the_contract_and_reduce(tmp_path):
    ctx, envs = launch.spawn_group(_collectives_member, 2, args=(str(tmp_path),))
    launch.join(ctx, timeout_s=120)
    for r in range(2):
        got = json.loads((tmp_path / f"{r}.json").read_text())
        assert got["info"]["process_id"] == r and got["info"]["num_processes"] == 2
        assert got["info"]["coordinator_address"] == envs[r]["JAX_COORDINATOR_ADDRESS"]
        assert (got["tp"], got["tp_rank"]) == (2, r)
        assert got["sum"] == [3.0, 3.0]
        assert got["gather"] == [[0.0, 0.0, 1.0, 1.0]]


def _build_member(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from lws_tpu_torch.ops import _ext

    initialize_from_env(device="cpu")
    calls = []

    def fake_build(names):  # stands in for nvcc: slow, and records when it ran
        calls.append((time.time(), list(names)))
        time.sleep(0.5)
        calls.append((time.time(), None))
        return {n: "" for n in names}

    _ext.build = fake_build
    reports = _ext.build_on_rank_zero()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump({"calls": calls, "reports": sorted(reports), "after": time.time()}, f)
    dist.destroy_process_group()


def test_rank_zero_builds_the_kernels_behind_a_barrier(tmp_path):
    from lws_tpu_torch.ops import _ext

    ctx, _ = launch.spawn_group(_build_member, 2, args=(str(tmp_path),))
    launch.join(ctx, timeout_s=120)
    r0, r1 = (json.loads((tmp_path / f"{r}.json").read_text()) for r in range(2))
    sources = sorted(p.stem for p in _ext.CSRC_DIR.glob("*.cu"))
    assert [c[1] for c in r0["calls"]] == [sources, None]  # one build of every source
    assert r0["reports"] == sources
    assert r1["calls"] == [] and r1["reports"] == []  # rank 1 compiled nothing
    assert r1["after"] >= r0["calls"][1][0]  # and left the barrier after rank 0's build ended


def test_a_mesh_refuses_what_is_not_ported(one_rank_group):
    """quantize_params refuses a shard (quantize the full model, then shard
    it); tp = 1 serves as the full model. The tensor-parallel handoff's
    parts now run beside a mesh: the host-arena and remote prefix tiers
    are accepted at construction and after it, and the streamed prefill
    emits the chunks the mesh-free engine emits."""
    from lws_tpu_torch.models.llama import LlamaConfig, init_params, shard_params
    from lws_tpu_torch.models.quant import quantize_params
    from lws_tpu_torch.serving.engine import Engine
    from lws_tpu_torch.serving.kv_host_arena import KVHostArena
    from lws_tpu_torch.serving.kv_transport import RemotePrefixSource
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2, d_ff=64,
                      max_seq_len=64, dtype=torch.float32, param_dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = build_mesh(MeshSpec())
    kw = dict(slots=2, max_len=32, block_size=8, mesh=mesh, prefix_cache=True, device="cpu")
    arena = KVHostArena(1 << 20)
    assert PagedBatchEngine(cfg, model, host_arena=arena, **kw)._host_arena is arena
    src = RemotePrefixSource(endpoints=())
    assert PagedBatchEngine(cfg, model, remote_prefix=src, **kw)._remote_prefix is src
    engine = PagedBatchEngine(cfg, model, **kw)
    engine.set_remote_prefix(src)
    assert engine._remote_prefix is src
    dense = Engine(cfg, model, batch_size=1, max_len=32, mesh=mesh, device="cpu")
    chunks = {}
    for name, eng in (("mesh", dense), ("plain", Engine(cfg, model, batch_size=1, max_len=32,
                                                         device="cpu"))):
        chunks[name] = []
        eng.prefill_chunked_stream(np.arange(5)[None], 4,
                                   lambda lo, hi, a, out=chunks[name]: out.append((lo, hi, a)))
    assert [c[:2] for c in chunks["mesh"]] == [c[:2] for c in chunks["plain"]] == [(0, 4), (4, 5)]
    for (_, _, got), (_, _, want) in zip(chunks["mesh"], chunks["plain"]):
        assert all(np.array_equal(got[n], want[n]) for n in want)
    with pytest.raises(ValueError, match="quantize the full model"):
        quantize_params(shard_params(model, mesh))
    prompt = np.array([5, 9, 2, 11], np.int32)
    plain = Engine(cfg, model, batch_size=1, max_len=32, device="cpu")
    np.testing.assert_array_equal(dense.generate(prompt[None], 6).tokens,
                                  plain.generate(prompt[None], 6).tokens)
