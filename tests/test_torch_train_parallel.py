"""The port's training step on meshes of two gloo ranks against the JAX
package's on the same mesh shapes (the 8-device virtual CPU mesh of
tests/conftest.py), f32 tiny configs. The four-rank meshes are in
tests/test_torch_train_mesh4.py, which shares this module's members.

For each mesh (tp 2; GPipe over pp 2 with 2 microbatches; the ring over
cp 2; MoE at tp 2 and on the ring at cp 2) every rank starts from JAX's
initial weights landed as its shard (params_from_jax(..., mesh=...)) and:
  * its gradient of every parameter it holds (after the sum over the data
    group) equals the single device's: jax.grad(loss_fn) on one device,
    placed with JAX's NamedSharding of the mesh and read at the rank's
    device, within GRAD_TOL of the tensor's largest value;
  * after three make_train_step steps, its losses equal JAX's sharded
    step's (rtol 1e-5) and every other rank's, and its parameter and moment
    shards equal JAX's NamedSharding shards at its device (parameters
    within PARAM_ATOL, with test_torch_train's exemption for elements whose
    gradient was tiny; moments within 1e-4 of their largest).
A factor of pp, cp or dp in any gradient fails the first check.

Each world size is one spawn whose members run every case of that world in
order; JAX's oracles are computed once in the parent. The members'
functions live at this module's top level and import only the port.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

from lws_tpu_torch.parallel import launch

GRAD_TOL = 1e-5
PARAM_ATOL = 1e-6
MOMENT_TOL = 1e-4
STEPS = 3
LR = 3e-4


# ---------------------------------------------------------------------------
# Member side (port only)


def _jax_layout(named: dict, cfg, mesh):
    """A rank's tensors under parameter names, in the JAX tree layout of
    its shard (models/convert.params_to_numpy of a module holding them)."""
    import torch

    from lws_tpu_torch.models.convert import params_to_numpy
    from lws_tpu_torch.models.llama import Llama

    m = Llama(cfg, "cpu", mesh=mesh)
    with torch.no_grad():
        for n, t in named.items():
            m.get_parameter(n).copy_(t)
    return params_to_numpy(m)


def run_train(case, mesh) -> dict:
    import torch

    from lws_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from lws_tpu_torch.models.train import make_optimizer, make_train_step, value_and_grad

    cfg = case["cfg"]
    model = params_from_jax(case["tree"], cfg, "cpu", mesh=mesh)
    tokens = torch.from_numpy(case["tokens"])
    _, _, grads = value_and_grad(model, tokens, mesh)
    opt = make_optimizer(LR)
    state = opt.init(model)
    run = make_train_step(cfg, mesh, opt)
    losses = []
    for _ in range(STEPS):
        model, state, loss, _ = run(model, state, {"tokens": case["tokens"]})
        losses.append(float(loss))
    return {"coords": dict(mesh.coords), "losses": losses,
            "grads": _jax_layout(grads, cfg, mesh), "params": params_to_numpy(model),
            "mu": _jax_layout(state["mu"], cfg, mesh), "nu": _jax_layout(state["nu"], cfg, mesh),
            "count": int(state["count"])}


RUNNERS = {"train": run_train}


def member(rank: int, cases: list, out_dir: str, runners_module: str) -> None:
    """One gloo rank: bootstrap from the env contract, then every case on
    its own mesh; results pickled to out_dir/<rank>.pkl."""
    import importlib
    import warnings

    import torch
    import torch.distributed as dist

    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env

    torch.set_num_threads(1)  # the ranks share one pytest worker's cores
    warnings.simplefilter("ignore")
    runners = importlib.import_module(runners_module).RUNNERS
    initialize_from_env(device="cpu")
    out = {}
    for case in cases:
        mesh = build_mesh(MeshSpec(**case["mesh"]))
        out[case["name"]] = runners[case["run"]](case, mesh)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn_cases(world: int, cases: list, out_dir, runners_module: str) -> list[dict]:
    ctx, _ = launch.spawn_group(member, world, args=(cases, str(out_dir), runners_module))
    launch.join(ctx, timeout_s=400)
    return [pickle.loads((out_dir / f"{r}.pkl").read_bytes()) for r in range(world)]


# ---------------------------------------------------------------------------
# JAX side


def jax_cfg(moe: bool = False, **kw):
    import jax.numpy as jnp

    from lws_tpu.models import LlamaConfig

    base = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, remat=False, dtype=jnp.float32)
    if moe:
        base.update(n_experts=4, top_k=2, capacity_factor=1.0)  # a capacity that drops tokens
    base.update(kw)
    return LlamaConfig(**base)


def batch_tokens(B: int = 4, S: int = 17) -> np.ndarray:
    """Rows 0 and 1 (dp rank 0's under dp 2) carry -1 padding, so the masks
    are uneven over dp: rank 0 has fewer targets than rank 1."""
    toks = np.random.default_rng(5).integers(0, 128, (B, S)).astype(np.int32)
    toks[0, 14:] = -1
    toks[1, 9:] = -1
    return toks


def _local(a, dev):
    return next(np.asarray(s.data) for s in a.addressable_shards if s.device == dev)


def jax_case(name: str, mesh: dict, jcfg, single: dict) -> tuple[dict, dict]:
    """(the members' case, the parent's oracle): JAX's sharded training run
    on `mesh` (init_train_state, STEPS make_train_step steps), with the
    single-device gradients at the start and at each step placed on the
    mesh. `single` caches the jitted single-device gradient per config."""
    import jax
    import jax.numpy as jnp

    from lws_tpu.models.llama import loss_fn, param_shardings
    from lws_tpu.models.train import init_train_state, make_optimizer, make_train_step
    from lws_tpu.parallel import MeshSpec, build_mesh
    from jax.sharding import NamedSharding
    from lws_tpu_torch.models.convert import config_from_jax

    spec = MeshSpec(**mesh)
    jmesh = build_mesh(spec, jax.devices()[:spec.size])
    opt = make_optimizer(LR)
    state = init_train_state(jcfg, jmesh, opt)
    tree0 = jax.tree.map(np.asarray, state.params)
    plain = dataclasses.replace(jcfg, context_parallel=False, pipeline_microbatches=0)
    key = repr(plain)
    if key not in single:
        single[key] = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, plain)[0]))
    grad_fn = single[key]
    shardings = jax.tree.map(lambda s: NamedSharding(jmesh, s), param_shardings(jcfg))
    toks = batch_tokens()
    batch = {"tokens": jnp.asarray(toks)}
    step = make_train_step(jcfg, jmesh, opt)
    params, opt_state, losses, grads = state.params, state.opt_state, [], []
    for _ in range(STEPS):
        full = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, params))
        grads.append(jax.device_put(grad_fn(full, batch), shardings))
        params, opt_state, loss, _ = step(params, opt_state, batch)
        losses.append(float(loss))
    adam = opt_state[1][0]

    def at(coords):
        dev = jmesh.devices[coords["dp"], coords["pp"], coords["cp"], coords["tp"]]
        local = lambda tree: jax.tree.map(lambda a: _local(a, dev), tree)  # noqa: E731
        gs = [local(g) for g in grads]
        small = jax.tree.map(
            lambda *g: np.any([np.abs(x) <= GRAD_TOL * max(np.abs(x).max(), 1e-30) for x in g],
                              axis=0), *gs)
        return {"grads": gs[0], "params": local(params), "mu": local(adam.mu),
                "nu": local(adam.nu), "small": small}

    case = {"name": name, "run": "train", "mesh": mesh, "cfg": config_from_jax(jcfg),
            "tree": tree0, "tokens": toks}
    return case, {"losses": losses, "count": int(adam.count), "at": at}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def check_rank(name: str, got: dict, oracle: dict) -> None:
    want = oracle["at"](got["coords"])
    np.testing.assert_allclose(got["losses"], oracle["losses"], rtol=1e-5, err_msg=name)
    assert got["count"] == oracle["count"] == STEPS
    g_want = dict(_leaves(want["grads"]))
    for leaf, g in _leaves(got["grads"]):
        w = g_want[leaf]
        assert g.shape == w.shape, (name, leaf, g.shape, w.shape)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * scale, f"{name} grad {leaf}: {err:.3e} > {GRAD_TOL} x {scale:.3e}"
    small = dict(_leaves(want["small"]))
    exempt = total = 0
    p_want = dict(_leaves(want["params"]))
    for leaf, p in _leaves(got["params"]):
        w = p_want[leaf]
        assert p.shape == w.shape, (name, leaf)
        err = np.abs(p - w)
        ok = err <= PARAM_ATOL
        assert np.all(ok | (small[leaf] & (err <= 2 * LR * STEPS + PARAM_ATOL))), \
            f"{name} param {leaf}: max |err| {err.max():.3e} outside the exemption"
        exempt += int(np.sum(~ok))
        total += w.size
    assert exempt <= 1e-3 * total, f"{name}: {exempt} of {total} elements exempt"
    for kind in ("mu", "nu"):
        m_want = dict(_leaves(want[kind]))
        for leaf, m in _leaves(got[kind]):
            w = m_want[leaf]
            assert m.shape == w.shape
            assert np.abs(m - w).max() <= MOMENT_TOL * max(np.abs(w).max(), 1e-30), \
                f"{name} {kind} {leaf}"


def run_world(world: int, specs: list, out_dir) -> tuple[list, dict]:
    single, cases, oracles = {}, [], {}
    for name, mesh, jcfg in specs:
        case, oracle = jax_case(name, mesh, jcfg, single)
        cases.append(case)
        oracles[name] = oracle
    return spawn_cases(world, cases, out_dir, __name__), oracles


WORLD2 = [
    ("tp2", {"tp": 2}, {}),
    ("gpipe_pp2", {"pp": 2}, {"pipeline_microbatches": 2}),
    ("ring_cp2", {"cp": 2}, {"context_parallel": True}),
    ("moe_tp2", {"tp": 2}, {"moe": True}),
    ("moe_ring_cp2", {"cp": 2}, {"moe": True, "context_parallel": True}),
]


def specs_of(table):
    return [(name, mesh, jax_cfg(**kw)) for name, mesh, kw in table]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, specs_of(WORLD2), tmp_path_factory.mktemp("train2"))


@pytest.mark.parametrize("name", [n for n, _, _ in WORLD2])
def test_two_rank_mesh_trains_like_jax(world2, name):
    results, oracles = world2
    for rank, res in enumerate(results):
        check_rank(f"{name} rank {rank}", res[name], oracles[name])
    assert len({tuple(r[name]["losses"]) for r in results}) == 1, "ranks disagree"
