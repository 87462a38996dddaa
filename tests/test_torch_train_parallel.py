"""The port's training step on meshes of two gloo ranks against the JAX
package's on the same mesh shapes (the 8-device virtual CPU mesh of
tests/conftest.py), f32 tiny configs. The four-rank meshes are in
tests/test_torch_train_mesh4.py, which shares this module's members.

For each mesh (tp 2, and tp 2 at an odd sequence, where the sequence
shares over tp are padded; GPipe over pp 2 with 2 microbatches; the ring
over cp 2; MoE at tp 2 and on the ring at cp 2) every rank starts from
JAX's initial weights landed as its shard (params_from_jax(..., mesh=...))
and:
  * its gradient of every parameter it holds (after the sum over the data
    group) equals the single device's: jax.grad(loss_fn) on one device,
    placed with JAX's NamedSharding of the mesh and read at the rank's
    device, within GRAD_TOL of the tensor's largest value;
  * after three make_train_step steps, its losses equal JAX's sharded
    step's (rtol 1e-5) and every other rank's, and its parameter and moment
    shards equal JAX's NamedSharding shards at its device (parameters
    within PARAM_ATOL, with test_torch_train's exemption for elements whose
    gradient was tiny; moments within 1e-4 of their largest).
A factor of pp, cp, dp or tp in any gradient fails the first check (the
norms' gradients, each tp rank's from its share of the sequence, are
summed over tp once).

The layout check (`run_layout`, at tp 2 here and at (cp 2, tp 2) in the
four-rank file) holds the training forward to sequence parallelism: every
block receives the rank's share [B, ceil(S / (cp tp)), D]; the tensors
saved for backward (saved_tensors_hooks, remat on) take fewer bytes than
the same model's with no mesh, the blocks' saved inputs exactly 1/(cp tp)
of them; and the forward runs reduce-scatters and no all-reduce over tp
(none of a [B, S, D] tensor over any group).

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


def run_layout(case, mesh) -> dict:
    """One forward and backward of loss_fn with remat, on `mesh` and with no
    mesh, from the same seeded weights and rows: the sequence length of
    every training block's input, the bytes of the tensors saved for
    backward (and of those among them that are block inputs), and the
    collectives the forward ran (chip_smoke.forward_collectives, the
    four-card run's own count)."""
    import dataclasses

    import torch

    import chip_smoke
    from lws_tpu_torch.models.llama import init_params

    cfg = case["cfg"]
    tokens = torch.from_numpy(case["tokens"])
    out = {"coords": dict(mesh.coords)}
    for name, m, c in (("mesh", mesh, cfg),
                       ("none", None, dataclasses.replace(cfg, context_parallel=False))):
        model = init_params(c, torch.Generator().manual_seed(0), "cpu", mesh=m)
        for p in model.parameters():
            p.requires_grad_(True)
        inputs, ptrs, saved = [], set(), []

        def block_input(mod, args):
            inputs.append(tuple(args[0].shape))
            ptrs.add(args[0].data_ptr())

        def pack(t):
            saved.append((t.numel() * t.element_size(), t.data_ptr()))
            return t

        hooks = [blk.register_forward_pre_hook(block_input) for blk in model.layers]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, calls = chip_smoke.forward_collectives(torch, model, {"tokens": tokens}, m)
        n_forward = len(inputs)
        loss.backward()  # remat reruns every block from its saved input
        for h in hooks:
            h.remove()
        out[name] = {"inputs": inputs, "n_forward": n_forward,
                     "saved": sum(b for b, _ in saved),
                     "saved_inputs": sum(b for b, p in saved if p in ptrs),
                     "calls": calls, "loss": float(loss)}
    return out


RUNNERS = {"train": run_train, "layout": run_layout}


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


SEQ = 17  # token columns: 16 inputs and their shifted targets


def batch_tokens(B: int = 4, S: int = SEQ) -> np.ndarray:
    """Rows 0 and 1 (dp rank 0's under dp 2) carry -1 padding, so the masks
    are uneven over dp: rank 0 has fewer targets than rank 1."""
    toks = np.random.default_rng(5).integers(0, 128, (B, S)).astype(np.int32)
    toks[0, 14:] = -1
    toks[1, 9:] = -1
    return toks


def _local(a, dev):
    return next(np.asarray(s.data) for s in a.addressable_shards if s.device == dev)


def jax_case(name: str, mesh: dict, jcfg, single: dict, seq: int = SEQ,
             params_ref: str = "sharded") -> tuple[dict, dict]:
    """(the members' case, the parent's oracle): JAX's sharded training run
    on `mesh` (init_train_state, STEPS make_train_step steps) over
    batch_tokens(S=seq), with the single-device gradients at the start and
    at each step placed on the mesh. `single` caches the jitted
    single-device gradient per config. With params_ref="single" the
    parameters are held to JAX's STEPS steps on one device (placed on the
    mesh) instead of its sharded run's: over a sequence that tp does not
    divide, GSPMD's padded layout moves JAX's own sharded parameters past
    PARAM_ATOL from its single-device ones within three steps (tp 2 at 15
    positions: one element of w_gate whose gradient is not small), while
    the port stays within it of the single device."""
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
    toks = batch_tokens(S=seq)
    batch = {"tokens": jnp.asarray(toks)}
    step = make_train_step(jcfg, jmesh, opt)
    params, opt_state, losses, grads = state.params, state.opt_state, [], []
    for _ in range(STEPS):
        full = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, params))
        grads.append(jax.device_put(grad_fn(full, batch), shardings))
        params, opt_state, loss, _ = step(params, opt_state, batch)
        losses.append(float(loss))
    adam = opt_state[1][0]
    if params_ref == "single":
        one = build_mesh(MeshSpec(), jax.devices()[:1])
        ref = init_train_state(plain, one, opt)
        one_step = make_train_step(plain, one, opt)
        ref_params, ref_opt = ref.params, ref.opt_state
        for _ in range(STEPS):
            ref_params, ref_opt, _, _ = one_step(ref_params, ref_opt, batch)
        params = jax.device_put(jax.tree.map(np.asarray, ref_params), shardings)

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


def layout_case(name: str, mesh: dict, seq: int, **kw) -> dict:
    """A member case for run_layout: the port's config of jax_cfg(**kw)
    with remat, over batch_tokens(S=seq)."""
    from lws_tpu_torch.models.convert import config_from_jax

    return {"name": name, "run": "layout", "mesh": mesh,
            "cfg": config_from_jax(jax_cfg(remat=True, **kw)), "tokens": batch_tokens(S=seq)}


def run_world(world: int, specs: list, out_dir, extra: tuple = ()) -> tuple[list, dict]:
    """JAX's oracles for `specs` ((name, mesh, jax config, jax_case's
    keyword options)),
    then one spawn of `world` ranks running their cases and the `extra`
    member cases in order."""
    single, cases, oracles = {}, [], {}
    for name, mesh, jcfg, opts in specs:
        case, oracle = jax_case(name, mesh, jcfg, single, **opts)
        cases.append(case)
        oracles[name] = oracle
    return spawn_cases(world, cases + list(extra), out_dir, __name__), oracles


WORLD2 = [
    ("tp2", {"tp": 2}, {}),
    # 15 positions: shares of 8, one padded (parameters: jax_case's params_ref)
    ("tp2_odd_seq", {"tp": 2}, {"seq": 16, "params_ref": "single"}),
    ("gpipe_pp2", {"pp": 2}, {"pipeline_microbatches": 2}),
    ("ring_cp2", {"cp": 2}, {"context_parallel": True}),
    ("moe_tp2", {"tp": 2}, {"moe": True}),
    ("moe_ring_cp2", {"cp": 2}, {"moe": True, "context_parallel": True}),
]


def specs_of(table):
    """(name, mesh, jax_cfg(**kw), jax_case options) for each row; a row's
    kw may hold jax_case's "seq" (the token columns) and "params_ref"."""
    out = []
    for name, mesh, kw in table:
        opts = {k: kw[k] for k in ("seq", "params_ref") if k in kw}
        cfg = jax_cfg(**{k: v for k, v in kw.items() if k not in opts})
        out.append((name, mesh, cfg, opts))
    return out


def check_layout(name: str, results: list, B: int, S: int, cp: int, tp: int, D: int) -> None:
    """run_layout's record on every rank: the blocks' inputs are the
    rank's share, remat saves 1/(cp tp) of the no-mesh run's block-input
    bytes and fewer bytes in all, and the forward reduce-scatters where it
    all-reduced over tp."""
    share = -(-S // (cp * tp))
    for rank, res in enumerate(results):
        got, none = res[name]["mesh"], res[name]["none"]
        where = f"{name} rank {rank}"
        L = got["n_forward"]
        assert L > 0 and got["n_forward"] == none["n_forward"], where
        # Every block call, in the forward and in remat's reruns.
        assert set(got["inputs"]) == {(B, share, D)}, (where, set(got["inputs"]))
        assert set(none["inputs"]) == {(B, S, D)}, (where, set(none["inputs"]))
        assert len(got["inputs"]) == 2 * L, where
        assert got["saved_inputs"] * S == none["saved_inputs"] * share and got["saved_inputs"], \
            (where, got["saved_inputs"], none["saved_inputs"])
        assert got["saved"] < none["saved"], (where, got["saved"], none["saved"])
        calls = got["calls"]
        assert calls["reduce_scatter"] >= 2 * L + 1, (where, calls)
        assert not any(tp_group for _, tp_group in calls["all_reduce"]), (where, calls)
        assert all(n < B * S * D for n, _ in calls["all_reduce"]), (where, calls)
        assert none["calls"] == {"all_reduce": [], "reduce_scatter": 0, "all_gather": 0}, where
        assert abs(got["loss"] - none["loss"]) <= 1e-5 * abs(none["loss"]), where


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, specs_of(WORLD2), tmp_path_factory.mktemp("train2"),
                     extra=(layout_case("layout_tp2", {"tp": 2}, seq=16),))


@pytest.mark.parametrize("name", [n for n, _, _ in WORLD2])
def test_two_rank_mesh_trains_like_jax(world2, name):
    results, oracles = world2
    for rank, res in enumerate(results):
        check_rank(f"{name} rank {rank}", res[name], oracles[name])
    assert len({tuple(r[name]["losses"]) for r in results}) == 1, "ranks disagree"


def test_training_blocks_hold_the_sequence_share_at_tp2(world2):
    """tp 2 at 15 positions: every block receives [4, 8, 64]."""
    results, _ = world2
    check_layout("layout_tp2", results, B=4, S=15, cp=1, tp=2, D=64)
