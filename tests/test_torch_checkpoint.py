"""Checkpoints of the port's training state (lws_tpu_torch/models/
checkpoint.py): a round trip into the mesh the state was saved from, and
into other factorizations, as orbax restores JAX's
(tests/test_autoscaler_pvc_ckpt.py::test_checkpoint_roundtrip_sharded).

Four gloo ranks train a tiny MoE f32 model for two steps on (dp 2, tp 2),
save, restore into the same mesh, and take step 3 from both states: the
restored parameters and moments equal the saved ones bit for bit, and the
restored step's loss equals the unrestored run's within 1e-6 relative
(JAX's own check). The same checkpoint restores into (pp 2, tp 2), whose
step 3 loss must agree within 1e-6 too (other reduction orders), and in
this process into one device (mesh=None): every rank's saved shards are
bit for bit the full restored model's shards of its coordinates. In one
process, a save and restore with no mesh round-trips, the step count
included. Each rank writes only the tensors it is the first replica of:
the files together hold each element once.
"""

import dataclasses
import glob
import os
import pickle

import numpy as np
import pytest
import torch

from lws_tpu_torch.parallel import launch

LOSS_RTOL = 1e-6


def tiny_cfg():
    from lws_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=128, d_model=64, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=128,
                       max_seq_len=64, remat=False, dtype=torch.float32, n_experts=4, top_k=2,
                       capacity_factor=1.0)


def batch(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 128, (4, 17)).astype(np.int32)


def named_state(state) -> dict:
    out = {f"params/{n}": p.detach().clone() for n, p in state.params.named_parameters()}
    for kind in ("mu", "nu"):
        out.update({f"{kind}/{n}": t.clone() for n, t in state.opt_state[kind].items()})
    out["count"] = state.opt_state["count"].clone()
    return out


def member(rank: int, path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from lws_tpu_torch.models.checkpoint import restore_checkpoint, save_checkpoint
    from lws_tpu_torch.models.train import (
        TrainState,
        init_train_state,
        make_optimizer,
        make_train_step,
    )
    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    cfg, opt = tiny_cfg(), make_optimizer(1e-2)
    mesh = build_mesh(MeshSpec(dp=2, tp=2))
    other = build_mesh(MeshSpec(pp=2, tp=2))
    state = init_train_state(cfg, mesh, opt, seed=0, device="cpu")
    run = make_train_step(cfg, mesh, opt)
    params, opt_state = state.params, state.opt_state
    for i in range(2):
        params, opt_state, _, _ = run(params, opt_state, {"tokens": batch(i)})
    saved = TrainState(step=2, params=params, opt_state=opt_state)
    save_checkpoint(path, saved)
    out = {"coords": dict(mesh.coords), "saved": {k: v.numpy() for k, v in
                                                  named_state(saved).items()}}
    same = restore_checkpoint(path, cfg, mesh, opt, device="cpu")
    out["restored"] = {k: v.numpy() for k, v in named_state(same).items()}
    out["step"] = same.step
    out["loss"] = float(run(params, opt_state, {"tokens": batch(2)})[2])
    out["loss_restored"] = float(run(same.params, same.opt_state, {"tokens": batch(2)})[2])
    moved = restore_checkpoint(path, cfg, other, opt, device="cpu")
    out["loss_other"] = float(make_train_step(cfg, other, opt)(
        moved.params, moved.opt_state, {"tokens": batch(2)})[2])
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    out_dir = tmp_path_factory.mktemp("ckpt_out")
    ctx, _ = launch.spawn_group(member, 4, args=(str(path / "state"), str(out_dir)))
    launch.join(ctx, timeout_s=300)
    return str(path / "state"), [pickle.loads((out_dir / f"{r}.pkl").read_bytes())
                                 for r in range(4)]


def test_restore_into_the_same_mesh_is_bitwise(four_ranks):
    _, ranks = four_ranks
    for r in ranks:
        assert r["step"] == 2
        assert sorted(r["restored"]) == sorted(r["saved"])
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)
        assert abs(r["loss_restored"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"])


def test_restore_into_another_factorization(four_ranks):
    _, ranks = four_ranks
    for r in ranks:
        assert abs(r["loss_other"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]), \
            (r["loss_other"], r["loss"])
    assert len({r["loss"] for r in ranks}) == 1


def test_restore_into_one_device_holds_every_rank_shard(four_ranks):
    from lws_tpu_torch.models.checkpoint import restore_checkpoint
    from lws_tpu_torch.models.llama import tp_shard
    from lws_tpu_torch.models.train import make_optimizer

    path, ranks = four_ranks
    cfg = tiny_cfg()
    full = restore_checkpoint(path, cfg, None, make_optimizer(1e-2), device="cpu")
    whole = named_state(full)

    class Coords:  # the shard rule needs only tp and tp_rank
        def __init__(self, c):
            self.tp, self.tp_rank = 2, c["tp"]

    for r in ranks:
        for key, v in r["saved"].items():
            if key == "count":
                assert int(v) == int(whole["count"]) == 2
                continue
            name = key.split("/", 1)[1]
            want = tp_shard(name, whole[key], Coords(r["coords"]), cfg.n_experts)
            np.testing.assert_array_equal(v, want.numpy(), err_msg=key)


def test_each_element_is_written_once(four_ranks):
    path, _ = four_ranks
    cfg = tiny_cfg()
    files = sorted(glob.glob(os.path.join(path, "shard-*.pt")))
    assert len(files) == 4
    stored = 0
    for f in files:
        for key, e in torch.load(f, weights_only=True).items():
            if key.startswith("params/"):
                stored += e["tensor"].numel()
    from lws_tpu_torch.models.llama import Llama

    assert stored == sum(p.numel() for p in Llama(cfg, "meta").parameters())


def test_round_trip_without_a_mesh(tmp_path):
    from lws_tpu_torch.models.checkpoint import restore_checkpoint, save_checkpoint
    from lws_tpu_torch.models.train import TrainState, init_train_state, make_optimizer, \
        make_train_step

    cfg, opt = dataclasses.replace(tiny_cfg(), n_experts=0), make_optimizer()
    state = init_train_state(cfg, None, opt, seed=1, device="cpu")
    run = make_train_step(cfg, None, opt)
    params, opt_state, _, _ = run(state.params, state.opt_state, {"tokens": batch(0)})
    save_checkpoint(str(tmp_path / "c"), TrainState(step=1, params=params, opt_state=opt_state))
    back = restore_checkpoint(str(tmp_path / "c"), cfg, None, opt, device="cpu")
    assert back.step == 1
    want, got = named_state(TrainState(1, params, opt_state)), named_state(back)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    l0 = run(params, opt_state, {"tokens": batch(1)})[2]
    l1 = run(back.params, back.opt_state, {"tokens": batch(1)})[2]
    assert abs(float(l1) - float(l0)) <= LOSS_RTOL * abs(float(l0))
