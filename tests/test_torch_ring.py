"""The port's ring attention (lws_tpu_torch/ops/ring.py) against the JAX
package's (lws_tpu/ops/ring.py over the virtual CPU mesh of
tests/conftest.py) and against dense attention, forward and gradients, f32.

The inputs are tests/test_ops.py::test_ring_attention_matches_full's
(B=2, S=256, H=4, Hkv=2, D=32, JAX key 3). The gradients are those of
sum(out * ct) for a fixed random ct, taken with respect to q, k and v. Four
gloo ranks run the ring over cp 4, and over cp 2 (a (dp 2, cp 2) mesh: each
dp pair runs its own ring); each rank holds its chunk of the sequence and
returns its chunk of the output and of the three gradients, which must equal
JAX's ring's and the dense attention's chunks within RING_TOL (the tolerance
of tests/test_ops.py's ring case). The one-rank ring (no group) is held to
dense attention in this process.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from lws_tpu_torch.parallel import launch

RING_TOL = 2e-4  # atol = rtol


def make_inputs():
    import jax

    kq, kk, kv = jax.random.split(jax.random.key(3), 3)
    q = np.asarray(jax.random.normal(kq, (2, 256, 4, 32)))
    k = np.asarray(jax.random.normal(kk, (2, 256, 2, 32)))
    v = np.asarray(jax.random.normal(kv, (2, 256, 2, 32)))
    ct = np.random.default_rng(0).standard_normal(q.shape).astype(np.float32)
    return q, k, v, ct


def port_ring(q, k, v, ct, group, rank: int, n: int) -> dict:
    """The rank's chunk of the ring's output and of the gradients of
    sum(out * ct)."""
    from lws_tpu_torch.ops.ring import ring_attention

    S = q.shape[1] // n
    part = slice(rank * S, (rank + 1) * S)
    ts = [torch.from_numpy(np.array(a[:, part])).requires_grad_(True)
          for a in (q, k, v)]
    out = ring_attention(*ts, group)
    (out * torch.from_numpy(np.array(ct[:, part]))).sum().backward()
    return {"out": out.detach().numpy(), **{n_: t.grad.numpy() for n_, t in zip("qkv", ts)}}


def member(rank: int, inputs, out_dir: str) -> None:
    import torch.distributed as dist

    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    out = {}
    for name, spec in (("cp4", MeshSpec(cp=4)), ("dp2_cp2", MeshSpec(dp=2, cp=2))):
        mesh = build_mesh(spec)
        out[name] = {"cp_rank": mesh.cp_rank, "cp": mesh.cp,
                     **port_ring(*inputs, mesh.cp_group, mesh.cp_rank, mesh.cp)}
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def jax_grads(fn, q, k, v, ct) -> dict:
    import jax
    import jax.numpy as jnp

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * ct)

    out = fn(q, k, v)
    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), "q": np.asarray(gq), "k": np.asarray(gk), "v": np.asarray(gv)}


@pytest.fixture(scope="module")
def oracles():
    import jax
    from jax.sharding import Mesh

    from lws_tpu.ops import reference_attention, ring_attention

    q, k, v, ct = make_inputs()
    want = {"dense": jax_grads(lambda q, k, v: reference_attention(q, k, v, causal=True),
                               q, k, v, ct)}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("cp",))
        want[n] = jax_grads(lambda q, k, v: ring_attention(q, k, v, mesh, axis="cp", causal=True),
                            q, k, v, ct)
    return (q, k, v, ct), want


@pytest.fixture(scope="module")
def ranks(oracles, tmp_path_factory):
    inputs, _ = oracles
    out_dir = tmp_path_factory.mktemp("ring")
    ctx, _ = launch.spawn_group(member, 4, args=(inputs, str(out_dir)))
    launch.join(ctx, timeout_s=300)
    return [pickle.loads((out_dir / f"{r}.pkl").read_bytes()) for r in range(4)]


def assert_chunk(got: dict, want: dict, rank: int, n: int, what: str) -> None:
    S = want["out"].shape[1] // n
    part = slice(rank * S, (rank + 1) * S)
    for key in ("out", "q", "k", "v"):
        np.testing.assert_allclose(got[key], want[key][:, part], atol=RING_TOL, rtol=RING_TOL,
                                   err_msg=f"{what} rank {rank} {key}")


@pytest.mark.parametrize("mesh", ["cp4", "dp2_cp2"])
@pytest.mark.parametrize("against", ["jax_ring", "dense"])
def test_ring_matches_jax_ring_and_dense(oracles, ranks, mesh, against):
    _, want = oracles
    for res in ranks:
        r = res[mesh]
        ref = want["dense"] if against == "dense" else want[r["cp"]]
        assert_chunk(r, ref, r["cp_rank"], r["cp"], f"{mesh} vs {against}")


def test_one_rank_ring_is_dense_attention(oracles):
    (q, k, v, ct), want = oracles
    got = port_ring(q, k, v, ct, None, 0, 1)
    assert_chunk(got, want["dense"], 0, 1, "one-rank ring")


def test_ring_rotates_kv_over_the_group(oracles, ranks):
    """A ring that dropped a chunk would still be causal and finite; the
    last rank's queries attend to every chunk, so its output differs from
    attention over its own chunk alone."""
    (q, k, v, ct), _ = oracles
    from lws_tpu_torch.ops.attention import reference_attention

    last = next(res["cp4"] for res in ranks if res["cp4"]["cp_rank"] == 3)
    own = reference_attention(*(torch.from_numpy(np.array(a[:, 192:]))
                                for a in (q, k, v)), causal=True).numpy()
    assert np.abs(last["out"] - own).max() > 1e-2
