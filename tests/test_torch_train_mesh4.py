"""The port's training step on meshes of four gloo ranks against the JAX
package's on the same mesh shapes: tp 4; (dp 2, tp 2) with uneven target
masks over dp; (dp 2, pp 2) on the weight-gathered layer stack; the ring
over cp 4; and the MoE on the ring over cp 2 with the weight-gathered stack
over pp 2 and remat (tests/test_model.py::test_train_step_with_cp_axis's
layout without tp). The checks, tolerances and members are
tests/test_torch_train_parallel.py's: gradients equal the single device's,
and after three steps losses, parameter and moment shards equal JAX's.
One spawn of four ranks runs every case; JAX's oracles are computed once in
the parent.
"""

import pytest

from tests.test_torch_train_parallel import RUNNERS, check_rank, jax_cfg, run_world  # noqa: F401

WORLD4 = [
    ("tp4", {"tp": 4}, {"n_heads": 8, "n_kv_heads": 4}),
    ("dp2_tp2", {"dp": 2, "tp": 2}, {}),
    ("dp2_pp2", {"dp": 2, "pp": 2}, {}),
    ("ring_cp4", {"cp": 4}, {"context_parallel": True}),
    ("moe_ring_pp2_cp2", {"pp": 2, "cp": 2}, {"moe": True, "context_parallel": True,
                                              "remat": True}),
]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    specs = [(name, mesh, jax_cfg(**kw)) for name, mesh, kw in WORLD4]
    return run_world(4, specs, tmp_path_factory.mktemp("train4"))


@pytest.mark.parametrize("name", [n for n, _, _ in WORLD4])
def test_four_rank_mesh_trains_like_jax(world4, name):
    results, oracles = world4
    for rank, res in enumerate(results):
        check_rank(f"{name} rank {rank}", res[name], oracles[name])
    assert len({tuple(r[name]["losses"]) for r in results}) == 1, "ranks disagree"
