"""The port's training step on meshes of four gloo ranks against the JAX
package's on the same mesh shapes: tp 4; (dp 2, tp 2) with uneven target
masks over dp; (dp 2, pp 2) on the weight-gathered layer stack; the ring
over cp 4; the MoE on the ring over cp 2 with the weight-gathered stack
over pp 2 and remat (tests/test_model.py::test_train_step_with_cp_axis's
layout without tp); and, with the sequence sharded over (cp, tp) between
blocks, the ring over cp 2 at tp 2 (18 positions: chunks of 9, tp shares
of 5, one padded) and GPipe over pp 2 at tp 2 with 2 microbatches. The
checks, tolerances and members are tests/test_torch_train_parallel.py's:
gradients equal the single device's, and after three steps losses,
parameter and moment shards equal JAX's. The same spawn runs the layout
check at (cp 2, tp 2). One spawn of four ranks runs every case; JAX's
oracles are computed once in the parent.
"""

import pytest

from tests.test_torch_train_parallel import (  # noqa: F401
    RUNNERS,
    check_layout,
    check_rank,
    layout_case,
    run_world,
    specs_of,
)

WORLD4 = [
    ("tp4", {"tp": 4}, {"n_heads": 8, "n_kv_heads": 4}),
    ("dp2_tp2", {"dp": 2, "tp": 2}, {}),
    ("dp2_pp2", {"dp": 2, "pp": 2}, {}),
    ("ring_cp4", {"cp": 4}, {"context_parallel": True}),
    ("moe_ring_pp2_cp2", {"pp": 2, "cp": 2}, {"moe": True, "context_parallel": True,
                                              "remat": True}),
    ("ring_cp2_tp2", {"cp": 2, "tp": 2}, {"context_parallel": True, "seq": 19}),
    ("gpipe_pp2_tp2", {"pp": 2, "tp": 2}, {"pipeline_microbatches": 2}),
]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, specs_of(WORLD4), tmp_path_factory.mktemp("train4"),
                     extra=(layout_case("layout_cp2_tp2", {"cp": 2, "tp": 2}, seq=19,
                                        context_parallel=True),))


@pytest.mark.parametrize("name", [n for n, _, _ in WORLD4])
def test_four_rank_mesh_trains_like_jax(world4, name):
    results, oracles = world4
    for rank, res in enumerate(results):
        check_rank(f"{name} rank {rank}", res[name], oracles[name])
    assert len({tuple(r[name]["losses"]) for r in results}) == 1, "ranks disagree"


def test_training_blocks_hold_the_sequence_share_at_cp2_tp2(world4):
    """The ring over cp 2 at tp 2, 18 positions: every block receives
    [4, 5, 64] (chunks of 9 over cp, shares of 5 over tp)."""
    results, _ = world4
    check_layout("layout_cp2_tp2", results, B=4, S=18, cp=2, tp=2, D=64)
