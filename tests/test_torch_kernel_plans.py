"""Launch planning of the port's kernels, checked here on the CPU; the
kernels themselves run only on the card (tests/test_torch_kernels_gpu.py).

- int8_matmul (lws_tpu_torch/ops/int8_matmul.py `plan`): a pure function of
  (M, D, F, SM count), for the flagship's products and odd shapes.
- the decode-attention kernels (lws_tpu_torch/ops/paged_attention.py
  `plan_items`): the Python mirror of the plan each CTA computes on the
  device from the slots' positions, and the shape-only grid and scratch
  bounds the wrappers launch with."""

import numpy as np
import pytest
import torch

from lws_tpu_torch.ops import int8_matmul as im
from lws_tpu_torch.ops import paged_attention as pa

# (D, F): the flagship's five products (wq/wo, wk/wv, w_gate/w_up, w_down,
# lm_head) and ragged or tiny ones.
SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256),
          (1000, 300), (136, 77), (16, 8), (520, 1000)]
ROWS = [1, 7, 8, 9, 16, 17, 64, 128, 129, 200, 256]
SMS = [132, 114, 1]  # an H100 SXM, an H100 PCIe, one SM


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("D,F", SHAPES)
def test_splits_cover_d_exactly_with_no_empty_split(D, F, sms):
    for M in ROWS:
        p = im.plan(M, D, F, sms)
        assert p.k_chunk % p.bk == 0 and p.k_chunk > 0
        assert 1 <= p.splits <= im.MAX_SPLITS
        assert p.splits * p.k_chunk >= D          # every column of D is in a split
        assert (p.splits - 1) * p.k_chunk < D     # and the last split is not empty


@pytest.mark.parametrize("D,F", SHAPES)
def test_counters_sized_to_the_output_tiles(D, F):
    for M in ROWS:
        p = im.plan(M, D, F, 132)
        tiles = -(-M // p.bm) * -(-F // p.bn)
        assert p.counters == (tiles if p.splits > 1 else 0)


@pytest.mark.parametrize("M", list(range(1, 257)))
def test_tile_choice_by_rows_matches_the_bodies(M):
    """Up to 16 rows the swapped small body (8 or 16 token columns, 64
    channels, 128 deep); to 64 rows the mma.sync body (64 rows, 128 channels,
    64 deep); above, the wgmma body (128 rows), unless TMA cannot read the
    operands (unaligned pointers, or D not a multiple of 16)."""
    p = im.plan(M, 4096, 14336, 132)
    unaligned = im.plan(M, 4096, 14336, 132, aligned=False)
    ragged = im.plan(M, 1000, 14336, 132)
    if M <= 8:
        assert (p.bm, p.bn, p.bk) == (8, 64, 128) == (unaligned.bm, unaligned.bn, unaligned.bk)
    elif M <= im.SMALL_ROWS:
        assert (p.bm, p.bn, p.bk) == (16, 64, 128) and unaligned.bm == ragged.bm == 16
    elif M <= 64:
        assert (p.bm, p.bn, p.bk) == (64, 128, 64) and unaligned.bm == ragged.bm == 64
    else:
        assert (p.bm, p.bn, p.bk) == (128, 128, 64)
        assert unaligned.bm == ragged.bm == 64
    assert M <= im.MAX_ROWS


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("D,F", SHAPES)
def test_split_only_when_tiles_leave_sms_idle(D, F, M):
    """With an output tile for every SM, D is not split; with fewer, it is
    split as far as there are blocks of D (the flagship's wk/wv: 16 channel
    tiles at 8 rows, split to the cap)."""
    p = im.plan(M, D, F, 132)
    tiles = -(-M // p.bm) * -(-F // p.bn)
    if tiles >= 132:
        assert p.splits == 1
    elif -(-D // p.bk) > 1:
        assert p.splits > 1
    assert im.plan(8, 4096, 1024, 132).splits == im.MAX_SPLITS


def test_tile_counters_are_zeroed_once_and_reused():
    dev = torch.device("cpu")
    im._counters.pop((dev, 0), None)
    a = im._tile_counters(dev, 0, 10)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert im._tile_counters(dev, 0, 5) is a             # big enough: the same buffer
    b = im._tile_counters(dev, 0, a.numel() + 1)         # too small: a new zeroed one
    assert b.numel() > a.numel() and not b.any()
    im._counters.pop((dev, 0), None)


def test_tile_counters_are_one_buffer_per_stream():
    """Two streams never share counters: split products on both may run at
    once, and each takes its tickets from counter 0 up."""
    dev = torch.device("cpu")
    a, b = im._tile_counters(dev, 101, 10), im._tile_counters(dev, 102, 10)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert im._tile_counters(dev, 101, 10) is a and im._tile_counters(dev, 102, 10) is b
    im._counters.pop((dev, 101)), im._counters.pop((dev, 102))


@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 128, 256])
@pytest.mark.parametrize("D,F", SHAPES)
def test_split_count_stays_within_the_bodys_ctas_per_sm(D, F, M):
    """Below one tile per SM, the split grid aims at 2 CTAs per SM for the
    small body and 1 for the tensor-core bodies, and never splits further
    than that, than MAX_SPLITS or than the blocks of D."""
    p = im.plan(M, D, F, 132)
    tiles = -(-M // p.bm) * -(-F // p.bn)
    per_sm = 2 if M <= im.SMALL_ROWS else 1
    if tiles < 132:
        assert p.splits <= min(-(-D // p.bk), im.MAX_SPLITS, -(-per_sm * 132 // tiles))


@pytest.mark.parametrize("M,D,F,splits", [
    (8, 4096, 4096, 4), (8, 4096, 1024, 8), (1, 14336, 4096, 4), (8, 4096, 14336, 1),
    (8, 4096, 128256, 1), (128, 4096, 4096, 4), (128, 4096, 1024, 8), (128, 4096, 14336, 2),
    (256, 4096, 4096, 3), (256, 14336, 4096, 3), (256, 4096, 14336, 1)])
def test_flagship_split_counts_on_an_h100(M, D, F, splits):
    """The flagship's products on 132 SMs: a target of 5-7 splits of 8
    blocks is cut to 4, the fewest that deal them in the same chunks."""
    assert im.plan(M, D, F, 132).splits == splits


# ---------------------------------------------------------------------------
# Decode attention: the work plan over live (slot, block) pairs.

_rng = np.random.default_rng(7)
# Slot positions: the smoke run's standard mix; one slot at 2047 and seven
# idle; every slot full; every slot at 15; block boundaries on both sides;
# positions past max_blocks (capped); a null row's frozen position 0; one
# slot; 32 slots of random lengths.
POSITIONS = {
    "standard_mix": [15, 16, 31, 1000, 517, 263, 1063, 40],
    "one_long": [2047] + [0] * 7,
    "all_long": [2047] * 8,
    "all_short": [15] * 8,
    "boundaries": [15, 16, 31, 32, 127, 128, 255, 256],
    "past_max_blocks": [5000, 2047, 4096, 2048],
    "null_rows": [0, 0, 300, 0],
    "one_slot": [700],
    "thirty_two": [int(x) for x in _rng.integers(0, 2048, 32)],
}
DECODE_SHAPES = [(8, 128), (1, 128), (32, 128), (8, 8), (4, 1)]  # (Hkv, max_blocks)
DECODE_SMS = [132, 114, 1]


def _decode_plan(pos, Hkv, MB, sms, quant=False):
    n_live = pa.live_blocks(pos, MB)
    grid = pa.decode_grid(len(pos), Hkv, MB, sms, quant=quant)
    return n_live, grid, pa.plan_items(n_live, Hkv, grid, pa.decode_prefer(sms, grid), quant)


QUANTS = [False, True]  # the bf16 and int8 kernels' grids


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("Hkv,MB", DECODE_SHAPES)
@pytest.mark.parametrize("case", sorted(POSITIONS))
def test_decode_plan_covers_every_live_block_once(case, Hkv, MB, quant):
    """Every live (slot, kv head, block) is in exactly one item, and no
    item reaches past a slot's live blocks (so stale table entries behind
    them are never read)."""
    pos = POSITIONS[case]
    for sms in DECODE_SMS:
        n_live, grid, plan = _decode_plan(pos, Hkv, MB, sms, quant)
        seen = {}
        for b, h, j0, j1 in plan.items:
            assert 0 <= j0 < j1 <= n_live[b]
            for j in range(j0, j1):
                seen[b, h, j] = seen.get((b, h, j), 0) + 1
        want = {(b, h, j) for b, n in enumerate(n_live) for h in range(Hkv) for j in range(n)}
        assert set(seen) == want and all(c == 1 for c in seen.values())


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("Hkv,MB", DECODE_SHAPES)
@pytest.mark.parametrize("case", sorted(POSITIONS))
def test_decode_plan_items_fit_the_chunk_grid_and_scratch(case, Hkv, MB, quant):
    """The chunk is one of the pool's chunk sizes and no item holds more blocks; the
    items fit in the grid unless the chunk is the largest size; the scratch
    the wrappers size from shapes alone holds every item; the chunk is the
    smallest size whose items fit the preferred count, else the smallest
    that fits the grid."""
    pos = POSITIONS[case]
    for sms in DECODE_SMS:
        n_live, grid, plan = _decode_plan(pos, Hkv, MB, sms, quant)
        sizes = pa.chunk_sizes(quant)
        assert plan.chunk in sizes
        assert all(j1 - j0 <= plan.chunk for _, _, j0, j1 in plan.items)
        assert len(plan.items) <= pa.scratch_items(len(pos), Hkv, MB, grid)
        if plan.chunk < sizes[-1]:
            assert len(plan.items) <= grid
        prefer = pa.decode_prefer(sms, grid)
        at = [Hkv * sum(-(-n // c) for n in n_live) for c in sizes]
        k = sizes.index(plan.chunk)
        if len(plan.items) <= prefer:
            assert all(a > prefer for a in at[:k])
        else:
            assert all(a > prefer for a in at)
            assert all(a > grid for a in at[:k])


@pytest.mark.parametrize("case", sorted(POSITIONS))
def test_decode_plan_walks_items_in_kernel_order(case):
    """Item i is (h = i // chunks, then slot-major chunks): the kernel finds
    (b, h, c) from i by the chunk offsets, and a slot's chunks are
    consecutive items, so the last to finish reads them from item - c up."""
    pos = POSITIONS[case]
    Hkv, MB = 8, 128
    n_live, _, plan = _decode_plan(pos, Hkv, MB, 132)
    chunks = [-(-n // plan.chunk) for n in n_live]
    off = np.concatenate([[0], np.cumsum(chunks)])
    for i, (b, h, j0, _) in enumerate(plan.items):
        r = i - h * off[-1]
        assert i // off[-1] == h and off[b] <= r < off[b + 1]
        assert j0 == (r - off[b]) * plan.chunk


@pytest.mark.parametrize("pos,MB,last,want", [
    ([0, 15, 16, 31, 32], 128, None, [1, 1, 2, 2, 3]),
    ([2047, 5000, 2048], 128, None, [128, 128, 128]),  # capped at max_blocks
    ([-3, 0], 4, None, [1, 1]),
    ([5000, 39, 49], 4, 49, [4, 3, 4]),  # dense: T = 50, positions past it clamp
])
def test_live_blocks_clamp_and_cap(pos, MB, last, want):
    assert pa.live_blocks(pos, MB, last) == want


@pytest.mark.parametrize("B,Hkv,MB,sms,grid,int8_grid", [
    (8, 8, 128, 132, 396, 264), (1, 8, 1, 132, 8, 8), (32, 8, 128, 132, 396, 264),
    (8, 8, 128, 114, 342, 228), (2, 1, 1, 132, 2, 2)])
def test_decode_grid_is_fixed_by_shapes(B, Hkv, MB, sms, grid, int8_grid):
    assert pa.decode_grid(B, Hkv, MB, sms) == grid
    assert pa.decode_grid(B, Hkv, MB, sms, quant=True) == int8_grid


@pytest.mark.parametrize("quant,case,chunk,items", [
    (False, "standard_mix", 7, 248), (False, "all_long", 32, 256), (False, "all_short", 1, 64),
    (False, "one_long", 5, 264), (True, "standard_mix", 7, 248), (True, "all_long", 32, 256),
    (True, "all_short", 1, 64), (True, "one_long", 5, 264)])
def test_decode_plan_of_the_flagship_on_an_h100(quant, case, chunk, items):
    """8 slots, Hkv = 8, max_blocks = 128 on 132 SMs (grids of 396 for bf16,
    264 for int8; at most 264 items preferred): the standard mix (188 live
    blocks) in chunks of 7; every slot full in chunks of 32 (256 items, run
    in passes of 8 bf16 or 16 int8 blocks); one block per item when all
    slots are short; one long slot and seven idle in chunks of 5."""
    _, _, plan = _decode_plan(POSITIONS[case], 8, 128, 132, quant)
    assert (plan.chunk, len(plan.items)) == (chunk, items)


@pytest.mark.parametrize("seed", range(20))
def test_decode_scratch_bound_holds_for_random_positions(seed):
    rng = np.random.default_rng(seed)
    B, Hkv, MB = int(rng.integers(1, 64)), int(rng.choice([1, 2, 4, 8, 32])), int(rng.integers(1, 160))
    pos = rng.integers(0, MB * 16 + 100, B)
    quant = bool(rng.integers(0, 2))
    n_live, grid, plan = _decode_plan(pos, Hkv, MB, int(rng.choice([1, 16, 132])), quant)
    assert len(plan.items) <= pa.scratch_items(B, Hkv, MB, grid)
    assert sum(j1 - j0 for *_, j0, j1 in plan.items) == Hkv * sum(n_live)


def test_decode_scratch_is_one_zeroed_set_per_stream_and_grows():
    dev = torch.device("cpu")
    for s in (201, 202):
        pa._scratch.pop((dev, s), None)
    acc, ml, tickets = pa.decode_scratch(dev, 201, 10, 4, 64)
    assert acc.numel() >= 10 * 4 * 128 and ml.numel() >= 10 * 4 * 2
    assert tickets.dtype == torch.int32 and tickets.numel() >= 64 and not tickets.any()
    assert pa.decode_scratch(dev, 201, 5, 4, 8)[0] is acc         # big enough: reused
    other = pa.decode_scratch(dev, 202, 10, 4, 64)
    assert other[0].data_ptr() != acc.data_ptr() and other[2].data_ptr() != tickets.data_ptr()
    grown = pa.decode_scratch(dev, 201, 20, 4, 128)
    assert grown[0].numel() >= 20 * 4 * 128 and grown[2].numel() >= 128 and not grown[2].any()
    for s in (201, 202):
        pa._scratch.pop((dev, s))


@pytest.mark.parametrize("total,grid,prefer,want", [
    (188, 396, 264, 6), (275, 396, 264, 16), (2000, 396, 264, 64), (8, 396, 264, 1)])
def test_decode_plan_prefers_fewer_items_then_fits_the_grid(total, grid, prefer, want):
    """One kv head's live blocks spread over 8 slots: the chunk is the
    smallest bf16 size that keeps the items within `prefer` (the engines'
    lengths: 16 blocks, in two passes; long slots: 64), else within the
    grid, else the largest size."""
    n_live = [total // 8 + (i < total % 8) for i in range(8)]
    assert pa.plan_items(n_live, 8, grid, prefer).chunk == want
