"""Launch planning of the int8_matmul kernel (lws_tpu_torch/ops/int8_matmul.py
`plan`): a pure function of (M, D, F, SM count), so it is checked here on
the CPU for the flagship's products and odd shapes. The kernel itself runs
only on the card (tests/test_torch_kernels_gpu.py)."""

import pytest
import torch

from lws_tpu_torch.ops import _ext
from lws_tpu_torch.ops import int8_matmul as im

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


@pytest.mark.parametrize("base,blocks", [(16, 32), (224, 32), (64, 112), (2004, 32), (1, 1),
                                         (528, 8), (1, 1000)])
def test_split_counts_fill_the_card_without_empty_splits(base, blocks):
    splits, per = _ext.split_counts(132, base, blocks)
    assert 1 <= splits <= blocks and splits * per >= blocks and (splits - 1) * per < blocks
    if base >= _ext.CTAS_PER_SM * 132:
        assert splits == 1  # enough tiles already: no split


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
