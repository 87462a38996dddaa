"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a): they skip elsewhere. The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch; the repository's conftest imports jax, so run it with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: atol = rtol = 2e-2 on bf16 outputs (bf16 keeps 8 bits; the
kernels keep f32 scores where the plain versions round them to bf16). The
int8_matmul kernel's outputs are compared at 2e-2 of the output's magnitude:
kernel and plain version both sum in f32 and round once to bf16, in
different orders."""

import numpy as np
import pytest
import torch

from lws_tpu_torch.models import flagship as tflagship
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.ops.attention import flash_attention, reference_attention
from lws_tpu_torch.ops.int8_attention import (
    int8_decode_attention,
    int8_decode_attention_reference,
)
from lws_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
from lws_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_reference,
    paged_decode_attention_reference,
)

pytestmark = pytest.mark.gpu
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; on the card run: "
                    "python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py")
    return torch.device("cuda")


def randn(g, *shape, dev):
    return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,Skv,H,Hkv", [(1, 1, 4, 4), (17, 17, 32, 8), (64, 64, 8, 2),
                                         (65, 65, 32, 8), (200, 200, 4, 1), (48, 200, 8, 8)])
def test_flash_kernel_matches_plain(dev, S, Skv, H, Hkv, causal):
    g = torch.Generator(device=dev).manual_seed(S * 1000 + Skv)
    q, k, v = randn(g, 2, S, H, 128, dev=dev), randn(g, 2, Skv, Hkv, 128, dev=dev), \
        randn(g, 2, Skv, Hkv, 128, dev=dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S", [(1, 127), (1, 128), (1, 129), (1, 1000), (8, 512)])
def test_flash_kernel_flagship_heads_ragged_tiles(dev, B, S, causal):
    """GQA 32/8 at q-tile edges of the 128-row tile (127, 128, 129), a
    ragged long prompt, and the dense engine's batched prefill."""
    g = torch.Generator(device=dev).manual_seed(B * 10000 + S)
    q, k, v = randn(g, B, S, 32, 128, dev=dev), randn(g, B, S, 8, 128, dev=dev), \
        randn(g, B, S, 8, 128, dev=dev)
    got = flash_attention(q, k, v, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


def _paged_case(dev, B, H, Hkv, L, NB, bs, MB, pos, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = randn(g, B, 1, H, 128, dev=dev)
    k_pool, v_pool = randn(g, L, NB, bs, Hkv, 128, dev=dev), randn(g, L, NB, bs, Hkv, 128, dev=dev)
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, NB)))
    table = np.zeros((B, MB), np.int32)
    for b, p in enumerate(pos):
        n_live = p // bs + 1
        table[b, :n_live] = [free.pop() for _ in range(n_live)]
    return (q, k_pool, v_pool, torch.tensor(table, device=dev),
            torch.tensor(np.asarray(pos, np.int32), device=dev))


@pytest.mark.parametrize("H,Hkv", [(32, 8), (4, 4), (8, 2)])
def test_paged_kernel_matches_plain_scrambled(dev, H, Hkv):
    bs, MB = 16, 8
    pos = [0, bs - 1, bs, 2 * bs - 1, 77, MB * bs - 1]
    case = _paged_case(dev, len(pos), H, Hkv, 3, len(pos) * MB + 1, bs, MB, pos)
    for layer in range(3):
        got = paged_decode_attention(*case, layer)
        want = paged_decode_attention_reference(*case, layer)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


def test_paged_kernel_null_and_stale_rows(dev):
    """A released slot (all-null row) reads block 0 harmlessly; stale tail
    entries pointing at another slot's blocks are never attended."""
    bs, MB = 16, 4
    q, k_pool, v_pool, table, pos = _paged_case(dev, 3, 32, 8, 2, 13, bs, MB, [40, 5, 20], seed=1)
    table[1] = 0
    table[2, 2:] = table[0, :2]
    got = paged_decode_attention(q, k_pool, v_pool, table, pos, 1)
    want = paged_decode_attention_reference(q, k_pool, v_pool, table, pos, 1)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    k_pool[:, table[0, :2].long()] = 100.0  # scribble on slot 0's blocks
    again = paged_decode_attention(q, k_pool, v_pool, table, pos, 1)
    torch.testing.assert_close(again[1:], got[1:], atol=0, rtol=0)


def test_kernels_raise_on_what_they_do_not_take(dev):
    q = torch.zeros(1, 4, 4, 128, device=dev)  # f32: no silent fallback
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention(*(torch.zeros(1, 4, 4, 64, device=dev, dtype=torch.bfloat16),) * 3)


def test_decode_and_prefill_logits_kernel_vs_plain_small_model(dev):
    cfg = tl.LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                         d_ff=1024, max_seq_len=256, param_dtype=torch.bfloat16)
    model = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(1, 512, (1, 64), device=dev)
    lk, ck = tl.forward_prefill(model, tokens, tl.init_cache(cfg, 1, 64, dev), last_pos=50)
    lp, _ = tl.forward_prefill(model, tokens, tl.init_cache(cfg, 1, 64, dev), last_pos=50,
                               plain=True)
    assert ((lk - lp).abs().max() / lp.abs().max()).item() < 5e-2
    pool = tl.init_paged_cache(cfg, 6, 16, dev)
    tl.paged_insert(pool, ck.k[:, 0], ck.v[:, 0], torch.arange(1, 5, device=dev))
    pool2 = tl.PagedKVCache(pool.k.clone(), pool.v.clone())
    table = torch.tensor([[1, 2, 3, 4, 0, 0, 0, 0]], dtype=torch.int32, device=dev)
    pos = torch.tensor([51], dtype=torch.int32, device=dev)
    tok = lk.argmax(-1).to(torch.int32)
    dk, _ = tl.forward_decode_paged(model, tok, pool, table, pos)
    dp, _ = tl.forward_decode_paged(model, tok, pool2, table, pos, plain=True)
    assert ((dk - dp).abs().max() / dp.abs().max()).item() < 5e-2


# ---------------------------------------------------------------------------
# int8 kernels


def int8s(g, *shape, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


@pytest.mark.parametrize("m,D,F", [(1, 512, 256), (8, 4096, 1024), (24, 1024, 512),
                                   (256, 4096, 4096), (8, 14336, 4096), (3, 1000, 200),
                                   (17, 136, 77), (100, 520, 1000), (64, 4096, 128256),
                                   (128, 4096, 14336)])
def test_int8_matmul_kernel_matches_plain(dev, m, D, F):
    """Flagship and small shapes, single and split D, and ragged D and F
    (D not a multiple of 16 takes the byte loads; F not of 64 the guarded
    stores)."""
    g = torch.Generator(device=dev).manual_seed(m + D + F)
    x = randn(g, m, D, dev=dev)
    q = int8s(g, F, D, dev=dev)
    scale = torch.rand(F, generator=g, device=dev) * D**-0.5 / 73.3
    before = int8_matmul.launches
    got = int8_matmul(x, q, scale)
    want = int8_matmul_reference(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1 and got.shape == (m, F)
    mag = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL * mag, rtol=TOL)


FLAGSHIP_PRODUCTS = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


def _int8_case(dev, m, D, F, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (randn(g, m, D, dev=dev), int8s(g, F, D, dev=dev),
            torch.rand(F, generator=g, device=dev) * D**-0.5 / 73.3)


def _assert_matches_plain(x, q, scale, got):
    want = int8_matmul_reference(x, q, scale)
    mag = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL * mag, rtol=TOL)


@pytest.mark.parametrize("D,F", FLAGSHIP_PRODUCTS + [(1000, 300)])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 128, 200, 256])
def test_int8_matmul_kernel_body_edges(dev, m, D, F):
    """Every body boundary (8 and 16 rows: the swapped body; 17..256: the
    tensor-core body) on the flagship's five products and a ragged D, F."""
    x, q, scale = _int8_case(dev, m, D, F, seed=m * 7 + D + F)
    before = int8_matmul.launches
    got = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1 and got.shape == (m, F)
    _assert_matches_plain(x, q, scale, got)


@pytest.mark.parametrize("m,D,F", [(8, 4096, 1024), (1, 14336, 4096), (128, 4096, 4096),
                                   (9, 1000, 300)])
def test_int8_matmul_split_k_is_bitwise_repeatable(dev, m, D, F):
    """Split-K products sum their partials in split order inside the kernel:
    two calls give the same bits, and the tile counters are reset."""
    from lws_tpu_torch.ops.int8_matmul import plan

    assert plan(m, D, F, torch.cuda.get_device_properties(dev).multi_processor_count).splits > 1
    x, q, scale = _int8_case(dev, m, D, F, seed=11)
    first = int8_matmul(x, q, scale)
    second = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_matches_plain(x, q, scale, first)


def test_int8_matmul_after_a_product_of_another_shape(dev):
    """Products of different shapes and split counts back to back on one
    stream: each is right, so no counter is left stale between launches."""
    cases = [_int8_case(dev, m, D, F, seed=i) for i, (m, D, F) in enumerate(
        [(8, 4096, 1024), (8, 4096, 14336), (1, 14336, 4096), (200, 4096, 1024),
         (16, 4096, 4096), (8, 4096, 1024)])]
    outs = [int8_matmul(*c) for c in cases]
    torch.cuda.synchronize()
    for c, got in zip(cases, outs):
        _assert_matches_plain(*c, got)


@pytest.mark.parametrize("shapes", [((8, 4096, 1024), (8, 4096, 1024)),
                                    ((8, 4096, 1024), (128, 4096, 4096))])
def test_int8_matmul_split_products_on_two_streams_at_once(dev, shapes):
    """Split products queued on two streams behind a spin run at the same
    time; each stream takes tickets from its own tile counters, so every
    output is bitwise the one the same product gives alone. Each product
    has its own x, so a sum over another launch's partials would show."""
    reps = 16
    g = torch.Generator(device=dev).manual_seed(21)
    cases = []
    for i, (m, D, F) in enumerate(shapes):
        _, q, scale = _int8_case(dev, m, D, F, seed=22 + i)
        cases.append([(randn(g, m, D, dev=dev), q, scale) for _ in range(reps)])
    want = [[int8_matmul(*c) for c in cs] for cs in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)  # ~10 ms: both queues fill before either runs
    outs = [[], []]
    for r in range(reps):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(int8_matmul(*cases[i][r]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(got, w) for got, w in zip(outs[i], want[i]))


@pytest.mark.parametrize("m", [100, 256])
def test_int8_matmul_unaligned_rows_take_the_mma_sync_body(dev, m):
    """Above 64 rows TMA reads both operands (the wgmma body) only from
    16-byte aligned pointers; an x that is not takes the mma.sync body."""
    from lws_tpu_torch.ops.int8_matmul import plan

    g = torch.Generator(device=dev).manual_seed(m)
    x = randn(g, m * 4096 + 1, dev=dev)[1:].view(m, 4096)  # 2-byte aligned, contiguous
    q, scale = int8s(g, 1024, 4096, dev=dev), torch.rand(1024, generator=g, device=dev) * 1e-2
    assert plan(m, 4096, 1024, 132, aligned=False).bm == 64 != plan(m, 4096, 1024, 132).bm
    _assert_matches_plain(x, q, scale, int8_matmul(x, q, scale))


def test_int8_matmul_leading_dims_and_unaligned_x(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    x = randn(g, 2, 3, 520, dev=dev)
    q, scale = int8s(g, 96, 520, dev=dev), torch.rand(96, generator=g, device=dev)
    got = int8_matmul(x, q, scale)
    assert got.shape == (2, 3, 96)
    torch.testing.assert_close(got.float(), int8_matmul_reference(x, q, scale).float(),
                               atol=TOL * 50, rtol=TOL)
    flat = randn(g, 2 * 520 + 1, dev=dev)[1:].view(2, 520)  # 2-byte aligned, contiguous
    torch.testing.assert_close(int8_matmul(flat, q, scale).float(),
                               int8_matmul_reference(flat, q, scale).float(), atol=TOL * 50,
                               rtol=TOL)


def _int8_paged_case(dev, B, H, Hkv, L, NB, MB, pos, seed=0):
    q, k_pool, v_pool, table, pos_t = _paged_case(dev, B, H, Hkv, L, NB, 16, MB, pos, seed)
    kq, ks = tl._quantize_kv(k_pool)
    vq, vs = tl._quantize_kv(v_pool)
    return q, kq, ks, vq, vs, table, pos_t


@pytest.mark.parametrize("H,Hkv", [(32, 8), (4, 4), (8, 2)])
def test_paged_int8_kernel_matches_plain_scrambled(dev, H, Hkv):
    MB = 8
    pos = [0, 15, 16, 31, 77, MB * 16 - 1]
    case = _int8_paged_case(dev, len(pos), H, Hkv, 3, len(pos) * MB + 1, MB, pos)
    before = paged_decode_attention_int8.launches
    for layer in range(3):
        got = paged_decode_attention_int8(*case, layer)
        want = paged_decode_attention_int8_reference(*case, layer)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    assert paged_decode_attention_int8.launches == before + 3


def test_paged_int8_kernel_null_and_stale_rows(dev):
    q, kq, ks, vq, vs, table, pos = _int8_paged_case(dev, 3, 32, 8, 2, 13, 4, [40, 5, 20], 1)
    table[1] = 0
    table[2, 2:] = table[0, :2]
    got = paged_decode_attention_int8(q, kq, ks, vq, vs, table, pos, 1)
    want = paged_decode_attention_int8_reference(q, kq, ks, vq, vs, table, pos, 1)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    ks[:, table[0, :2].long()] = 1e3  # scribble on slot 0's blocks
    again = paged_decode_attention_int8(q, kq, ks, vq, vs, table, pos, 1)
    torch.testing.assert_close(again[1:], got[1:], atol=0, rtol=0)


@pytest.mark.parametrize("T,pos,Hkv", [(2048, [0, 15, 16, 2047, 517, 1000, 31, 1500], 8),
                                       (2048, 1000, 8), (50, [0, 16, 49], 8), (40, 39, 8),
                                       (64, 5000, 8), (50, [0, 16, 49], 1), (300, [7, 299], 16)])
def test_int8_decode_kernel_matches_plain(dev, T, pos, Hkv):
    """Mixed per-row and scalar positions, block edges, a cache length that
    is not a multiple of 16, and a position past the cache (every key).
    With Hkv = 1 and T = 50 a block's scales do not start on 16 bytes, and
    with Hkv = 16 they span more than 8 heads: both take 4-byte copies."""
    B = len(pos) if isinstance(pos, list) else 3
    g = torch.Generator(device=dev).manual_seed(T)
    q = randn(g, B, 1, 32, 128, dev=dev)
    kq, ks = tl._quantize_kv(randn(g, B, T, Hkv, 128, dev=dev))
    vq, vs = tl._quantize_kv(randn(g, B, T, Hkv, 128, dev=dev))
    p = torch.tensor(pos, dtype=torch.int32, device=dev) if isinstance(pos, list) else pos
    before = int8_decode_attention.launches
    got = int8_decode_attention(q, kq, ks, vq, vs, p)
    want = int8_decode_attention_reference(q, kq, ks, vq, vs, p)
    torch.cuda.synchronize()
    assert int8_decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


def test_int8_kernels_raise_on_what_they_do_not_take(dev):
    x = torch.zeros(4, 512, device=dev)  # f32 x: no silent fallback
    q, s = torch.zeros(256, 512, dtype=torch.int8, device=dev), torch.ones(256, device=dev)
    with pytest.raises(TypeError):
        int8_matmul(x, q, s)
    with pytest.raises(ValueError):  # more rows than the kernel takes
        int8_matmul(torch.zeros(257, 512, dtype=torch.bfloat16, device=dev), q, s)
    with pytest.raises(ValueError):  # D mismatch
        int8_matmul(torch.zeros(4, 256, dtype=torch.bfloat16, device=dev), q, s)
    qa = torch.zeros(2, 1, 8, 128, dtype=torch.bfloat16, device=dev)
    kv = torch.zeros(2, 32, 2, 128, dtype=torch.int8, device=dev)
    sc = torch.ones(2, 32, 2, device=dev)
    with pytest.raises(TypeError):
        int8_decode_attention(qa, kv.float(), sc, kv, sc, 3)
    with pytest.raises(ValueError):
        int8_decode_attention(qa, kv, sc[:, :16], kv, sc, 3)
    pool = torch.zeros(1, 3, 16, 2, 128, dtype=torch.int8, device=dev)
    psc = torch.ones(1, 3, 16, 2, device=dev)
    table = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        paged_decode_attention_int8(qa, pool, psc.half(), pool, psc, table, pos, 0)
    with pytest.raises(ValueError):
        paged_decode_attention_int8(qa, pool, psc, pool, psc, table, pos, 1)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_int8_model_logits_kernel_vs_plain(dev, kv_quant):
    """A small int8-weight model: prefill, a paged decode step and a dense
    cached step, kernel path against the plain path (plain=True)."""
    cfg = tl.LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                         d_ff=1024, max_seq_len=256, param_dtype=torch.bfloat16,
                         kv_quant=kv_quant)
    model = tflagship.init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                            device=dev)
    tokens = torch.randint(1, 512, (1, 64), device=dev)
    before = int8_matmul.launches
    ck = tl.init_cache(cfg, 1, 80, dev)
    lk, ck = tl.forward_prefill(model, tokens, ck, last_pos=50)
    lp, cp = tl.forward_prefill(model, tokens, tl.init_cache(cfg, 1, 80, dev), last_pos=50,
                                plain=True)
    assert int8_matmul.launches == before + 7 * cfg.n_layers + 1
    assert ((lk - lp).abs().max() / lp.abs().max()).item() < 5e-2
    scales = (ck.k_scale[:, 0, :64], ck.v_scale[:, 0, :64]) if kv_quant else ()
    pool = tl.init_paged_cache(cfg, 6, 16, dev)
    tl.paged_insert(pool, ck.k[:, 0, :64], ck.v[:, 0, :64], torch.arange(1, 5, device=dev),
                    *scales)
    pool2 = tl.PagedKVCache(*(None if a is None else a.clone()
                              for a in (pool.k, pool.v, pool.k_scale, pool.v_scale)))
    table = torch.tensor([[1, 2, 3, 4, 0, 0, 0, 0]], dtype=torch.int32, device=dev)
    pos = torch.tensor([51], dtype=torch.int32, device=dev)
    tok = lk.argmax(-1).to(torch.int32)
    dk, _ = tl.forward_decode_paged(model, tok, pool, table, pos)
    dp, _ = tl.forward_decode_paged(model, tok, pool2, table, pos, plain=True)
    assert ((dk - dp).abs().max() / dp.abs().max()).item() < 5e-2
    ck.pos = cp.pos = 51
    wk, _ = tl.forward_with_cache(model, tok[:, None], ck)
    wp, _ = tl.forward_with_cache(model, tok[:, None], cp, plain=True)
    assert ((wk - wp).abs().max() / wp.abs().max()).item() < 5e-2


# ---------------------------------------------------------------------------
# Paged decode: the device-planned work items, both pools


def _pool_case(dev, pos, H, Hkv, MB, quant, seed=0, L=2):
    """Pools holding just the live blocks (plus the null block 0), a
    scrambled table, q and positions; with `quant` the int8 pools and
    scales."""
    n_live = [min(p // 16 + 1, MB) for p in pos]
    case = _paged_case(dev, len(pos), H, Hkv, L, sum(n_live) + 1, 16, MB,
                       [min(p, MB * 16 - 1) for p in pos], seed)
    q, k_pool, v_pool, table, _ = case
    pos_t = torch.tensor(np.asarray(pos, np.int32), device=dev)
    if not quant:
        return q, k_pool, v_pool, table, pos_t
    kq, ks = tl._quantize_kv(k_pool)
    vq, vs = tl._quantize_kv(v_pool)
    return q, kq, ks, vq, vs, table, pos_t


def _paged_fns(quant):
    return ((paged_decode_attention_int8, paged_decode_attention_int8_reference) if quant
            else (paged_decode_attention, paged_decode_attention_reference))


PLAN_CASES = {  # name: (positions, H, Hkv, max_blocks)
    "one_long": ([2047] + [0] * 7, 32, 8, 128),
    "all_long": ([2047] * 8, 32, 8, 128),
    "boundaries": ([15, 16, 31, 32, 127, 128, 255, 256], 32, 8, 128),
    "capped": ([5000, 2047, 300, 4096], 32, 8, 64),
    "one_slot": ([700], 32, 8, 128),
    "thirty_two": ([int(x) for x in np.random.default_rng(3).integers(0, 2048, 32)], 32, 8, 128),
    "g1": ([15, 16, 900, 2047], 8, 8, 128),
    "g4": ([15, 1000, 517, 40], 16, 4, 128),
    "g24": ([31, 600, 0], 24, 1, 64),
    "g32": ([17, 1500], 32, 1, 128),
    "hkv16": ([15, 1000, 2047, 40], 32, 16, 128),  # int8 scales past 8 heads: 4-byte copies
}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_paged_kernels_plan_shapes_match_plain(dev, case, quant):
    """Imbalanced and full-length slots, block boundaries, positions past
    max_blocks, one and 32 slots, and G = 1, 4, 24 and 32 query heads per kv
    head, for both pools, against the plain versions."""
    pos, H, Hkv, MB = PLAN_CASES[case]
    fn, plain = _paged_fns(quant)
    args = _pool_case(dev, pos, H, Hkv, MB, quant, seed=len(pos) + H)
    before = fn.launches
    got = fn(*args, 1)
    want = plain(*args, 1)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    # Outputs over long slots are small (~0.03), so also against their norm:
    # a lost 16-key block moves it by ~15 % at 2,048 keys.
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= 1e-2, rel


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_are_bitwise_repeatable(dev, quant):
    """Chunks are merged in chunk order by whichever CTA finishes last, so
    repeated launches give the same bits, and the tickets are left at 0."""
    fn, _ = _paged_fns(quant)
    args = _pool_case(dev, [15, 16, 31, 1000, 517, 263, 1063, 40], 32, 8, 128, quant, seed=5)
    first = fn(*args, 0)
    outs = [fn(*args, 0) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_on_two_streams_at_once(dev, quant):
    """Launches queued on two streams behind a spin run at the same time;
    each stream has its own tickets and partials, so every output is
    bitwise the one the launch gives alone. Each launch has its own q, so a
    merge over another launch's partials would show."""
    fn, _ = _paged_fns(quant)
    reps = 12
    base = _pool_case(dev, [2047, 1000, 0, 517, 1063, 40, 300, 1500], 32, 8, 128, quant, seed=9)
    g = torch.Generator(device=dev).manual_seed(31)
    qs = [[randn(g, *base[0].shape, dev=dev) for _ in range(reps)] for _ in range(2)]
    want = [[fn(q, *base[1:], 1) for q in qq] for qq in qs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
    outs = [[], []]
    for r in range(reps):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(fn(qs[i][r], *base[1:], 1))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(got, w) for got, w in zip(outs[i], want[i]))


def test_int8_decode_kernel_is_bitwise_repeatable(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    q = randn(g, 8, 1, 32, 128, dev=dev)
    kq, ks = tl._quantize_kv(randn(g, 8, 2048, 8, 128, dev=dev))
    vq, vs = tl._quantize_kv(randn(g, 8, 2048, 8, 128, dev=dev))
    pos = torch.tensor([0, 15, 16, 2047, 517, 1000, 263, 1500], dtype=torch.int32, device=dev)
    first = int8_decode_attention(q, kq, ks, vq, vs, pos)
    again = [int8_decode_attention(q, kq, ks, vq, vs, pos) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in again)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_never_use_rows_past_pos(dev, quant):
    """Rows past a slot's position in its last block may be unwritten: with
    NaN there (K, V and, for int8, the scales) the outputs stay finite and
    equal the plain version's over clean pools."""
    fn, plain = _paged_fns(quant)
    pos = [15, 16, 31, 1000, 517, 263, 1063, 40]
    args = list(_pool_case(dev, pos, 32, 8, 128, quant, seed=13))
    want = plain(*args, 1)
    table = args[-2]
    for b, p in enumerate(pos):
        blk = int(table[b, p // 16])
        for t in args[1:-2]:  # pools and scales
            if t.dtype == torch.int8:
                t[1, blk, p % 16 + 1:] = 127
            else:
                t[1, blk, p % 16 + 1:] = float("nan")
    got = fn(*args, 1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,Hkv", [(1000, 8), (1001, 1)])
def test_int8_decode_kernel_never_uses_rows_past_pos(dev, T, Hkv):
    """The dense cache past each row's position (and past T in a partial
    last block) may hold NaN scales: the output is the plain version's,
    with the scales fetched whole (Hkv = 8) or by 4-byte copies (T * Hkv
    odd)."""
    g = torch.Generator(device=dev).manual_seed(14)
    B = 4  # T % 16 != 0: a partial last block
    q = randn(g, B, 1, 32, 128, dev=dev)
    kq, ks = tl._quantize_kv(randn(g, B, T, Hkv, 128, dev=dev))
    vq, vs = tl._quantize_kv(randn(g, B, T, Hkv, 128, dev=dev))
    pos = torch.tensor([0, 17, 517, T - 1], dtype=torch.int32, device=dev)
    want = int8_decode_attention_reference(q, kq, ks, vq, vs, pos)
    for b, p in enumerate(pos.tolist()):
        ks[b, p + 1:] = float("nan")
        vs[b, p + 1:] = float("nan")
    got = int8_decode_attention(q, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
