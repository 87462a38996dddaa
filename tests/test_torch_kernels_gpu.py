"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a): they skip elsewhere. The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch; the repository's conftest imports jax, so run it with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: atol = rtol = 2e-2 on bf16 outputs (bf16 keeps 8 bits; the
kernels keep f32 scores where the plain versions round them to bf16)."""

import numpy as np
import pytest
import torch

from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.ops.attention import flash_attention, reference_attention
from lws_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
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
