"""The plain versions of the port's two int8 decode-attention kernels held to
the JAX package's Pallas kernels in interpret mode on the CPU, on the same
numpy inputs: the int8-pool branch of paged decode
(lws_tpu/ops/paged_attention.py with k_scale/v_scale; the cases of
tests/test_paged_attention_kernel.py:138-168) and int8_decode_attention over
a dense cache (lws_tpu/ops/int8_attention.py; the cases of
tests/test_int8_attention.py:29-46). Inputs are f32, so the tolerance is
f32 summation-order noise (2e-5, as those JAX tests use)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models.llama import _cached_attention as jax_cached_attention
from lws_tpu.models.llama import _dequantize_kv as jax_dequantize_kv
from lws_tpu.models.llama import _quantize_kv as jax_quantize_kv
from lws_tpu.ops.int8_attention import int8_decode_attention as jax_int8_decode
from lws_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from lws_tpu_torch.models.llama import _quantize_kv
from lws_tpu_torch.ops.int8_attention import (
    int8_decode_attention,
    int8_decode_attention_reference,
)
from lws_tpu_torch.ops.paged_attention import (
    paged_decode_attention_int8,
    paged_decode_attention_int8_reference,
)

TOL = 2e-5


def t(a):
    return torch.from_numpy(np.array(a))


def quantized(rng, shape):
    """JAX's int8 values and scales of a standard-normal f32 tensor."""
    q, s = jax_quantize_kv(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    return np.asarray(q), np.asarray(s)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(9).standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale floors at 1e-8 / 127
    q, s = _quantize_kv(t(x))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# Paged decode over an int8 pool


def paged_case(rng, B, H, Hkv, hd, L, num_blocks, bs, max_blocks, pos=None):
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kq, ks = quantized(rng, (L, num_blocks, bs, Hkv, hd))
    vq, vs = quantized(rng, (L, num_blocks, bs, Hkv, hd))
    free = list(range(1, num_blocks))
    rng.shuffle(free)
    if pos is None:
        pos = rng.integers(0, max_blocks * bs, size=B)
    pos = np.asarray(pos, np.int32)
    table = np.zeros((B, max_blocks), np.int32)  # unallocated tail -> null 0
    for b in range(B):
        n_live = pos[b] // bs + 1
        table[b, :n_live] = [free.pop() for _ in range(n_live)]
    return q, kq, ks, vq, vs, table, pos


def both_paged(q, kq, ks, vq, vs, table, pos, layer):
    got = paged_decode_attention_int8(*map(t, (q, kq, ks, vq, vs, table, pos)), layer)
    want = jax_paged(*map(jnp.asarray, (q, kq, vq, table, pos)), layer,
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
    return got.numpy(), np.asarray(want)


def test_paged_int8_plain_matches_jax_kernel_and_dequant_reference():
    """tests/test_paged_attention_kernel.py:148: sequential tables, random
    positions, every layer; also against JAX's dequantize-then-gather path."""
    rng = np.random.default_rng(4)
    B, H, Hkv, hd, L, bs, max_blocks = 4, 8, 2, 128, 2, 8, 4
    num_blocks = B * max_blocks + 1
    q, kq, ks, vq, vs, _, pos = paged_case(rng, B, H, Hkv, hd, L, num_blocks, bs, max_blocks)
    table = np.arange(1, B * max_blocks + 1, dtype=np.int32).reshape(B, max_blocks)
    for layer in range(L):
        got, want = both_paged(q, kq, ks, vq, vs, table, pos, layer)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        k_view = jax_dequantize_kv(jnp.asarray(kq[layer][table]), jnp.asarray(ks[layer][table]),
                                   jnp.float32).reshape(B, -1, Hkv, hd)
        v_view = jax_dequantize_kv(jnp.asarray(vq[layer][table]), jnp.asarray(vs[layer][table]),
                                   jnp.float32).reshape(B, -1, Hkv, hd)
        want_xla = np.asarray(jax_cached_attention(jnp.asarray(q), k_view, v_view,
                                                   jnp.asarray(pos)))
        np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4), (8, 2)])
def test_paged_int8_plain_matches_jax_kernel_scrambled_tables(H, Hkv):
    rng = np.random.default_rng(0)
    B, hd, L, bs, max_blocks = 5, 128, 3, 8, 6
    case = paged_case(rng, B, H, Hkv, hd, L, B * max_blocks + 1, bs, max_blocks)
    for layer in range(L):
        got, want = both_paged(*case, layer)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pos_val", [0, 7, 8, 15, 31])
def test_paged_int8_plain_block_boundary_positions(pos_val):
    rng = np.random.default_rng(1)
    B, H, Hkv, hd, L, bs, max_blocks = 3, 4, 2, 128, 1, 8, 4
    case = paged_case(rng, B, H, Hkv, hd, L, B * max_blocks + 1, bs, max_blocks,
                      pos=[pos_val] * B)
    got, want = both_paged(*case, 0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_paged_int8_plain_ignores_null_and_stale_blocks():
    rng = np.random.default_rng(2)
    B, H, Hkv, hd, L, bs, max_blocks, num_blocks = 3, 8, 2, 128, 2, 8, 4, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kq, ks = quantized(rng, (L, num_blocks, bs, Hkv, hd))
    vq, vs = quantized(rng, (L, num_blocks, bs, Hkv, hd))
    table = np.array([[1, 2, 3, 4], [5, 0, 0, 0], [6, 7, 1, 2]], np.int32)
    pos = np.array([max_blocks * bs - 1, 3, 2 * bs - 1], np.int32)
    for layer in range(L):
        got, want = both_paged(q, kq, ks, vq, vs, table, pos, layer)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    k2, v2, s2 = kq.copy(), vq.copy(), ks.copy()
    k2[:, 0] = v2[:, 0] = 127  # the null block
    k2[:, 6:] = v2[:, 6:] = -127  # blocks 6, 7 are dead for slots 0 and 1
    s2[:, 0] = s2[:, 6:] = 1e3
    got2 = paged_decode_attention_int8(*map(t, (q, k2, s2, v2, vs, table, pos)), 1).numpy()
    got1, _ = both_paged(q, kq, ks, vq, vs, table, pos, 1)
    np.testing.assert_allclose(got2[:2], got1[:2], rtol=TOL, atol=TOL)


def test_paged_int8_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    case = [t(a) for a in paged_case(rng, 2, 4, 2, 128, 2, 9, 8, 4)]
    before = paged_decode_attention_int8.launches
    torch.testing.assert_close(paged_decode_attention_int8(*case, 1),
                               paged_decode_attention_int8_reference(*case, 1), rtol=0, atol=0)
    assert paged_decode_attention_int8.launches == before


# ---------------------------------------------------------------------------
# Dense int8 cache


def dense_case(rng, B=2, T=64, H=8, Hkv=4, hd=32):
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kq, ks = quantized(rng, (B, T, Hkv, hd))
    vq, vs = quantized(rng, (B, T, Hkv, hd))
    return q, kq, ks, vq, vs


def both_dense(q, kq, ks, vq, vs, pos):
    got = int8_decode_attention(*map(t, (q, kq, ks, vq, vs)), pos if isinstance(pos, int) else t(pos))
    want = jax_int8_decode(*map(jnp.asarray, (q, kq, ks, vq, vs)), jnp.asarray(pos),
                           interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pos", [0, 7, 15, 16, 63])
def test_int8_decode_plain_matches_jax_kernel_scalar_pos(pos):
    case = dense_case(np.random.default_rng(0))
    got, want = both_dense(*case, pos)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,pos", [(64, [3, 40, 63]), (50, [0, 16, 49])])
def test_int8_decode_plain_matches_jax_kernel_per_row_pos(T, pos):
    """Per-row positions, including a cache length that is not a multiple of
    the kernel's 16-token block."""
    case = dense_case(np.random.default_rng(1), B=3, T=T)
    got, want = both_dense(*case, np.asarray(pos, np.int32))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_int8_decode_wrapper_on_cpu_is_the_plain_version():
    q, kq, ks, vq, vs = map(t, dense_case(np.random.default_rng(2), hd=128))
    before = int8_decode_attention.launches
    for pos in (5, torch.tensor([5, 60], dtype=torch.int32)):
        torch.testing.assert_close(int8_decode_attention(q, kq, ks, vq, vs, pos),
                                   int8_decode_attention_reference(q, kq, ks, vq, vs, pos),
                                   rtol=0, atol=0)
    assert int8_decode_attention.launches == before
