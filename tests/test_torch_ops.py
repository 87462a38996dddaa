"""The port's attention ops (lws_tpu_torch/ops) held to the JAX package on
the CPU: the plain versions of the two CUDA kernels against the Pallas
kernels in interpret mode and against the JAX plain references, on the same
numpy inputs. Inputs are f32, so the tolerance is f32 summation-order noise
(2e-5, as tests/test_ops.py and tests/test_paged_attention_kernel.py use).

Also here: the package's import boundary (no jax, no lws_tpu) and the CPU
behaviour of the kernel wrappers."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lws_tpu.models.llama import _cached_attention as jax_cached_attention
from lws_tpu.ops.attention import flash_attention as jax_flash
from lws_tpu.ops.attention import reference_attention as jax_reference
from lws_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from lws_tpu_torch.ops.attention import attention, flash_attention, reference_attention
from lws_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)

TOL = 2e-5
REPO = Path(__file__).resolve().parent.parent


def qkv(rng, B, S, H, Hkv, D):
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("S,H,Hkv", [(1, 4, 2), (64, 4, 4), (200, 8, 2), (256, 4, 1)])
def test_reference_attention_matches_jax_flash_and_reference(S, H, Hkv):
    """Causal GQA/MHA, ragged S (200 pads to the Pallas block inside JAX)."""
    rng = np.random.default_rng(S)
    q, k, v = qkv(rng, 2, S, H, Hkv, 32)
    got = reference_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    want_flash = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                      block_q=128, block_k=128, interpret=True))
    want_ref = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    np.testing.assert_allclose(got, want_flash, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)


def test_reference_attention_non_causal_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = qkv(rng, 1, 128, 8, 2, 32)
    got = reference_attention(*map(torch.from_numpy, (q, k, v)), causal=False).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                block_q=128, block_k=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_attention_on_cpu_is_the_plain_version_and_the_kernel_wrapper_refuses_cpu():
    rng = np.random.default_rng(8)
    q, k, v = map(torch.from_numpy, qkv(rng, 1, 33, 4, 2, 128))
    torch.testing.assert_close(attention(q, k, v), reference_attention(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# Paged decode: the plain version against the Pallas kernel (interpret mode),
# mirroring tests/test_paged_attention_kernel.py's cases.


def make_case(rng, B, H, Hkv, hd, L, num_blocks, bs, max_blocks):
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k_pool = rng.standard_normal((L, num_blocks, bs, Hkv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((L, num_blocks, bs, Hkv, hd)).astype(np.float32)
    table = np.zeros((B, max_blocks), np.int32)  # unallocated tail -> null 0
    free = list(range(1, num_blocks))
    rng.shuffle(free)
    pos = np.empty((B,), np.int32)
    for b in range(B):
        pos[b] = rng.integers(0, max_blocks * bs)
        n_live = pos[b] // bs + 1
        table[b, :n_live] = [free.pop() for _ in range(n_live)]
    return q, k_pool, v_pool, table, pos


def both(q, k_pool, v_pool, table, pos, layer):
    got = paged_decode_attention(*map(torch.from_numpy, (q, k_pool, v_pool, table, pos)), layer)
    want = jax_paged(*map(jnp.asarray, (q, k_pool, v_pool, table, pos)), layer, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4), (8, 2)])
def test_paged_plain_matches_jax_kernel_scrambled_tables(H, Hkv):
    rng = np.random.default_rng(0)
    B, hd, L, bs, max_blocks = 5, 128, 3, 8, 6
    case = make_case(rng, B, H, Hkv, hd, L, B * max_blocks + 1, bs, max_blocks)
    for layer in range(L):
        got, want = both(*case, layer)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pos_val", [0, 7, 8, 15, 31])
def test_paged_plain_block_boundary_positions(pos_val):
    """pos at block edges (bs = 8): the last live block holds exactly one
    token or is exactly full."""
    rng = np.random.default_rng(1)
    B, H, Hkv, hd, L, bs, max_blocks = 4, 4, 2, 128, 1, 8, 4
    q, k_pool, v_pool, _, _ = make_case(rng, B, H, Hkv, hd, L, B * max_blocks + 1, bs, max_blocks)
    table = np.arange(1, B * max_blocks + 1, dtype=np.int32).reshape(B, max_blocks)
    pos = np.full((B,), pos_val, np.int32)
    got, want = both(q, k_pool, v_pool, table, pos, 0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_paged_plain_ignores_null_and_stale_blocks():
    """Dead table entries point at the null block and at blocks another slot
    owns; neither may leak into a slot's attention."""
    rng = np.random.default_rng(2)
    B, H, Hkv, hd, L, bs, max_blocks, num_blocks = 3, 8, 2, 128, 2, 8, 4, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k_pool = rng.standard_normal((L, num_blocks, bs, Hkv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((L, num_blocks, bs, Hkv, hd)).astype(np.float32)
    table = np.array([[1, 2, 3, 4], [5, 0, 0, 0], [6, 7, 1, 2]], np.int32)
    pos = np.array([max_blocks * bs - 1, 3, 2 * bs - 1], np.int32)
    for layer in range(L):
        got, want = both(q, k_pool, v_pool, table, pos, layer)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # Scribbling over the dead entries' blocks changes nothing.
    k2, v2 = k_pool.copy(), v_pool.copy()
    k2[:, 0] = v2[:, 0] = 1e3  # the null block
    k2[:, 6:] = v2[:, 6:] = -1e3  # blocks 6, 7 are dead for slot 0 and slot 1
    got2 = paged_decode_attention(*map(torch.from_numpy, (q, k2, v2, table, pos)), 1).numpy()
    got1, _ = both(q, k_pool, v_pool, table, pos, 1)
    np.testing.assert_allclose(got2[:2], got1[:2], rtol=TOL, atol=TOL)


def test_paged_plain_is_gather_then_jax_cached_attention():
    """The plain version is exactly the gather path of forward_decode_paged
    followed by _cached_attention."""
    rng = np.random.default_rng(3)
    q, k_pool, v_pool, table, pos = make_case(rng, 3, 8, 2, 16, 2, 13, 4, 4)
    got = paged_decode_attention_reference(
        *map(torch.from_numpy, (q, k_pool, v_pool, table, pos)), 1).numpy()
    k_view = k_pool[1][table].reshape(3, -1, 2, 16)
    v_view = v_pool[1][table].reshape(3, -1, 2, 16)
    want = np.asarray(jax_cached_attention(*map(jnp.asarray, (q, k_view, v_view, pos))))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Import boundary: the port never imports jax or the JAX package.


def _port_sources():
    return sorted((REPO / "lws_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_lws_tpu():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "lws_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
    assert not offenders, offenders


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "lws_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lws_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
