"""The port's public surface against the JAX package's, read from both
packages' sources with `ast` (nothing of `lws_tpu` is imported).

Every public top-level function and class of each `lws_tpu/` module, and
every public method of those classes, has a counterpart of the same name in
the same module of `lws_tpu_torch/`, but the names in ALLOWED, each left
out for the reason given there. A name the JAX package gains, or one the
port drops, fails here. The package `__init__` files export JAX's names,
and importing the control plane's modules loads no torch.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

ALLOWED = {
    "models/llama.py:param_shardings":
        "a GSPMD PartitionSpec tree of the parameters; the port shards them by hand over "
        "NCCL (models/llama.py:shard_params)",
    "models/llama.py:cache_shardings":
        "a GSPMD PartitionSpec tree of the dense K/V cache; the port's engines shard their "
        "caches by hand over tp",
    "models/llama.py:paged_cache_shardings":
        "a GSPMD PartitionSpec tree of the paged pool; the port's engines shard it by hand",
    "models/llama.py:paged_kernel_default":
        "the LWS_TPU_PAGED_ATTN gate between the Pallas kernel and XLA; the port sends every "
        "CUDA tensor to its kernel (no switch routes it to the plain version)",
    "ops/int8_matmul.py:supported":
        "whether the Pallas kernel takes a shape; the port's counterpart is `plan`, which "
        "picks a body of csrc/int8_matmul.cu for every shape",
    "parallel/bootstrap.py:assert_platform_from_env":
        "pins jax_platforms; the port picks its device with _device.resolve_device and "
        "--device",
}
# ROADMAP.md's other left-out items have no public name for this scan to
# find, and are listed for the reader: `unroll_cached_layers` (a LlamaConfig
# field choosing a Python loop or lax.scan; eager PyTorch always loops) and
# `obs/device._listener` (the jax.monitoring hook; ops/_ext.build feeds the
# port's compile ledger). JAX's private `_seq_shard` (llama.py:354, the
# training forward's sequence sharding over (cp, tp) between blocks) is not
# left out: the port's training forward holds the same layout through
# `seq_gather` and `seq_scatter` (tests/test_torch_train_parallel.py checks
# it).
PRIVATE_LEFT_OUT = ("models/flagship.py:unroll_cached_layers", "obs/device.py:_listener")


def public_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def missing() -> dict:
    """{'module:name': ...} of every public JAX name with no port namesake."""
    out = {}
    for path in sorted((REPO / "lws_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "lws_tpu").as_posix()
        port = REPO / "lws_tpu_torch" / rel
        if not port.exists():
            out[f"{rel}:*"] = "no port module"
            continue
        for name in sorted(public_names(path) - public_names(port)):
            out[f"{rel}:{name}"] = "no port namesake"
    return out


def test_every_public_jax_name_has_a_port_namesake_but_the_allowlist():
    gaps = missing()
    assert {k: v for k, v in gaps.items() if k not in ALLOWED} == {}
    # The allowlist names only real gaps: a name the port gains leaves it.
    assert sorted(gaps) == sorted(ALLOWED)


def test_the_private_left_out_items_are_still_what_roadmap_says():
    for item in PRIVATE_LEFT_OUT:
        rel, name = item.split(":")
        assert name in (REPO / "lws_tpu" / rel).read_text(), item
        assert f"def {name}" not in (REPO / "lws_tpu_torch" / rel).read_text(), item


def exported(init: Path) -> set:
    """The names a package `__init__` binds: its imports, and the keys of an
    `_EXPORTS` table that a module `__getattr__` imports on first access."""
    tree = ast.parse(init.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "_EXPORTS" for t in targets):
                out |= {k.value for k in node.value.keys}
    return out


@pytest.mark.parametrize("pkg", ["core", "obs", "serving", "models"])
def test_package_inits_export_jax_names(pkg):
    want = exported(REPO / "lws_tpu" / pkg / "__init__.py")
    got = exported(REPO / "lws_tpu_torch" / pkg / "__init__.py")
    left_out = {"param_shardings"} if pkg == "models" else set()
    assert want - got == left_out
    assert want and got >= want - left_out


def test_the_lazy_exports_resolve():
    from lws_tpu_torch import models, serving

    for pkg in (models, serving):
        for name in pkg.__all__:
            assert getattr(pkg, name).__name__ == name
        with pytest.raises(AttributeError):
            pkg.no_such_name  # noqa: B018


def test_the_control_plane_imports_load_no_torch():
    """`python -m lws_tpu_torch`'s control-plane commands, and the core and
    obs packages with their re-exports, start without torch."""
    code = ("import sys\n"
            "import lws_tpu_torch.cli, lws_tpu_torch.core, lws_tpu_torch.obs\n"
            "import lws_tpu_torch.serving, lws_tpu_torch.models, lws_tpu_torch.client\n"
            "import lws_tpu_torch.testing\n"
            "from lws_tpu_torch import obs, core\n"
            "obs.HistoryRing, core.Store, obs.COMPILE_LEDGER\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
