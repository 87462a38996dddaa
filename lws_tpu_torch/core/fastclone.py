"""The store's native clone: csrc/fastclone.c (the port's copy of the JAX
package's native/fastclone.c, CPython C API) built with the host C
compiler and the Python headers, and loaded as an extension module.

`load()` builds the library at its first call in a checkout, into
`lws_tpu_torch/_build/_fastclone-<hash><EXT_SUFFIX>`, the hash taken over
the source, the compiler command and the Python headers' directory, so a
changed source or another interpreter builds anew and a built one is found
again. Processes that start together (test workers, a `serve` and its
workers) take turns on an exclusive lock on `_build/.lock`, the one the
CUDA kernels' build takes (ops/_ext.py): the first compiles, the others
find the library by its hash. `CC` names the compiler (default gcc).

Any failure (no compiler, no `Python.h`, a compile error, a load error)
raises `BuildError` with the reason; core/store.py then clones in Python
and names that reason in `clone_info()`.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastclone.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O2", "-fPIC", "-shared", "-Wall", "-Wextra")  # native/build.py's


class BuildError(RuntimeError):
    pass


def _command(out: Path) -> list:
    cc = os.environ.get("CC", "gcc")
    if shutil.which(cc) is None:
        raise BuildError(f"no C compiler: {cc!r} is not on PATH (set CC)")
    include = sysconfig.get_path("include")
    if not os.path.isfile(os.path.join(include, "Python.h")):
        raise BuildError(f"no Python headers: {include}/Python.h does not exist")
    return [cc, *CFLAGS, "-o", str(out), str(SOURCE), f"-I{include}"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(_command(Path("-"))).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_fastclone-{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """The built library's path, compiling it first if no process has."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(_command(tmp), capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise BuildError(f"{' '.join(_command(tmp))} exited {proc.returncode}:\n"
                                     f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load():
    """The extension module (`clone`, `init`), built if need be."""
    path = build()
    name = "lws_tpu_torch.core._fastclone"  # PyInit__fastclone
    loader = importlib.machinery.ExtensionFileLoader(name, str(path))
    spec = importlib.util.spec_from_file_location(name, str(path), loader=loader)
    try:
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
    except ImportError as e:
        raise BuildError(f"{path} does not load: {e}") from e
    return module
