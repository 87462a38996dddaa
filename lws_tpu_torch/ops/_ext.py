"""Build and bind the port's CUDA kernels.

Each source `lws_tpu_torch/csrc/<name>.cu` exports plain C functions. At
first use it is compiled by nvcc for sm_90a into its own shared library,
`lws_tpu_torch/_build/<name>-<digest>.so` (the digest covers the source, the
shared `csrc/*.cuh` headers and the flags, so an edit rebuilds), and loaded
with ctypes. No PyTorch
header is compiled: a source with a plain C interface builds in seconds,
where one that includes torch/extension.h takes minutes. Importing this
module needs no nvcc; `build()` and `load()` do, and raise without it.
Every source compiled is recorded in the compile ledger (obs/device.py).

Every C entry point launches on the stream it is given, returns the
`cudaError_t` of the launch, and allocates nothing; the Python wrapper
allocates outputs, checks shapes and types, and raises on a nonzero return.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(v)
    ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "lws_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on PATH); "
        "the CUDA kernels are built from csrc/ at first use"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared headers any source may include
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Returns {name: ptxas report} for the
    sources compiled by this call (registers, shared memory, spills).

    Each source compiled records one entry in the compile ledger
    (obs/device.py: `LEDGER.observe(seconds, executable=name)`), on the
    calling thread, so an ambient `compile_site` attributes it; `seconds` is
    the wall time from the common start to that nvcc's exit. A library
    already built (found by its hash) records nothing.

    Processes that build together (two tensor-parallel groups starting on
    one host, say) take turns on an exclusive lock on `_build/.lock`: the
    first compiles, the others then find every library by its hash and
    compile nothing, so each library is compiled once."""
    names = list(names)
    if all(_library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_unlocked([n for n in names if not _library_path(n).exists()])
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_unlocked(todo: list) -> dict[str, str]:
    from lws_tpu_torch.obs import device as devicemod

    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, done = {}, {}
    for n in todo:
        out = _library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(n))]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)

    def reap(n: str, proc) -> None:  # one reaper per nvcc: each exit is timed as it happens
        log, _ = proc.communicate()
        done[n] = (log, time.perf_counter() - t0)

    reapers = [threading.Thread(target=reap, args=(n, p)) for n, (p, _, _) in procs.items()]
    for t in reapers:
        t.start()
    for t in reapers:
        t.join()
    reports, failures = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, seconds = done[n]
        if proc.returncode != 0:
            failures.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written library
        reports[n] = log
        devicemod.LEDGER.observe(seconds, executable=n)
    if failures:
        raise RuntimeError("lws_tpu_torch: kernel build failed\n" + "\n".join(failures))
    return reports


def build_on_rank_zero() -> dict[str, str]:
    """Build for a group of ranks sharing this checkout: rank 0 of the
    started torch.distributed group compiles every source in csrc/ while the
    others wait at a barrier, then find the libraries by their hash. So one
    nvcc runs per source, and only rank 0's compile ledger records the
    compiles. Returns rank 0's build reports ({} on the other ranks)."""
    import torch.distributed as dist

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    reports = build(names) if dist.get_rank() == 0 else {}
    dist.barrier()
    return reports


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for `name`, built on first use, with `argtypes`
    set from `signatures` ({C function: [ctypes types]}); every function
    returns an int (a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.lws_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lws_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.lws_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"lws_tpu_torch: {what} launch failed: CUDA error {rc} ({msg})")
