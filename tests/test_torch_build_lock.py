"""The kernel build is safe for two process groups that start together on
one host (a prefill role and a decode role, each building on its rank 0):
`lws_tpu_torch/ops/_ext.py:build` takes an exclusive lock on the build
directory, so the second builder finds the library by its hash and compiles
nothing. On the CPU the compiler is a stub `nvcc` (a script that counts its
runs, sleeps, and writes its output), so the race is real and the test
needs no CUDA toolkit."""

import multiprocessing as mp
import os
import stat
from pathlib import Path

STUB_NVCC = """#!/bin/sh
# Count this run, hold the compile open long enough for a racing builder
# to arrive, then write the -o output.
echo "$$" >> "{counter}"
sleep 1
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
printf 'stub library' > "$out"
"""


def builder(root: str, start, results) -> None:
    """One builder process: the module pointed at the stub tree, then one
    build of the stub source once both builders are ready."""
    from lws_tpu_torch.ops import _ext

    _ext.CSRC_DIR = Path(root) / "csrc"
    _ext.BUILD_DIR = Path(root) / "_build"
    start.wait()
    results.put(sorted(_ext.build(["stub"])))


def test_two_concurrent_builds_compile_once(tmp_path):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    counter = tmp_path / "nvcc_runs"
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(counter=counter))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text("// a stub source\n")
    ctx = mp.get_context("spawn")
    start, results = ctx.Barrier(2), ctx.Queue()
    env_before = os.environ.get("CUDA_HOME")
    os.environ["CUDA_HOME"] = str(tmp_path / "cuda")  # the children inherit it
    try:
        procs = [ctx.Process(target=builder, args=(str(tmp_path), start, results))
                 for _ in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
    finally:
        if env_before is None:
            os.environ.pop("CUDA_HOME")
        else:
            os.environ["CUDA_HOME"] = env_before
    assert [p.exitcode for p in procs] == [0, 0]
    got = sorted(results.get(timeout=5) for _ in range(2))
    assert got == [[], ["stub"]]  # one builder compiled, the other found it by hash
    assert len(counter.read_text().split()) == 1  # nvcc ran once
    libs = sorted(p.name for p in (tmp_path / "_build").glob("*.so"))
    assert len(libs) == 1 and libs[0].startswith("stub-"), libs
    assert (tmp_path / "_build" / libs[0]).read_bytes() == b"stub library"
    assert not list((tmp_path / "_build").glob("*.tmp"))
