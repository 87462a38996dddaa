"""The port's native clone (lws_tpu_torch/csrc/fastclone.c, built by
lws_tpu_torch/core/fastclone.py) against the pure-Python clones of both
packages, on the CPU: tests/test_fastclone.py's cases, with the library
built here by the host C compiler.

The port's store picks its clone as JAX's does (lws_tpu/core/store.py:88-96):
the native one unless LWS_TPU_PURE_PY is set or the build fails, and
`clone_info()` (and `serve`'s start line) names the one in use and why."""

from __future__ import annotations

import copy
import enum
import multiprocessing as mp
import os
import signal
import stat
import subprocess
import sys
import time
from pathlib import Path

import pytest

from lws_tpu.api.meta import to_plain as jto_plain
from lws_tpu.core import store as jstore
from lws_tpu_torch.api.meta import to_plain
from lws_tpu_torch.core import fastclone
from lws_tpu_torch.core import store as pstore

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def native():
    mod = fastclone.load()
    mod.init(enum.Enum, copy.deepcopy)
    return mod


def _samples(testing, sched, lease):
    lws = testing.LWSBuilder().replicas(2).size(4).tpu_chips(4).exclusive_topology().build()
    lws.meta.annotations["a/b"] = "c"
    return [lws, sched.make_slice_nodes("s", topology="2x4")[0], lease.Lease()]


def samples():
    from lws_tpu_torch import sched, testing
    from lws_tpu_torch.api import lease

    return _samples(testing, sched, lease)


def jax_samples():
    from lws_tpu import sched, testing
    from lws_tpu.api import lease

    return _samples(testing, sched, lease)


def test_the_store_uses_the_native_clone_unless_told_not_to(native):
    info = pstore.clone_info()
    if os.environ.get("LWS_TPU_PURE_PY"):
        assert info == {"clone": "python", "reason": "LWS_TPU_PURE_PY is set"}
        assert pstore._clone is pstore._py_clone
    else:
        assert info == {"clone": "native", "library": str(fastclone.library_path())}
        assert pstore._clone is native.clone


def test_native_matches_both_python_clones(native):
    for obj, jobj in zip(samples(), jax_samples()):
        a, b = native.clone(obj), pstore._py_clone(obj)
        assert to_plain(a) == to_plain(b) == to_plain(obj)
        assert a is not obj and a.meta is not obj.meta
        j = jstore._py_clone(jobj)
        assert _wall_free(jto_plain(j)) == _wall_free(to_plain(a))


def _wall_free(plain: dict) -> dict:
    meta = dict(plain.get("meta") or {})
    for k in ("uid", "creation_timestamp"):
        meta.pop(k, None)
    return {**plain, "meta": meta} if "meta" in plain else plain


def test_native_clone_isolates_mutations(native):
    obj = samples()[0]
    c = native.clone(obj)
    c.spec.replicas = 99
    c.meta.labels["x"] = "y"
    c.spec.leader_worker_template.worker_template.spec.containers[0].resources["r"] = 1
    assert obj.spec.replicas == 2
    assert "x" not in obj.meta.labels
    assert "r" not in obj.spec.leader_worker_template.worker_template.spec.containers[0].resources


def test_exotic_types_fall_back(native):
    c = native.clone({"s": {1, 2}, "t": (1, [2])})
    assert c == {"s": {1, 2}, "t": (1, [2])} == pstore._py_clone({"s": {1, 2}, "t": (1, [2])})
    c["s"].add(3)
    c["t"][1].append(9)


def test_cyclic_object_does_not_crash(native):
    cyc: dict = {}
    cyc["self"] = cyc
    out = native.clone(cyc)
    cur = out
    for _ in range(500):
        cur = cur["self"]
    assert out is not cyc


def _python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, **env})


def test_clone_before_init_raises(native):
    code = (
        "import importlib.machinery, importlib.util, enum\n"
        f"path = {str(fastclone.library_path())!r}\n"
        "loader = importlib.machinery.ExtensionFileLoader('_fastclone', path)\n"
        "spec = importlib.util.spec_from_file_location('_fastclone', path, loader=loader)\n"
        "fc = importlib.util.module_from_spec(spec)\n"
        "loader.exec_module(fc)\n"
        "class E(enum.Enum):\n    X = 1\n"
        "try:\n    fc.clone(E.X)\nexcept RuntimeError as e:\n    print('raised', e)\n"
    )
    out = _python(code)
    assert "raised call _fastclone.init() first" in out.stdout, (out.stdout, out.stderr)


STORE_CLONE = (
    "from lws_tpu_torch.core import fastclone, store\n"
    "import json, sys\n"
    "fastclone.BUILD_DIR = fastclone.Path(sys.argv[1])\n"
    "s = store.Store()\n"
    "from lws_tpu_torch.testing import LWSBuilder\n"
    "s.create(LWSBuilder().build())\n"
    "print(json.dumps([store.clone_info(), store._clone is store._py_clone,\n"
    "                  s.get('LeaderWorkerSet', 'default', 'sample').spec.replicas]))\n"
)

FAILING_CC = "#!/bin/sh\necho 'fastclone.c:1: error: boom' >&2\nexit 1\n"


@pytest.mark.parametrize("case", ["pure-py", "no-compiler", "compile-error"])
def test_the_python_clone_is_chosen_and_named(case, tmp_path):
    """LWS_TPU_PURE_PY selects the Python clone; a build that fails leaves
    the store on it with the reason named. The store works either way."""
    import json

    env = {}
    if case == "pure-py":
        env["LWS_TPU_PURE_PY"] = "1"
    elif case == "no-compiler":
        env["CC"] = "no-such-cc"
    else:
        cc = tmp_path / "cc"
        cc.write_text(FAILING_CC)
        cc.chmod(cc.stat().st_mode | stat.S_IXUSR)
        env["CC"] = str(cc)
    proc = subprocess.run([sys.executable, "-c", STORE_CLONE, str(tmp_path / "_build")],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, **env})
    assert proc.returncode == 0, proc.stderr
    info, is_py, replicas = json.loads(proc.stdout)
    assert is_py and replicas == 2 and info["clone"] == "python"
    if case == "pure-py":
        assert info == {"clone": "python", "reason": "LWS_TPU_PURE_PY is set"}
    elif case == "no-compiler":
        assert info["error"] == "no C compiler: 'no-such-cc' is not on PATH (set CC)"
    else:
        assert "exited 1" in info["error"] and "error: boom" in info["error"]
        assert not list((tmp_path / "_build").glob("*.tmp"))


COUNTING_CC = """#!/bin/sh
echo "$$" >> "{counter}"
sleep 1
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
printf 'stub library' > "$out"
"""


def _builder(build_dir: str, start, results) -> None:
    from lws_tpu_torch.core import fastclone as fc

    fc.BUILD_DIR = Path(build_dir)
    start.wait()
    results.put(str(fc.build()))


def test_two_processes_that_start_together_compile_once(tmp_path):
    counter = tmp_path / "cc_runs"
    cc = tmp_path / "cc"
    cc.write_text(COUNTING_CC.format(counter=counter))
    cc.chmod(cc.stat().st_mode | stat.S_IXUSR)
    ctx = mp.get_context("spawn")
    start, results = ctx.Barrier(2), ctx.Queue()
    before = os.environ.get("CC")
    os.environ["CC"] = str(cc)  # the children inherit it
    try:
        procs = [ctx.Process(target=_builder, args=(str(tmp_path / "_build"), start, results))
                 for _ in range(2)]
        for p in procs:
            p.start()
        paths = [results.get(timeout=60) for _ in procs]
        for p in procs:
            p.join(60)
    finally:
        if before is None:
            os.environ.pop("CC", None)
        else:
            os.environ["CC"] = before
    assert not any(p.is_alive() for p in procs) and all(p.exitcode == 0 for p in procs)
    assert len(set(paths)) == 1 and Path(paths[0]).read_text() == "stub library"
    assert len(counter.read_text().split()) == 1


@pytest.mark.parametrize("case", ["native", "failed"])
def test_serve_names_its_clone_once_at_start(case, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("LWS_TPU_PURE_PY", None)
    if case == "failed":
        env["CC"] = "no-such-cc"
    proc = subprocess.Popen([sys.executable, "-m", "lws_tpu_torch", "serve", "--port", "0"],
                            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            lines.append(line)
            if " serving on " in line:
                break
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    lines += out.splitlines(keepends=True)
    named = [ln.strip() for ln in lines if ln.startswith("store clone: ")]
    if case == "native":
        assert named == [f"store clone: native ({fastclone.library_path()})"], lines
    else:
        assert named == ["store clone: python (the native build failed: no C compiler: "
                         "'no-such-cc' is not on PATH (set CC))"], lines
