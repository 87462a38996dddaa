"""What a run loads: no `jax`, `jaxlib`, `flax` or JAX package (`lws_tpu`)
module, compared by whole top-level names (`lws_tpu_torch` begins with
`lws_tpu` and is allowed); and the reference loads nothing of the
program. Each check runs in a fresh process."""

import json
import subprocess
import sys

from port_bench import spec

REHEARSAL = """
import json, sys, time, torch
from port_bench.tests.tiny import tiny_cell
from port_bench import harness
from port_bench.run import forbidden_modules
out = harness.run_cell(tiny_cell(), 5, 0.3, False, torch.device("cpu"), time.perf_counter())
print(json.dumps({"forbidden": forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "correct": out["line"]["correct"]}))
"""

REFERENCE = """
import json, sys
import port_bench.reference.model
import port_bench.judge
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def run(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cpu_rehearsal_of_a_run_loads_no_jax_package():
    got = run(REHEARSAL)
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "lws_tpu"} & set(got["tops"])
    assert "lws_tpu_torch" in got["tops"]  # the program did run
    assert got["correct"] is True


def test_the_reference_and_the_judge_load_nothing_of_the_program():
    tops = run(REFERENCE)
    assert "torch" in tops
    assert not {"lws_tpu_torch", "lws_tpu", "jax", "jaxlib", "flax"} & set(tops)


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from port_bench import run as runmod

    monkeypatch.setitem(sys.modules, "lws_tpu_torch_lookalike", sys)
    monkeypatch.delitem(sys.modules, "lws_tpu", raising=False)
    assert "lws_tpu" not in runmod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lws_tpu.api", sys)
    assert "lws_tpu" in runmod.forbidden_modules()
