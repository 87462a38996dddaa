"""The benchmark's command: one run of one cell on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `compared` (each number the comparison judged, beside its limit;
also the last lines of standard error). Exits non-zero and prints no
result without CUDA or with fewer cards than the cell asks for, and when
`jax`, `jaxlib`, `flax` or the JAX package (`lws_tpu`) is loaded once the
window has closed, compared by whole top-level module names.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()  # before anything heavy is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lws_tpu")


def process_start() -> float:
    """time.perf_counter() at the start of this process, from its start
    time in /proc (clock ticks after boot) and the uptime; the first
    statement of this module where /proc cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 600 else T_IMPORT
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


HOST_CORES = 2  # the process runs on the last this many cores it may use


def set_environment(root) -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    transformers; few host threads, held to HOST_CORES cores, so that the
    loop's thread is not moved between cores in the window (call before
    any thread starts: threads started later inherit the cores)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "port_bench" / ".cache" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", str(HOST_CORES))
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-HOST_CORES:])


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench import spec

    set_environment(spec.ROOT)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_CORES)
    from port_bench import harness

    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
