"""The readings the correctness limits are set from, on the card: for each
seed, one run of the cell (a short window at the cell's own load) judged
as the benchmark judges it, and the control, the reference at int4
weights in the program's place, read on the same sample. The benchmark's
own runs never run this.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 --seconds 15 \
        [--out calibrate.jsonl]

Prints one JSON line per seed: the program's numbers (max_logit_gap,
mean_logit_gap, bad_completions), the control's (control_max_logit_gap,
control_mean_logit_gap), and the run's end-to-end metrics. All seeds run
in one process: the kernels are built once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from port_bench import spec
    from port_bench.run import card_line, set_environment

    set_environment(spec.ROOT)
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("port_bench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    card = card_line()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator exists before its peak is reset
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats(dev)
        out = harness.run_cell(cell, seed, args.seconds, False, dev, time.perf_counter(),
                               control=True)
        row = {"workload": cell.name, "seed": seed, "card": card, "seconds": args.seconds,
               "numbers": out["numbers"], "correct": out["line"]["correct"],
               "metrics": {k: v["value"] for k, v in out["line"]["metrics"].items()},
               "memory_peak_bytes": out["line"]["device"]["memory_peak_bytes"]}
        for line in out["stderr"]:
            print(line, file=sys.stderr)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
