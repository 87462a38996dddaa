"""Sets of runs of one cell and their spreads, from which the bounds are
set: each run a fresh process of the benchmark's own command, as a check
makes them, on this machine's card.

    python3 -m port_bench.spread --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \
        --seconds 51 --out sets.jsonl
    python3 -m port_bench.spread --summarize sets.jsonl

Each set runs every seed once, in the order given; every set has the same
seeds. The summary gives, for each metric of each set, the median and the
spread (quartile distance over the median, statistics.quantiles), five
times the widest spread of each metric, and the median and largest gap
between the two runs of one seed (over their mean): where those are as
wide as the spread, the runs spread from process to process, not from
seed to seed.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys

from port_bench.stats import spread


def run_sets(workload: str, seeds: list[int], sets: int, seconds: float, out: str) -> None:
    for s in range(sets):
        for seed in seeds:
            cmd = [sys.executable, "-m", "port_bench.run", "--workload", workload, "--seed",
                   str(seed), "--seconds", str(seconds), "--trace", "0"]
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=1500, check=False)
            lines = p.stdout.strip().splitlines()
            row = {"workload": workload, "set": s, "seed": seed, "rc": p.returncode,
                   "result": json.loads(lines[-1]) if p.returncode == 0 and lines else None,
                   "stderr_tail": p.stderr[-1500:]}
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
            res = row["result"] or {}
            print(json.dumps({k: row[k] for k in ("set", "seed", "rc")}
                             | {"correct": res.get("correct"),
                                "metrics": {k: v["value"] for k, v in
                                            res.get("metrics", {}).items()}}), flush=True)


def summarize(path: str) -> dict:
    by = collections.defaultdict(lambda: collections.defaultdict(list))
    per_seed = collections.defaultdict(lambda: collections.defaultdict(list))
    correct = collections.Counter()
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            res = row.get("result")
            if not res:
                continue
            correct[(row["workload"], res["correct"])] += 1
            for name, m in res["metrics"].items():
                by[(row["workload"], name)][row["set"]].append(m["value"])
                per_seed[(row["workload"], name)][row["seed"]].append(m["value"])
    out = {}
    for (workload, name), sets in sorted(by.items()):
        rows = {s: {"n": len(v), "median": statistics.median(v),
                    "spread": spread(v) if len(v) >= 2 else None} for s, v in sorted(sets.items())}
        widest = max((r["spread"] for r in rows.values() if r["spread"] is not None), default=None)
        pairs = [abs(v[0] - v[1]) / statistics.fmean(v[:2])
                 for v in per_seed[(workload, name)].values() if len(v) >= 2]
        out[f"{workload} {name}"] = {"sets": rows, "widest": widest,
                                     "five_times": None if widest is None else 5 * widest,
                                     "same_seed_gap": {"median": statistics.median(pairs),
                                                       "max": max(pairs)} if pairs else None}
    out["correct"] = {f"{w} {c}": n for (w, c), n in correct.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default="sets.jsonl")
    ap.add_argument("--summarize", default=None)
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    run_sets(args.workload, [int(s) for s in args.seeds.split(",")], args.sets, args.seconds,
             args.out)
    print(json.dumps(summarize(args.out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
