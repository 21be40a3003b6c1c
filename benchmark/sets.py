"""Sets of runs of one cell, each run a process of its own as a check
makes them, and the spread of each metric: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median, per set.

    python -m benchmark.sets --workload <cell> --seeds 1,2,3,4,5,6 \
        --sets 2 --seconds 51 [--trace 0] [--out FILE]

Each run appends one JSON line to ``--out`` (its set, seed, exit code,
wall seconds and result line); the summary is the last line printed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def summary(rows):
    out = {}
    for s in sorted({r["set"] for r in rows}):
        ok = [r["result"] for r in rows if r["set"] == s and r["result"]]
        names = sorted({k for res in ok for k in res["metrics"]})
        out[s] = {}
        for name in names:
            vals = [res["metrics"][name]["value"] for res in ok
                    if name in res["metrics"]]
            entry = {"median": statistics.median(vals), "n": len(vals),
                     "values": vals}
            if len(vals) >= 2:
                entry["spread"] = spread(vals)
            out[s][name] = entry
        out[s]["correct"] = [res["correct"] for res in ok]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = []
    for s in range(args.sets):
        for seed in args.seeds.split(","):
            cmd = [sys.executable, "-m", "benchmark.run", "--workload",
                   args.workload, "--seed", seed, "--seconds",
                   str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True)
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if p.returncode == 0 else None
            except (IndexError, json.JSONDecodeError):
                result = None
            row = {"set": s, "seed": int(seed), "rc": p.returncode,
                   "wall_s": time.perf_counter() - t0, "result": result,
                   "stderr_tail": p.stderr[-1500:]}
            rows.append(row)
            print(json.dumps({k: row[k] for k in ("set", "seed", "rc",
                                                   "wall_s")}
                             | {"metrics": result and result["metrics"],
                                "checks": result and result["checks"]}),
                  flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    print(json.dumps(summary(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
