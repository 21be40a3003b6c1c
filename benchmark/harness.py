"""The benchmark's harness: finds the cell, its configuration, its
traffic, its limits and its per-layer metrics by name, refuses to run
without the chips the cell asks for, runs the traffic's kind, and
prints the result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell lives in files found by name:

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration,
  traffic and chips, and the metrics;
- ``benchmark/configs/<config>.json``: the configuration;
- ``benchmark/workloads/<traffic>.json``: the traffic mix, whose
  ``kind`` names the driver ``benchmark/kinds/<kind>.py``;
- ``benchmark/limits/<cell>.json``: the limit of each number compared
  (a run is correct where every number is at most its limit);
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(run) -> float | None``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

#: top-level modules that must not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "salt_tpu")
#: the working directory of a run, inside the checkout
WORK = os.path.join("benchmark", ".work")
#: the input cache (``inputs.cached_dir``), beside the runs' directories
CACHE = os.path.join(WORK, "cache")


class Run:
    """One run: its arguments, the cell's files, and what the kind's
    driver leaves for the metrics and the result line."""

    def __init__(self, args, spec: dict, root: str, t0: float):
        self.args = args
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace_on = bool(args.trace)
        self.root = root
        self.t0 = t0
        self.spec = spec
        self.cell = find(spec["workloads"], args.workload, "workload")
        entry = find(spec["configs"], self.cell["config"], "config")
        self.config = read_json(os.path.join(root, entry["file"]))
        self.traffic = read_json(os.path.join(
            root, "benchmark", "workloads", f"{self.cell['traffic']}.json"))
        self.limits = read_json(os.path.join(
            root, "benchmark", "limits", f"{self.cell['name']}.json"))
        self.workdir = os.path.join(root, WORK, self.cell["name"])
        self.cache_root = os.path.join(root, CACHE)
        self.device = None
        #: end-to-end values by metric name, set by the driver
        self.values: Dict[str, float] = {}
        #: numbers compared: name -> (value, limit)
        self.checks: Dict[str, tuple] = {}
        self.attempted = 0
        self.failed = 0
        #: the traced call (benchmark.trace.Trace) of a --trace 1 run
        self.trace = None
        #: quantities the per-layer readers use, set by the driver
        self.facts: Dict[str, float] = {}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and v <= lim for v, lim in self.checks.values())

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"benchmark: no {what} named {name!r}")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(root: str, metric: str):
    """``benchmark/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    """Whether the per-layer ``metric`` is reported in ``cell``: its
    ``workloads`` list names it."""
    return cell in metric["workloads"]


def e2e_metrics(spec: dict, cell: str) -> List[dict]:
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_power_limit() -> Optional[str]:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def execute(run: Run, device) -> dict:
    """Run the cell's kind on ``device`` and assemble the result line's
    object (without the chip check: the tests call this on the CPU)."""
    import torch
    run.device = torch.device(device)
    shutil.rmtree(run.workdir, ignore_errors=True)
    os.makedirs(run.workdir)
    try:
        kind = importlib.import_module(
            f"benchmark.kinds.{run.traffic['kind']}")
        kind.run(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    cell = run.cell["name"]
    e2e = e2e_metrics(run.spec, cell)
    metrics = {}
    if not run.trace_on:
        for m in e2e:
            metrics[m["name"]] = {"value": run.values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in run.spec["per_layer"]:
            if applies(m, cell):
                v = reader(run.root, m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": run.cell["chips"],
           "memory_peak_bytes": int(run.facts.get("memory_peak_bytes", 0))}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    if run.device.type == "cuda":
        dev["power_limit"] = card_power_limit()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = os.getcwd()
    spec = read_json(os.path.join(root, "BENCHMARK.json"))
    run = Run(args, spec, root, t0)
    import torch
    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(run, "cuda:0")
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: modules of the JAX side loaded: {loaded}",
              file=sys.stderr)
        return 3
    import resource
    print(f"benchmark: run ended at {run.elapsed():.3f} s, host memory "
          f"peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
          " GiB", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
