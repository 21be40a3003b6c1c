"""Readings that set a cell's limits, on the chip at the cell's own
size: for each seed, in one process, the program's numbers (the lower
reading) and the control's (the upper).

- serve: ``mask_error`` of one whole submission; the control is the
  reference in the next lower precision put in the program's place
  (int4 for an int8 configuration), its masks thresholded from its
  probabilities;
- fit: the numbers of ``kinds.fit.gaps`` of the check steps; the
  control is the reference with every conv in fp8 (``quant.training_conv``:
  its operands in e4m3, and the gradient at its output in e5m2), and a
  fault planted in the reference: half of each batch left out of the
  loss, the mean taken over the rest.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--out FILE]

Each seed prints one JSON line (and appends it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import torch

from benchmark import harness
from benchmark.kinds import fit as fit_kind
from benchmark.kinds import serve as serve_kind
from benchmark.reference import quant
from benchmark.reference import train as ref_train

#: the precision one step below the one the configuration states: int4
#: under int8, fp8 under bf16
CONTROL = {8: 4, 0: "fp8"}


def fit_readings(r) -> dict:
    prep = fit_kind.Prepared(r)
    prep.release()
    ref = prep.reference(r)
    out = {"seed": r.seed, "workload": r.cell["name"]}

    def half_batch(logits, y):
        b = logits.shape[0] // 2
        return ref_train.lovasz_hinge(logits[:b], y[:b])

    out["program"] = prep.gaps(ref)
    lower = CONTROL[0]
    out[f"control_reference_{lower}"] = prep.gaps(
        ref, prep.reference(r, quant.training_conv(lower)))
    out["fault_half_batch"] = prep.gaps(
        ref, prep.reference(r, loss_fn=half_batch))
    return out


def serve_readings(r) -> dict:
    prep = serve_kind.Prepared(r)
    prep.warm_up()
    bits = r.traffic["quant_bits"]
    out = {"seed": r.seed, "workload": r.cell["name"]}
    out["program"], _ = serve_kind.check(r, prep, [prep.call("program.csv")])
    sample = serve_kind.check_sample(r)
    ref = serve_kind.reference_probs(r, prep.models, prep.images[sample])
    lower = CONTROL[bits]
    low = serve_kind.reference_probs(r, prep.models, prep.images[sample],
                                     lower)
    out[f"control_reference_{lower}"] = serve_kind.mask_error(
        low > r.config["threshold"], ref, r.config["threshold"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = os.getcwd()
    spec = harness.read_json(os.path.join(root, "BENCHMARK.json"))
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        run_args = argparse.Namespace(workload=args.workload, seed=seed,
                                      seconds=0.0, trace=0)
        r = harness.Run(run_args, spec, root, time.perf_counter())
        r.device = torch.device("cuda:0")
        shutil.rmtree(r.workdir, ignore_errors=True)
        os.makedirs(r.workdir)
        try:
            fn = (serve_readings if r.traffic["kind"] == "serve"
                  else fit_readings)
            line = json.dumps(fn(r), default=float)
        finally:
            shutil.rmtree(r.workdir, ignore_errors=True)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
