"""The distillation curve (counterpart of ``tools/distill_curve.py``):
a family of fast students trained against one CV fold-ensemble teacher's
persisted out-of-fold soft targets on the ``real`` synthetic difficulty,
each measured for

- its held-out IOUT against the teacher's (the same split, the same
  postprocessing), and
- its sustained hflip-TTA images/s on the device (``distill
  --measure-throughput``, the bench's probe).

    python -m salt_tpu_torch.tools.distill_curve --teacher DIR \\
        [--n-images 3000] [--epochs 80] [--seed 0] \\
        [--students saltunet16 ...] [--reprobe-throughput] \\
        [--smoke] [--device cuda|cpu]

The teacher is a CV experiment directory with
``outputs/out_of_fold_train_predictions.npz`` over the bundle's ids, e.g.
``python -m salt_tpu_torch.cli train-evaluate-predict-cv --synthetic N
--synthetic-difficulty real --set execution.seed=S`` with the curve's
``--n-images N --seed S``. Each student trains through the port's ``cli
distill`` with the JAX tool's flags into ``<teacher>/../distill_<name>/
distill_report.json`` (a student whose report exists is not trained
again); ``<teacher>/../distill_curve.json`` gathers the reports.

``--device`` defaults to ``cuda`` and raises without a card. ``--smoke``
only shrinks the run (32 images, 1 epoch, the narrow widths of
``SMOKE_SETS``, no throughput probe): a check of the wiring, with no
quality meaning; ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from salt_tpu_torch.core.device import resolve_device

#: students, fastest first; each a set of ``--set`` overrides
STUDENTS: Dict[str, Dict[str, object]] = {
    # the bench's SaltUNet context model: the smallest student
    "saltunet16": {"model.architecture": "SaltUNet"},
    # between 16 and 32 filters
    "saltunet24": {"model.architecture": "SaltUNet",
                   "model.n_filters": 24},
    # a wider scratch U-Net: quality headroom at some throughput cost
    "saltunet32": {"model.architecture": "SaltUNet",
                   "model.n_filters": 32},
    # the 32-wide student served int8: training unchanged, its evaluation
    # and throughput probe run the int8 kernels, so the IOUT delta prices
    # int8 too
    "saltunet32_int8": {"model.architecture": "SaltUNet",
                        "model.n_filters": 32,
                        "model.quant_bits": 8},
    # an encoder student: the flagship's family, its shallowest trunk
    "unetresnet18": {"model.architecture": "UNetResNet",
                     "model.encoder_depth": 18},
}

#: ``--smoke``: the widths and budgets of a wiring check
SMOKE_SETS: Dict[str, object] = {
    "model.n_filters": 8, "model.repeat_blocks": 2,
    "model.encoder_depth": 18, "training.dtype": "float32",
    "execution.n_cv_splits": 2,
    "training.batch_size_train": 8,
    "training.batch_size_inference": 8,
}
SMOKE_IMAGES, SMOKE_EPOCHS = 32, 1


def student_dir(teacher: str, name: str) -> str:
    return os.path.join(os.path.dirname(teacher.rstrip("/")),
                        f"distill_{name}")


def student_flags(name: str, args) -> List[str]:
    """The ``cli distill`` arguments of student ``name``: the JAX tool's
    flags (``tools/distill_curve.py:62-80``), then ``--device``."""
    exp_dir = student_dir(args.teacher, name)
    flags = ["distill", "--teacher", args.teacher,
             "--synthetic", str(args.n_images),
             "--synthetic-difficulty", "real",
             "--epochs", str(args.epochs),
             "--set", f"execution.seed={args.seed}",
             "--set", f"paths.experiment_dir={exp_dir}",
             "--set", "training.batch_size_train=128",
             "--set", "training.batch_size_inference=64",
             "--set", "postpro.use_tta=true"]
    if not args.smoke:
        flags.insert(1, "--measure-throughput")
    for k, v in STUDENTS[name].items():
        flags += ["--set", f"{k}={v}"]
    if args.smoke:                            # the last --set wins
        for k, v in SMOKE_SETS.items():
            flags += ["--set", f"{k}={v}"]
    return flags + ["--device", args.device]


def run_student(name: str, args) -> dict:
    """Train student ``name`` unless its report exists; its report."""
    from salt_tpu_torch import cli
    exp_dir = student_dir(args.teacher, name)
    report_path = os.path.join(exp_dir, "distill_report.json")
    if not os.path.exists(report_path):
        rc = cli.main(student_flags(name, args))
        if rc != 0:
            raise RuntimeError(f"distill {name} failed: rc {rc}")
    with open(report_path) as f:
        report = json.load(f)
    if args.reprobe_throughput:
        report = reprobe_throughput(exp_dir, report_path, report, args.device)
    return report


def reprobe_throughput(exp_dir: str, report_path: str, report: dict,
                       device: str) -> dict:
    """Measure a trained student's TTA images/s again with the current
    probe and rewrite its report. The student's configuration comes from
    its ``config.json``, ``model.quant_bits`` too, which serving's
    adoption leaves to the caller: the int8 student is probed in int8,
    as its report's rate was measured (the JAX tool reprobes it in
    bf16)."""
    from salt_tpu_torch.core.config import load_config
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.pipeline.api import NETWORK
    from salt_tpu_torch.pipeline.distill import _measure_student_throughput
    from salt_tpu_torch.pipeline.serving import adopt_checkpoint_config
    from salt_tpu_torch.train.distill import DistillRunner
    with open(os.path.join(exp_dir, "config.json")) as f:
        quant_bits = json.load(f)["model"].get("quant_bits", 0)
    user_set = ("training.batch_size_inference", "model.quant_bits")
    cfg = load_config(None, {"training.batch_size_inference": 64,
                             "model.quant_bits": quant_bits})
    cfg = adopt_checkpoint_config(cfg, exp_dir, user_set=user_set)
    runner = DistillRunner(cfg, device)
    model = runner.restore(Experiment(exp_dir).load_params(NETWORK))
    report["student_tta_images_per_sec"] = _measure_student_throughput(
        runner, model)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, default=float)
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--teacher", required=True,
                    help="CV experiment dir with persisted oof predictions")
    ap.add_argument("--seed", type=int, default=0,
                    help="must match the teacher's synthetic bundle seed")
    ap.add_argument("--n-images", type=int, default=3000)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--students", nargs="+", default=list(STUDENTS),
                    choices=list(STUDENTS))
    ap.add_argument("--smoke", action="store_true",
                    help="a small check of the curve's wiring")
    ap.add_argument("--reprobe-throughput", action="store_true",
                    help="measure the throughput of students already "
                         "trained again, rewriting their reports and the "
                         "curve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n_images, args.epochs = SMOKE_IMAGES, SMOKE_EPOCHS
    return args


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)
    curve: dict = {"teacher": args.teacher, "students": {}}
    for name in args.students:
        rep = run_student(name, args)
        curve["students"][name] = rep
        curve.setdefault("teacher_iout", rep["teacher_iout"])
        print(f"{name:16s} {rep.get('student_tta_images_per_sec', 0):10.1f}"
              f" images/s  IOUT {rep['student_iout']:.4f}"
              f" (teacher {rep['teacher_iout']:.4f},"
              f" delta {rep['iout_delta']:+.4f})", flush=True)
    out = os.path.join(os.path.dirname(args.teacher.rstrip("/")),
                       "distill_curve.json")
    with open(out, "w") as f:
        json.dump(curve, f, indent=2, default=float)
    print(f"curve -> {out}")
    return curve


if __name__ == "__main__":
    main()
