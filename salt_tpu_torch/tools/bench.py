"""The port's benchmark: the measurements of the JAX package's
``bench.py`` that the port can take, on one CUDA card, as one JSON line.

    python -m salt_tpu_torch.tools.bench [--iters 25] [--windows 3] \
        [--train-iters 15] [--profile-steps 5]

- ``flagship_tta_int8``, bench.py's headline: the flagship UNetResNet34
  (seeded weights, bf16, the infer form with ``model.quant_bits=8``: the
  int8 quantize and conv kernels, ``pallas_conv`` "off", the sum forms),
  hflip-TTA images/s at batch 64 (``train.throughput.
  measure_tta_throughput``; bench.py:213-236);
- ``flagship_tta_bf16``: the same without int8 (bench.py:241-243);
- ``flagship_train``: train images/s at batch 128, augmentation +
  forward + Lovász + backward + Adam (bench.py:55-73);
- ``salt_unet16_tta``: SaltUNet (16 filters, 4 levels), hflip TTA at
  batch 64 (bench.py:243-246);
- ``serve_synthetic_2048``: ``serve(cfg, "", "", synthetic=2048)`` of
  the int8 flagship, as bench.py serves it, at batch 64 with the
  runner's seeded weights and, as in bench.py, the config's default of no
  TTA: images/s over serve's timed loop (upload, forward, threshold, mask
  download; bench.py:90-101);
- ``breakdown``: for the TTA step in bf16 and in int8 (batch 64) and the
  train step (batch 128), host wall and device ms per step, the busy
  share, kernel launches per step, the top kernels, and the hand kernels
  on the step (preprocess; int8 quantize and both int8 conv kernels,
  ``int8_conv_wgmma_kernel`` and ``int8_conv_kernel``; the Lovász
  sort), from ``tools/profiling.step_breakdown``;
- ``device``: the card's name and power limit (nvidia-smi).

- ``multichip_dp_tta``: the weak-scaling probe of bench.py:104-126, the
  hflip-TTA step at the inference batch on every rank of a
  ``torch.distributed`` group (``parallel/mesh.py``), their rates
  summed; None in one process, as the JAX bench at one chip.

- ``distill_<student>``: each student of the newest
  ``distill_curve.json`` under ``--distill-root`` (default ``output/``
  of the checkout; ``python -m salt_tpu_torch.tools.distill_curve``
  writes it) with a measured rate: its TTA images/s, IOUT delta against
  its teacher, and ``vs_flagship_tta_int8``, its rate over this run's
  ``flagship_tta_int8`` (bench.py:162-186);
- ``serve_student``: ``serve --synthetic 2048`` of the newest
  ``distill_*/distill_report.json``'s student with the int8 serving
  config, the student's model adopted from its ``config.json``
  (bench.py:129-159);
- ``distilled_student*``: the fastest student at or above the bar with
  an IOUT cost of at most 0.02 (bench.py:189-210). bench.py's bar is
  ``BASELINE_IMAGES_PER_SEC = 5000``, a target set for a TPU v5e-8
  (BASELINE.md); the port carries no such constant, and its bar is this
  run's ``flagship_tta_int8`` rate on the card, so its ratios are
  ``vs_flagship_tta_int8`` where bench.py's are ``vs_5000_target`` and
  ``vs_baseline``. With no curve on disk the line has none of these
  keys. Its numbers are not rounded (bench.py rounds to 1 and 3 or 4
  places).

Every measurement runs: one that fails fails the run. ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu --tiny``
(a small UNetResNet18 and SaltUNet, fp32, 8 images) runs the same code on
the CPU for the tests: its rates are the CPU's, not the card's, and its
breakdown is not measured.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import glob
import json
import os
import tempfile

import torch

from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.ops.sort_kernel import KERNEL_PREFIX
from salt_tpu_torch.pipeline.serving import adopt_checkpoint_config, serve
from salt_tpu_torch.tools.profiling import card, step_breakdown
from salt_tpu_torch.train.steps import SegmentationRunner
from salt_tpu_torch.train.throughput import (measure_tta_throughput,
                                             measure_train_throughput)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the hand kernels each profiled step launches
STEP_KERNELS = {"tta_step": ("preprocess_inference_kernel",),
                "tta_step_int8": ("preprocess_inference_kernel",
                                  "absmax_kernel", "quant_kernel",
                                  "int8_conv_wgmma_kernel",
                                  "int8_conv_kernel"),
                "train_step": (KERNEL_PREFIX,)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a small network and batch: the CPU test's size")
    ap.add_argument("--iters", type=int, default=25,
                    help="TTA steps per timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--train-iters", type=int, default=15,
                    help="train steps per timed window")
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--distill-root", default=os.path.join(REPO, "output"),
                    help="where to look for the newest distill curve and "
                         "student")
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.tiny:
        ap.error("--device cpu runs only with --tiny (a check of the path, "
                 "not a measurement)")
    return args


def bench_config(tiny: bool, quant_bits: int = 0):
    """bench.py's configuration: the flagship, bf16, inference batch 64,
    train batch 128, ``model.quant_bits``; ``tiny``: UNetResNet18, fp32,
    batch 2."""
    cfg = default_config()
    cfg.model.architecture = "UNetResNet"
    cfg.training.dtype = "bfloat16"
    cfg.training.batch_size_inference = 64
    cfg.training.batch_size_train = 128
    cfg.model.quant_bits = quant_bits
    if tiny:
        cfg.model.encoder_depth = 18
        cfg.training.dtype = "float32"
        cfg.training.batch_size_inference = 2
        cfg.training.batch_size_train = 2
    return cfg


def salt_unet_config(cfg, tiny: bool):
    model = dataclasses.replace(cfg.model, architecture="SaltUNet")
    if tiny:
        model = dataclasses.replace(model, n_filters=4, repeat_blocks=2)
    return dataclasses.replace(cfg, model=model)


def measure_multichip_dp_tta(cfg, device, single_chip_ips: float,
                             iters: int, windows: int):
    """Weak scaling over the process group: each rank's hflip-TTA rate at
    the inference batch (seeded weights), summed over the ranks; with
    each rank's share and the efficiency against ``single_chip_ips``.
    None in one process (a world of one)."""
    import torch.distributed as dist
    from salt_tpu_torch.parallel.mesh import make_mesh
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    mesh = make_mesh(0, device)
    runner = SegmentationRunner(cfg, mesh.device)
    local = measure_tta_throughput(runner, runner.init_model(0),
                                   cfg.training.batch_size_inference, iters,
                                   windows)
    total = torch.tensor([local], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(total, group=mesh.group)
    agg = float(total)
    return {"value": agg, "unit": "images/sec_aggregate",
            "chips": mesh.size, "per_chip": agg / mesh.size,
            "efficiency_pct": agg / (mesh.size * single_chip_ips) * 100,
            "batch": cfg.training.batch_size_inference}


def emit_distill_context(root: str, bar: float) -> dict:
    """``distill_<student>`` records of the newest ``distill_curve.json``
    under ``root``: each student with a measured TTA rate (a ``--smoke``
    curve has none), its IOUT against its teacher's, and its rate over
    ``bar``. Reads files only; {} without a curve."""
    curves = glob.glob(os.path.join(root, "**", "distill_curve.json"),
                       recursive=True)
    if not curves:
        return {}
    path = max(curves, key=os.path.getmtime)
    with open(path) as f:
        curve = json.load(f)
    records = {}
    for name, rep in curve.get("students", {}).items():
        ips = rep.get("student_tta_images_per_sec")
        if ips is None:
            continue
        records[f"distill_{name}"] = {
            "value": float(ips), "unit": "images/sec/chip",
            "iout_delta": float(rep["iout_delta"]),
            "teacher_iout": float(rep["teacher_iout"]),
            "student_iout": float(rep["student_iout"]),
            "vs_flagship_tta_int8": float(ips) / bar, "curve": path}
    return records


def qualified_student_fields(ctx: dict, bar: float,
                             max_iout_cost: float = 0.02) -> dict:
    """The fastest ``distill_*`` record of ``ctx`` whose rate reaches
    ``bar`` at an IOUT cost of at most ``max_iout_cost`` against its
    teacher, as ``distilled_student*`` keys; {} when none does."""
    qualified = [(n, c) for n, c in ctx.items()
                 if n.startswith("distill_") and c["value"] >= bar
                 and c.get("iout_delta", -1.0) >= -max_iout_cost]
    if not qualified:
        return {}
    name, c = max(qualified, key=lambda kv: kv[1]["value"])
    return {"distilled_student": name[len("distill_"):],
            "distilled_student_images_per_sec": c["value"],
            "distilled_student_iout_delta": c["iout_delta"],
            "distilled_student_vs_flagship_tta_int8": c["value"] / bar}


def measure_serve_student(cfg, root: str, device, n_images: int = 2048):
    """``serve --synthetic n_images`` of the newest distilled student
    (``distill_*/distill_report.json`` under ``root``, by modification
    time) with ``cfg``: serve adopts the student's model from its
    ``config.json`` (every model field but ``quant_bits``, which stays
    ``cfg``'s). Its record, or None without a student."""
    reports = glob.glob(os.path.join(root, "**", "distill_*",
                                     "distill_report.json"), recursive=True)
    if not reports:
        return None
    path = max(reports, key=os.path.getmtime)
    exp_dir = os.path.dirname(path)
    with open(path) as f:
        rep = json.load(f)
    cfg_s = adopt_checkpoint_config(copy.deepcopy(cfg), exp_dir)
    with tempfile.TemporaryDirectory() as tmp:
        served = serve(cfg_s, exp_dir, "", os.path.join(tmp, "sub.csv"),
                       synthetic=n_images, device=device)
    return {"value": served["images_per_sec"], "unit": "images/sec",
            "student": os.path.basename(exp_dir),
            "architecture": cfg_s.model.architecture,
            "quant_bits": cfg_s.model.quant_bits,
            "iout_delta": float(rep.get("iout_delta", 0.0)),
            "images": n_images, "seconds": served["seconds"],
            "note": "upload + forward + mask download, the student's "
                    "config adopted"}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = bench_config(args.tiny)
    bs_inf = cfg.training.batch_size_inference
    bs_train = cfg.training.batch_size_train
    # a CPU run's rates are the CPU's: they never carry the card's unit
    rate = "images/sec/chip" if on_card else "images/sec on the CPU"
    line = {"device": ({"platform": "gpu", **card(),
                        "kind": torch.cuda.get_device_name(device),
                        "count": torch.cuda.device_count()}
                       if on_card else {"platform": "cpu", "tiny": True})}

    def breakdown(name, step, batch):
        out = (step_breakdown(step, args.profile_steps,
                              kernels=STEP_KERNELS[name])
               if on_card else {"not_measured": "no CUDA device"})
        return {"batch": batch, **out}

    def uint8(shape, seed, threshold=None):
        x = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
        x = x * 255 if threshold is None else x > threshold
        return x.to(torch.uint8).numpy()

    runner = SegmentationRunner(cfg, device)
    model = runner.init_model(0)
    line["flagship_tta_bf16"] = {
        "value": measure_tta_throughput(runner, model, bs_inf, args.iters,
                                        args.windows),
        "unit": rate, "batch": bs_inf, "dtype": cfg.training.dtype}
    images, = runner.device_batch(uint8((bs_inf, 101, 101), 1))
    line["breakdown"] = {"tta_step": breakdown(
        "tta_step", lambda i: runner.predict_tta_step(model, images),
        bs_inf)}
    del model

    cfg_q = bench_config(args.tiny, quant_bits=8)
    runner_q = SegmentationRunner(cfg_q, device)
    model_q = runner_q.init_model(0)
    line["flagship_tta_int8"] = {
        "value": measure_tta_throughput(runner_q, model_q, bs_inf,
                                        args.iters, args.windows),
        "unit": rate, "batch": bs_inf, "dtype": cfg_q.training.dtype,
        "quant_bits": cfg_q.model.quant_bits,
        "pallas_conv": cfg_q.model.pallas_conv}
    line["breakdown"]["tta_step_int8"] = breakdown(
        "tta_step_int8", lambda i: runner_q.predict_tta_step(model_q, images),
        bs_inf)
    del model_q, images

    state = runner.init_state(0)
    line["flagship_train"] = {
        "value": measure_train_throughput(runner, state, bs_train,
                                          args.train_iters, args.windows),
        "unit": rate, "batch": bs_train, "dtype": cfg.training.dtype,
        "note": "augment + forward + Lovász + backward + Adam"}
    imgs, masks = runner.device_batch(uint8((bs_train, 101, 101), 2),
                                      uint8((bs_train, 101, 101), 3, 0.5))
    generator = torch.Generator(device=device)

    def train_step(i):
        generator.manual_seed(i)
        return float(runner.train_step(state, imgs, masks, generator))

    line["breakdown"]["train_step"] = breakdown("train_step", train_step,
                                                bs_train)
    del state, imgs, masks

    cfg_v = salt_unet_config(cfg, args.tiny)
    runner_v = SegmentationRunner(cfg_v, device)
    line["salt_unet16_tta"] = {
        "value": measure_tta_throughput(runner_v, runner_v.init_model(0),
                                        bs_inf, args.iters, args.windows),
        "unit": rate, "batch": bs_inf, "n_filters": cfg_v.model.n_filters,
        "repeat_blocks": cfg_v.model.repeat_blocks}

    n_serve = 8 if args.tiny else 2048
    with tempfile.TemporaryDirectory() as tmp:
        served = serve(cfg_q, "", "", os.path.join(tmp, "sub.csv"),
                       synthetic=n_serve, device=device)
    line["serve_synthetic_2048"] = {
        "value": served["images_per_sec"],
        "unit": "images/sec" if on_card else rate,
        "images": n_serve, "batch": bs_inf, "seconds": served["seconds"],
        "batches": served["batches"],
        "warmup_batches": served["warmup_batches"],
        "tta": cfg_q.postpro.use_tta, "quant_bits": cfg_q.model.quant_bits,
        "note": "in-memory synthetic images, seeded weights; upload + "
                "forward + mask download in the timed loop"}
    line["multichip_dp_tta"] = measure_multichip_dp_tta(
        cfg, device, line["flagship_tta_bf16"]["value"], args.iters,
        args.windows)
    bar = line["flagship_tta_int8"]["value"]
    line.update(emit_distill_context(args.distill_root, bar))
    student = measure_serve_student(cfg_q, args.distill_root, device,
                                    n_serve)
    if student is not None:
        line["serve_student"] = student
    line.update(qualified_student_fields(line, bar))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
