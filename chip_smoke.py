#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the flagship
UNetResNet34 at full width, end to end, on its paths — hflip-TTA
``serve`` (from checkpoints and ``--synthetic``), ``train`` and the
K-fold CV loop (``train-evaluate-predict-cv`` / ``evaluate-predict-cv``)
— the scratch SaltUNet's train, resume and serve, the other losses, the
U-Net on the other encoders and the depth net, LargeKernelMatters and
PSPNet, int8 serving and its quality gate, the second-level pipelines
(``full-solution``: emptiness CV, stacking, gating, and the commands
around them), whole reference checkpoints converted and served, the
distillation curve, and the port's bench.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. device     — the card's name, and its name and power limit from
                nvidia-smi;
2. build      — every CUDA kernel, from the sources in the checkout, one
                nvcc per source, all at once;
3. kernel     — each kernel (preprocess, bitonic sort, 3x3 conv) against
                its plain PyTorch version on the card at the shapes its
                path gives it, and its time beside the plain version's, a
                library call's where there is one, and its bound;
   probe path — the probe harnesses as a user runs them, at their full
                size (``python -m salt_tpu_torch.tools.conv_probe`` and
                ``conv_probe2``: B 64, H = W = 128), which launch the
                im2col conv and the pair-packed conv and its variants
                (rows 4, 5 and 7: the VALID-conv kernel, row 7 also in
                int8) and the matmul (row 6: the wgmma matmul kernel);
   probe kernels — those four rows (rows 4-7 of PERF.md's table)
                against their plain versions at the same size (bf16 one
                ulp plus a cancellation floor, int8 bit for bit), timed
                beside the plain version, a library call and the bound;
4. model      — the flagship from seeded weights: fp32 forward on the card
                (TF32 off) against the CPU in both forms (train; infer,
                the sliced-concat sums), bf16 against fp32, and the bf16
                infer form through the conv kernel against the plain
                convs;
5. profile    — where one bf16 serve step's device time goes, with
                ``model.pallas_conv`` "off" and "on";
   ab         — ``python -m salt_tpu_torch.tools.ab_conv`` at batch 64:
                the TTA step with the conv kernel off, on, on+res64 and
                on+res128 from one seeded model;
6. serve      — a 2-fold CV experiment directory of seeded weights and
                2048 seeded PNGs through ``pipeline.serving.serve`` (hflip
                TTA, batch 24, bf16), with "off" and then "on";
7. train step — one fp32 train step of the flagship on the card against
                the CPU, from the same weights and augmentation draws;
8. train      — ``pipeline.api.train`` on 480 synthetic images (fold 0:
                400 train / 80 valid, 16 steps per epoch), 2 epochs, bf16,
                batch 24; its ``best.npz`` then served;
9. train profile — where one bf16 train step's device time goes;
10. cv        — ``cli train-evaluate-predict-cv`` with "on" (6 folds of
                400 / 80 synthetic images, 1 epoch each, hflip TTA, a
                120-image test set), then ``cli evaluate-predict-cv`` with
                "off" on the same experiment directory: the same fold
                scores and submission under the threshold-margin rule;
                then the int8 gate: ``evaluate-predict-cv --set
                model.quant_bits=8`` (an ``int8_gate_*.json`` a fold) and
                ``serve --int8 --checkpoint`` of that experiment (its
                provenance "measured");
11. metadata  — a TGS-layout tree of 48 train and 16 test PNGs and
                depths.csv through ``cli prepare-metadata``, then ``cli
                train --epochs 1`` from the metadata.csv it wrote;
12. serve_synthetic — ``serve --synthetic 2048`` with no checkpoint (the
                runner's seeded weights), the flagship at batch 64;
13. salt_unet — SaltUNet (16 filters, 4 levels) through ``cli train``
                (480 synthetic images, 2 epochs, Lovász, the validation
                image monitor), ``--resume`` for a third epoch and ``cli
                serve --synthetic`` from its experiment directory; its
                forward fp32 against the CPU and bf16 against fp32;
14. losses    — dice, the mixed dice losses and the focal losses, value
                and gradient, on the card against the CPU;
15. arch      — the U-Net on the SE-ResNet-50, SE-ResNeXt-50,
                DenseNet-121 and ResNet-50 encoders and
                UNetResNetWithDepth-34, full width, bf16, conv kernel
                "on", seeded weights: fp32 logits on the card against the
                CPU (batch 2), hflip-TTA masks of 16 synthetic images
                against the CPU's fp32 under the margin rule, ``serve
                --synthetic 480`` at batch 24 (images/s; the preprocess
                and conv kernels' launches against the JAX route's
                counts); ``pipeline.api.train`` of UNetSeResNet-50 and
                the depth net (the bundle's depths), 2 epochs of 5 steps
                at batch 24; a pretrained se_resnet50 ``.npz`` grafted
                into UNetSeResNet-50 and one train step;
16. arch2     — LargeKernelMatters-34 and PSPNet-34 through the arch
                phase's checks (card vs CPU, 64 TTA masks, ``serve
                --synthetic 480`` at 24, a TTA step profiled) and ``cli
                train-evaluate-predict-cv`` (96 images, 2 folds), PSPNet
                trained 2 epochs of 5 steps under Lovász; the emptiness
                classifier and the stacking heads (18 inputs, with and
                without depth) card vs CPU;
17. int8      — ``model.quant_bits=8``: each conv shape of the flagship's
                int8 route at batch 24 and 64 (quantize bit for bit; the
                conv on its path, the wgmma kernel bit for bit and the
                mma.sync one within one bf16 ulp of the plain versions,
                and the mma.sync kernel on the wgmma shapes too), each
                conv kernel timed by a CUDA graph of back-to-back calls
                and a whole call by CUDA events, beside its bound, the
                mma.sync kernel and cuDNN's bf16 conv; each path's
                launches per forward
                against the route's sites;
                ``serve --int8 --synthetic 2048`` at 24 beside bf16;
10b. fold_parallel (run after cv) — ``parallel.fold_parallel``: the 6
                folds of the flagship (bf16, batch 24 each, conv kernel
                "on") as one vmapped step; ``cli train-evaluate-predict-cv
                --set parallel.fold_parallel=true``, 1 epoch over 480
                synthetic images (the sort kernel once a step over 6 x 24
                rows; each fold's ``best.npz`` served), the aligned step
                against each fold's sequential step (float64 with the
                gradients, fp32 and bf16), and one fold-parallel step
                timed beside six sequential steps;
10c. tooling  — ``cli train --trace-steps --profile DIR`` at batch 24
                (the five phases; the sort kernel in the Chrome trace)
                and ``cli cost-analysis`` of the flagship (train,
                predict, TTA steps; temp bytes above 0);
10d. data_parallel — a process group of one on NCCL: one data-parallel
                train step (BN sums and gradients all-reduced) against
                the plain step, fp32;
18. bench     — ``python -m salt_tpu_torch.tools.bench`` at reduced
                windows (it prints its JSON line; ``flagship_tta_int8`` at
                64 beside bf16);
19. full_solution (run between arch2 and int8) — ``cli full-solution``
                at full width (the flagship's segmentation CV, bf16, hflip
                TTA, conv kernel "on"; the EmptinessClassifier's CV; the
                StackingFCN level), cut in depth only: 192 synthetic
                images, 2 folds (the reference: 6), 1 epoch a first-level
                fold and 2 a stacking fold (the reference trains both to a
                plateau), a 48-image test set; the final submission
                against a numpy gating of the persisted probabilities; an
                emptiness and a stacking fold checkpoint on the card
                against the CPU (fp32: probabilities at 2e-3 and the AUC;
                masks under the margin rule); ``--set
                execution.resume=true`` (no launch, no ``best.npz``
                rewritten, the same submission byte for byte); then
                ``empty-evaluate-predict-cv``, ``ensemble``,
                ``stacking-cv`` and ``distill`` (SaltUNet-16) over the
                stage directories, each command's kernel launches against
                its configuration's;
20. import (run after arch2) — whole reference checkpoints through
                ``models/torch_import.py``: a seeded state_dict of the
                reference's flagship at full width (ResNet-34 trunk, conv
                biases under BN, the reference's key names) converted and
                grafted into the reference-fidelity build
                (``conv_pad_mode="reference"``, ``upsample_mode=
                "align_corners"``): fp32 logits on the card against a
                direct functional torch forward of the state_dict at
                2e-3, bf16 hflip-TTA masks of 32 images with the conv
                kernel "on" against the CPU's fp32 under the margin rule,
                then ``serve --synthetic 2048`` of the grafted weights as
                a 2-fold experiment (row 3 in its halo form: 8 of the 14
                launches a forward); LKM-34, PSPNet-34,
                UNetResNetWithDepth-34, EmptinessClassifier-34 and the
                stacking heads converted and grafted, card against CPU;
21. distill_curve (run after bench) — a teacher (``cli
                train-evaluate-predict-cv`` of the flagship, "on", 480
                synthetic images of the "real" difficulty, 2 folds, 1
                epoch), then ``salt_tpu_torch.tools.distill_curve`` over
                its five students (1 epoch, batches 128 / 64, the TTA
                probe), each student's launches of rows 1, 2, 8 and 9
                against its configuration's, and the bench's
                ``emit_distill_context`` (its bar: the bench phase's
                ``flagship_tta_int8``) and ``measure_serve_student``.
Device times of the first seven kernels come from whole profiler
sessions (``tools/profiling.py``: the profiler loses events), the int8
convs' from CUDA graphs of back-to-back calls (their whole calls' and
the quantizer's from CUDA events), and a kernel's or a
library call's time under its bound fails the run, after
``MEASURE_TRIES`` measurements that all read under it.
Each path's kernel launch counts are set to 0 just before it runs and read
just after (the probe harnesses' and the A/B's too). The script then
prints one JSON line of kernel records and,
last, one JSON line ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it prints no result and exits
non-zero.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so the fp32 comparisons are
real fp32 ones; the bf16 paths do not use TF32.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

N_SERVE_IMAGES = 2048
N_FOLDS = 2
SERVE_BATCH = 24
TRAIN_BATCH = 24
SORT_LENGTH = 2 * 128 * 128       # one image's logits in the Lovász hinge
N_TRAIN_IMAGES = 480              # fold 0 of 6: 400 train / 80 valid
TRAIN_EPOCHS = 2
N_CV_IMAGES = 480                 # 6 folds of 400 train / 80 valid
PROBE_BATCH, PROBE_SIZE = 64, 128  # the probe harnesses' B and H = W
N_META_TRAIN, N_META_TEST = 48, 16  # the metadata phase's PNG tree
BENCH_BATCH = 64                  # bench.py's inference batch
SALT_UNET_FILTERS, SALT_UNET_LEVELS = 16, 4   # bench.py's salt_unet16
#: flagship convs the conv kernel takes per infer forward: 6 encoder
#: layer1, 3 of dec2, 5 hypercolumn-head branches (all 64 -> 64)
CONV_KERNEL_PER_FORWARD = 14
# seeds of the folds' random weights, chosen so that the fold mean
# straddles the 0.5 threshold and the masks hold both classes
FOLD_SEEDS = (1, 100)


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, iters=200, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match="", iters=50, launches_per_call=1):
    """Device time per call of ``fn`` from a whole ``torch.profiler``
    session (``tools/profiling.kernel_ms``: the profiler loses events, so
    each kernel name's mean duration counts times its launches per call,
    from a session that holds the expected launches a call and at least
    90% of their events): with ``match``, the time of the kernels whose
    name contains it, which must number ``launches_per_call`` a call;
    without, every device event's. 0.0 when the profiler records no
    device time."""
    from salt_tpu_torch.tools.profiling import kernel_ms
    return kernel_ms(fn, match, iters, launches_per_call if match else None)


#: measurements of one kernel taken in all while one reads under its bound
MEASURE_TRIES = 3


def under_bound(bound_ms, **times):
    """The times of ``times`` (ms; None for an absent library call) under
    ``bound_ms``, the least time the card could take for the work."""
    return {k: v for k, v in times.items() if v is not None and v < bound_ms}


def check_bound(what, bound_ms, **times):
    """Raise when a time of ``times`` is under ``bound_ms``: such a
    reading is a fault of the measurement. The profiler can lose a
    session's events and read low (in one run a bf16 probe read 0.0705 ms
    under its 0.1042 ms bound, where the other runs read 0.147 ms), so
    the callers measure again, :data:`MEASURE_TRIES` times in all, while
    a reading is under the bound, and log how many tries they took; a
    kernel that reads under its bound every time fails the run."""
    under = under_bound(bound_ms, **times)
    if under:
        raise AssertionError(f"{what}: {under} under the {bound_ms:.5f} ms "
                             "bound")


def seeded_images(n, seed):
    """Smooth uint8 101x101 images (a blurred random field plus noise)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    up = np.kron(rng.rand(n, 13, 13), np.ones((8, 8)))[:, :101, :101]
    return np.clip((up + 0.15 * rng.rand(n, 101, 101)) / 1.15 * 255,
                   0, 255).astype(np.uint8)


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("device", name=repr(name), count=torch.cuda.device_count())
    print(smi, flush=True)
    return name, smi


def phase_build():
    from salt_tpu_torch.ops import build
    t0 = time.perf_counter()
    libs = build.build()
    seconds = time.perf_counter() - t0
    for name, info in build.BUILD_INFO.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln]
        log("build", kernel=name, nvcc_s=f"{info['seconds']:.2f}",
            ptxas=repr("; ".join(regs)))
    log("build", kernels=len(libs), seconds=f"{seconds:.2f}")


def phase_kernel(dev):
    """The preprocess kernel against its plain version: fp32 within
    atol=1e-5 and bf16 within one bf16 ulp of the plain fp32 result cast
    to bf16, at B = 1, 5, 48 (48 = 24 images x 2 TTA passes, the serve
    batch) and 97, and on a batch of 48 that starts at an odd byte (a
    slice of a larger one, as ``predict_dataset`` hands it on); the max
    errors are logged, also against the plain version on the CPU, whose
    divisions the kernel repeats (torch's CPU linspace rounds a few ramp
    values one ulp apart from the card's). Times at B = 48, bf16 output,
    as serve calls it (the record), and at B = 24 in both dtypes (a
    validation batch), each beside its bound."""
    import torch
    from salt_tpu_torch.ops import costs
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    max_err = 0.0
    for b, offset in ((1, 0), (5, 0), (48, 0), (97, 0), (48, 1)):
        raw = torch.from_numpy(seeded_images(b, seed=b + offset)).to(dev)
        raw[0, 0, :7] = torch.tensor([0, 1, 127, 128, 254, 255, 3])
        buf = torch.empty(offset + raw.numel(), dtype=torch.uint8, device=dev)
        imgs = buf[offset:].view(raw.shape)
        imgs.copy_(raw)
        want = preprocess_inference(imgs)
        got = pk.preprocess_inference_kernel(imgs, torch.float32)
        got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        want16 = want.to(torch.bfloat16).float()
        err16 = float((got16.float() - want16).abs().max())
        ulps = float(((got16.float() - want16).abs()
                      / (want16.abs() * 2.0 ** -7 + 1e-30)).max())
        # on the CPU the plain version divides as the kernel does; on the
        # card torch divides by a scalar through its reciprocal
        cpu = preprocess_inference(imgs.cpu())
        err_cpu = float((got.cpu() - cpu).abs().max())
        err16_cpu = float((got16.cpu().float()
                           - cpu.to(torch.bfloat16).float()).abs().max())
        if got.shape != (b, 128, 128, 3) or not err <= 1e-5 or ulps > 1.0:
            raise AssertionError(f"preprocess kernel B={b} offset {offset}: "
                                 f"max_abs_err {err} (fp32, atol 1e-5), "
                                 f"{ulps} bf16 ulp")
        max_err = max(max_err, err)
        log("kernel", name="preprocess_inference", batch=b,
            input_byte_offset=imgs.data_ptr() % 16, fp32_max_abs_err=err,
            bf16_max_abs_err=err16, bf16_max_ulp=ulps,
            fp32_max_abs_err_vs_cpu=err_cpu,
            bf16_max_abs_err_vs_cpu=err16_cpu)

    record = None
    for b, dtype in ((2 * SERVE_BATCH, torch.bfloat16),
                     (SERVE_BATCH, torch.bfloat16),
                     (SERVE_BATCH, torch.float32)):
        imgs = torch.from_numpy(seeded_images(b, seed=7)).to(dev)

        def kernel():
            return pk.preprocess_inference_kernel(imgs, dtype)

        def plain():
            return preprocess_inference(imgs, "edge", dtype)

        with costs.recording() as launched:
            kernel()
        bound_ms, bound_by = costs.launches_bound_ms(launched)
        for tries in range(1, MEASURE_TRIES + 1):
            # device time per call from the profiler; back-to-back CUDA
            # events measure the host's enqueue rate for a kernel this short
            ms = device_ms(kernel, match="preprocess_inference_kernel")
            plain_ms = device_ms(plain)
            enqueue_ms, plain_enqueue_ms = time_ms(kernel), time_ms(plain)
            timed_by = "profiler"
            if ms == 0.0 or plain_ms == 0.0:
                ms, plain_ms, timed_by = enqueue_ms, plain_enqueue_ms, "events"
            if not under_bound(bound_ms, ms=ms, plain_ms=plain_ms):
                break
        check_bound(f"preprocess kernel B={b} {dtype}", bound_ms,
                    ms=ms, plain_ms=plain_ms)
        log("kernel", name="preprocess_inference", batch=b,
            dtype=str(dtype).split(".")[-1], ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
            bound_share=f"{bound_ms / ms:.3f}", bound_by=bound_by,
            bytes=launched[0].nbytes, timed_by=timed_by, tries=tries,
            enqueue_ms=f"{enqueue_ms:.5f}",
            plain_enqueue_ms=f"{plain_enqueue_ms:.5f}")
        if record is None:
            record = {"name": "preprocess_inference", "route": "cuda",
                      "source": "salt_tpu_torch/csrc/preprocess.cu",
                      "replaces": "salt_tpu/ops/pallas_preprocess.py:38",
                      "launches": None, "max_abs_err": max_err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None}
    return record


def phase_model(dev):
    """Full-width UNetResNet34 from seed 0, in the train form and the infer
    form (the sliced-concat sums). fp32 on the card vs the CPU at
    rtol=atol=2e-3 (the whole-model tolerance of the CPU parity tests).
    bf16 vs fp32 on the card, and the bf16 infer form through the conv
    kernel (``model.pallas_conv="on"``) vs the same form on the plain
    convs: max |d logits| <= 0.1 * max |fp32 logits|, because bf16 keeps
    8 significant bits and its rounding compounds through ~70
    convolution/BN layers; the tolerance bounds a drift, it does not
    claim agreement digit for digit. The kernel launches 14 times in the
    infer forward."""
    import torch
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.models.registry import (build_model, infer_conv_fn,
                                                init_seeded)
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    cfg = default_config()
    x = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
    x = x.permute(0, 3, 1, 2)
    model = init_seeded(build_model(cfg.model), seed=0)
    with torch.no_grad():
        cpu = model(x)
        cpu_infer = model(x, infer=True)
        model = model.to(dev, memory_format=torch.channels_last)
        fp32 = model(x.to(dev))
        fp32_infer = model(x.to(dev), infer=True)
        model.set_compute_dtype(torch.bfloat16)
        bf16 = model(x.to(dev))
        bf16_infer = model(x.to(dev), infer=True)
        cfg.model.pallas_conv = "on"
        model.infer_conv = infer_conv_fn(cfg.model)
        ck.launches = 0
        bf16_kernel = model(x.to(dev), infer=True)
        torch.cuda.synchronize()
        kernel_launches = ck.launches
    torch.cuda.synchronize()
    err32 = float((fp32.cpu() - cpu).abs().max())
    err32_infer = float((fp32_infer.cpu() - cpu_infer).abs().max())
    torch.testing.assert_close(fp32.cpu(), cpu, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(fp32_infer.cpu(), cpu_infer, rtol=2e-3,
                               atol=2e-3)
    scale = float(fp32.abs().max())
    err16 = float((bf16 - fp32).abs().max())
    err16_infer = float((bf16_infer - fp32_infer).abs().max())
    err_kernel = float((bf16_kernel - bf16_infer).abs().max())
    for name, out, err in (("bf16 vs fp32", bf16, err16),
                           ("bf16 infer vs fp32 infer", bf16_infer,
                            err16_infer),
                           ("bf16 infer conv kernel vs plain convs",
                            bf16_kernel, err_kernel)):
        if not (torch.isfinite(out).all() and err <= 0.1 * scale):
            raise AssertionError(f"{name} logits: max err {err}, logit "
                                 f"scale {scale}")
    if kernel_launches != CONV_KERNEL_PER_FORWARD:
        raise AssertionError(f"conv kernel launched {kernel_launches} times "
                             f"in one infer forward, expected "
                             f"{CONV_KERNEL_PER_FORWARD}")
    log("model", arch="UNetResNet34", params=sum(
        p.numel() for p in model.parameters()), fp32_vs_cpu=err32,
        fp32_infer_vs_cpu=err32_infer, bf16_vs_fp32=err16,
        bf16_infer_vs_fp32=err16_infer, bf16_kernel_vs_plain=err_kernel,
        conv_launches_per_forward=kernel_launches, logit_scale=scale)


def _is_library_conv(key):
    """A cuDNN / CUTLASS convolution kernel's name (the conv kernel of
    the port aside)."""
    k = key.lower()
    return "conv3x3_pair" not in k and any(
        s in k for s in ("conv", "fprop", "implicit_gemm", "cudnn"))


def phase_profile(dev, card, pallas_conv="off", steps=5, top=12):
    """Where one serve batch's time goes: the bf16 flagship hflip-TTA step
    on SERVE_BATCH images with ``model.pallas_conv``, ``steps`` steps
    under ``torch.profiler``. Host wall time per step (synchronized),
    device kernel time per step, the device's busy share of the wall
    time, the conv kernel's device time and launches with its weight
    repack's (together the route's cost), the library convs' device time,
    and the kernels that take the most device time."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.tools.profiling import (name_readings,
                                                session_reading,
                                                whole_sessions)
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = default_config()
    cfg.model.pallas_conv = pallas_conv
    runner = SegmentationRunner(cfg, dev)
    model = runner.init_model(seed=5)
    imgs = torch.from_numpy(seeded_images(SERVE_BATCH, seed=6)).to(dev)
    for _ in range(3):
        runner.predict_tta_step(model, imgs)
    with FlopCounterMode(display=False) as counter:
        runner.predict_tta_step(model, imgs)
    gflop = counter.get_total_flops() / 1e9     # conv + matmul, per step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        runner.predict_tta_step(model, imgs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    prof, reading = next(whole_sessions(
        lambda i: runner.predict_tta_step(model, imgs), steps, cpu=True))
    device_ms_step = reading["ms"]
    per_name = name_readings(prof.events(), steps)
    kernel = session_reading(prof.events(), steps, "conv3x3_pair_kernel")
    kernel_ms = kernel["ms"]
    # the weight repack before each launch: the device time of the kernels
    # launched inside its host-side profiler range
    repack = [e for e in prof.events() if e.name == ck.REPACK_RANGE
              and e.device_type == torch.autograd.DeviceType.CPU]
    repack_ms = sum(e.device_time_total for e in repack) / steps / 1e3
    library_ms = sum(r["ms"] for name, r in per_name.items()
                     if _is_library_conv(name))
    log("profile", step="predict_tta_step", pallas_conv=pallas_conv,
        images=SERVE_BATCH, dtype=cfg.training.dtype,
        wall_ms=f"{wall_ms:.3f}", device_ms=f"{device_ms_step:.3f}",
        busy_share=f"{device_ms_step / wall_ms:.3f}", gflop=f"{gflop:.1f}",
        tflops_on_wall=f"{gflop / wall_ms:.1f}",
        tflops_on_device=f"{gflop / device_ms_step:.1f}",
        conv_kernel_ms=f"{kernel_ms:.3f}",
        conv_kernel_calls=kernel["launches_per_call"],
        conv_kernel_share=f"{kernel_ms / device_ms_step:.3f}",
        repack_ms=f"{repack_ms:.4f}", repack_calls=len(repack) // steps,
        route_ms=f"{kernel_ms + repack_ms:.3f}",
        library_conv_ms=f"{library_ms:.3f}",
        library_conv_share=f"{library_ms / device_ms_step:.3f}",
        card=repr(card))
    for name, r in list(per_name.items())[:top]:
        log("profile", pallas_conv=pallas_conv, kernel=repr(name[:90]),
            calls_per_step=r["launches_per_call"],
            device_ms_per_step=f"{r['ms']:.3f}")


def _csv_masks(path, h=101, w=101):
    """(ids, uint8 masks [N, h, w]) of a submission.csv (column-major,
    1-indexed (start, length) runs)."""
    import csv
    import numpy as np
    ids, masks = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            flat = np.zeros(h * w, np.uint8)
            runs = [int(v) for v in row["rle_mask"].split()]
            for start, length in zip(runs[0::2], runs[1::2]):
                flat[start - 1:start - 1 + length] = 1
            ids.append(row["id"])
            masks.append(flat.reshape(w, h).T)
    return ids, np.stack(masks)


def margin_rule(what, p_new, p_ref, masks_new, masks_ref, threshold=0.5,
                slack=0.0):
    """The threshold-margin rule of tests/test_submission_parity.py: the
    masks are equal on every pixel whose reference probability is farther
    from the threshold than the largest probability delta (plus
    ``slack``, the rounding of a float16 archive). Returns (delta,
    undecidable pixels)."""
    import numpy as np
    delta = float(np.abs(p_new.astype(np.float32)
                         - p_ref.astype(np.float32)).max())
    decidable = np.abs(p_ref.astype(np.float32) - threshold) > delta + slack
    bad = int(((masks_new != masks_ref) & decidable).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} decidable pixels differ "
                             f"(probability delta {delta})")
    return delta, int((~decidable).sum())


def phase_serve(dev, card):
    import numpy as np
    import torch
    from PIL import Image
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import checkpoint_path, save_flat_npz
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.pipeline.serving import serve
    from salt_tpu_torch.train.steps import SegmentationRunner

    cfg = default_config()                       # bf16, hflip TTA below
    cfg.training.batch_size_inference = SERVE_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "cv")
        for fold in range(N_FOLDS):
            model = init_seeded(build_model(cfg.model), FOLD_SEEDS[fold])
            save_flat_npz(checkpoint_path(exp, f"network_fold_{fold}"),
                          to_flax_flat(model))
        with open(os.path.join(exp, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        images = seeded_images(N_SERVE_IMAGES, seed=2048)
        for i, img in enumerate(images):
            Image.fromarray(img).save(os.path.join(img_dir, f"{i:05d}.png"))
        out_csv = os.path.join(tmp, "submission.csv")

        # the main path: the production call, no probability archive
        cfg.postpro.use_tta = True
        pk.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = serve(cfg, exp, img_dir, out_csv, device=dev)
        wall = time.perf_counter() - t0
        launches = pk.launches
        peak = torch.cuda.max_memory_allocated()

        n_batches = math.ceil(N_SERVE_IMAGES / SERVE_BATCH)
        if result["batches"] != n_batches * N_FOLDS:
            raise AssertionError(f"serve ran {result['batches']} batches, "
                                 f"expected {n_batches} x {N_FOLDS}")
        if launches != result["batches"] + result["warmup_batches"]:
            raise AssertionError(
                f"preprocess kernel launched {launches} times for "
                f"{result['batches']} batches x folds + "
                f"{result['warmup_batches']} warm-up batches")
        with open(out_csv) as f:
            csv_text = f.read()
        if len(csv_text.splitlines()) != N_SERVE_IMAGES + 1:
            raise AssertionError("submission.csv row count")

        # again with the float16 probability archive (--probs-out): the
        # probabilities are finite, the masks are the same, and serve's
        # fold mean equals the TTA step run directly on the first batch
        # (fp16 archive rounding only)
        csv2 = os.path.join(tmp, "submission2.csv")
        probs_out = os.path.join(tmp, "probs.npz")
        result2 = serve(cfg, exp, img_dir, csv2, probs_out, device=dev)
        probs = np.load(probs_out, allow_pickle=True)["probs"]
        if probs.shape != (N_SERVE_IMAGES, 101, 101):
            raise AssertionError(f"probs {probs.shape}")
        if not np.isfinite(probs.astype(np.float32)).all():
            raise AssertionError("non-finite probabilities")
        with open(csv2) as f:
            if f.read() != csv_text:
                raise AssertionError("masks differ between two serve runs")
        runner = SegmentationRunner(cfg, dev)
        folds = [runner.restore(checkpoint_path(exp, f"network_fold_{i}"))
                 for i in range(N_FOLDS)]
        first = torch.from_numpy(images[:SERVE_BATCH]).to(dev)
        ref = sum(runner.predict_tta_step(m, first)[:, 1] for m in folds)
        ref = (ref / N_FOLDS).cpu().numpy()
        err = float(np.abs(probs[:SERVE_BATCH].astype(np.float32) - ref).max())
        if err > 1e-3:
            raise AssertionError(f"served probabilities vs direct step: {err}")
        del folds

        # the same serve through the conv kernel (model.pallas_conv="on",
        # set by the caller so the experiment's config.json does not undo
        # it): timed without the archive, then with it for the margin rule
        # against the default run's archive (float16: slack 1e-3 covers
        # the rounding of both archives, 3 x 2^-12)
        on_set = ("model.pallas_conv",)
        cfg.model.pallas_conv = "on"
        csv_on = os.path.join(tmp, "submission_on.csv")
        ck.launches = 0
        pk.launches = 0
        result_on = serve(cfg, exp, img_dir, csv_on, user_set=on_set,
                          device=dev)
        on_launches, on_pre = ck.launches, pk.launches
        forwards = result_on["batches"] + result_on["warmup_batches"]
        if on_launches != CONV_KERNEL_PER_FORWARD * forwards:
            raise AssertionError(
                f"conv kernel launched {on_launches} times for {forwards} "
                f"forwards x {CONV_KERNEL_PER_FORWARD}")
        if on_pre != forwards:
            raise AssertionError(f"preprocess kernel launched {on_pre} "
                                 f"times for {forwards} forwards")
        probs_on_out = os.path.join(tmp, "probs_on.npz")
        csv_on2 = os.path.join(tmp, "submission_on2.csv")
        serve(cfg, exp, img_dir, csv_on2, probs_on_out, user_set=on_set,
              device=dev)
        with open(csv_on) as f, open(csv_on2) as g:
            if f.read() != g.read():
                raise AssertionError("masks differ between two serve runs "
                                     "with the conv kernel")
        probs_on = np.load(probs_on_out, allow_pickle=True)["probs"]
        ids_off, masks_off = _csv_masks(out_csv)
        ids_on, masks_on = _csv_masks(csv_on)
        if ids_on != ids_off:
            raise AssertionError("submission ids differ")
        on_delta, on_undecidable = margin_rule(
            "serve on vs off", probs_on, probs, masks_on, masks_off,
            slack=1e-3)
    salt = float((probs.astype(np.float32) > 0.5).mean())
    log("serve", images=N_SERVE_IMAGES, folds=N_FOLDS, batch=SERVE_BATCH,
        tta="hflip", dtype=cfg.training.dtype,
        model_images_per_s=result["images_per_sec"],
        images_per_s=f"{N_SERVE_IMAGES / result['seconds']:.1f}",
        timed_s=f"{result['seconds']:.3f}", wall_s=f"{wall:.3f}",
        peak_mem_bytes=peak, preprocess_launches=launches,
        batches=result["batches"], warmup_batches=result["warmup_batches"],
        probs_vs_direct_step=err, salt_fraction=f"{salt:.4f}",
        card=repr(card))
    log("serve", probs_out="float16 archive",
        model_images_per_s=result2["images_per_sec"],
        timed_s=f"{result2['seconds']:.3f}", card=repr(card))
    log("serve", pallas_conv="on", images=N_SERVE_IMAGES, folds=N_FOLDS,
        model_images_per_s=result_on["images_per_sec"],
        images_per_s=f"{N_SERVE_IMAGES / result_on['seconds']:.1f}",
        default_images_per_s=f"{N_SERVE_IMAGES / result['seconds']:.1f}",
        timed_s=f"{result_on['seconds']:.3f}", conv_launches=on_launches,
        forwards=forwards, preprocess_launches=on_pre,
        probs_delta_vs_off=on_delta, undecidable_pixels=on_undecidable,
        mask_pixels_differing=int((masks_on != masks_off).sum()),
        card=repr(card))
    return launches + on_pre, on_launches


def _sort_inputs(b, p, keys_kind, seed):
    """Keys "distinct", "ties" (rounded to quarters) or "nan_zeros" (ties,
    with NaNs, +0.0 and -0.0 mixed in); a Lovász-style payload."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    keys = rng.randn(b, p).astype(np.float32)
    if keys_kind != "distinct":
        keys = np.round(keys * 4) / 4
    if keys_kind == "nan_zeros":
        keys[rng.rand(b, p) < 0.05] = np.nan
        keys[rng.rand(b, p) < 0.1] = 0.0
        keys[rng.rand(b, p) < 0.1] = -0.0
    payload = ((rng.randint(0, 2, (b, p)) << 20)
               | np.arange(p)).astype(np.int32)
    return torch.from_numpy(keys), torch.from_numpy(payload)


#: (rows, P) the sort kernel is held at: the train batch (every call on
#: the train and CV paths: validation pads its last batch to 24), a
#: batch of 8, single rows, the plan's chunk edges, and both sides of the
#: wrapper's choice of chunk (16 and 17 rows on 132 SMs)
SORT_SHAPES = ((1, SORT_LENGTH), (5, SORT_LENGTH), (8, SORT_LENGTH),
               (TRAIN_BATCH, SORT_LENGTH), (3, 1024), (1, 128), (2, 4096),
               (2, 8192), (16, SORT_LENGTH), (17, SORT_LENGTH))
#: rows of 32,768 the sort is timed at: the train batch (the larger
#: chunk) and a batch of 8 (the smaller)
SORT_TIMED_ROWS = (TRAIN_BATCH, 8)


def phase_sort_kernel(dev):
    """The bitonic sort kernel's plan against the plain network on the
    card: keys and payload bit-identical at ``SORT_SHAPES``, with keys
    distinct, with ties and with NaN / +0.0 / -0.0. The Lovász hinge
    through the kernel against the same loss on the CPU, where the plain
    network sorts: value and gradient at rtol 1e-5 / atol 1e-7 (the sort
    is the same permutation; the CPU and the card sum the 32,768 terms in
    another order). Times at ``SORT_TIMED_ROWS`` x 32,768, as a train
    step (24) and a batch of 8 call it, one on each side of
    the wrapper's choice of chunk: every launch of the plan per call
    (``KERNEL_PREFIX``), the plain network, and ``torch.sort`` (stable,
    descending) with the payload gathered along, the library yardstick
    (``tools/sort_probe.py`` gives each launch's time). The kernels
    entry is the train batch's."""
    import torch
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.ops.bitonic import bitonic_sort_desc
    for b, p in SORT_SHAPES:
        for keys_kind in ("distinct", "ties", "nan_zeros"):
            keys, payload = _sort_inputs(b, p, keys_kind, seed=b)
            keys, payload = keys.to(dev), payload.to(dev)
            got_k, got_p = sk.sort_desc(keys, payload)
            torch.cuda.synchronize()
            want_k, want_p = bitonic_sort_desc(keys, payload)
            same = (torch.equal(got_k.view(torch.int32),
                                want_k.view(torch.int32))
                    and torch.equal(got_p, want_p))
            if not same:
                raise AssertionError(f"sort kernel ({b}, {p}) {keys_kind}: "
                                     "not bit-identical to the network")
            log("kernel", name="bitonic_sort_desc", rows=b, length=p,
                keys=keys_kind,
                device_launches_per_call=len(sk.card_plan(b, p, dev)),
                bit_identical=True)

    logits = torch.randn(TRAIN_BATCH, SORT_LENGTH,
                         generator=torch.Generator().manual_seed(0))
    logits = torch.round(logits * 8) / 8                  # ties too
    labels = (torch.rand(TRAIN_BATCH, SORT_LENGTH,
                         generator=torch.Generator().manual_seed(1))
              > 0.6).float()
    results = []
    for d in (dev, torch.device("cpu")):
        x = logits.to(d).requires_grad_(True)
        loss = sk.lovasz_hinge_flat_kernel(x, labels.to(d)).mean()
        loss.backward()
        results.append((loss.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=1e-5,
                               atol=1e-7)
    grad_err = float((results[0][1] - results[1][1]).abs().max())
    log("kernel", name="lovasz_hinge_flat_kernel", rows=TRAIN_BATCH,
        length=SORT_LENGTH, loss=float(results[0][0]),
        value_err=float((results[0][0] - results[1][0]).abs()),
        grad_max_abs_err=grad_err)

    timed = {rows: _time_sort(dev, rows) for rows in SORT_TIMED_ROWS}
    return timed[TRAIN_BATCH]


def _time_sort(dev, rows):
    """The sort at [rows, 32,768], distinct keys: the wrapper's plan
    (every launch per call), the plain network and ``torch.sort`` +
    gather, by the profiler (CUDA events where it records no device
    time), beside the bound; logged, and returned as a kernels entry."""
    import torch
    from salt_tpu_torch.ops import costs
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.ops.bitonic import bitonic_sort_desc
    keys, payload = _sort_inputs(rows, SORT_LENGTH, "distinct", seed=11)
    keys, payload = keys.to(dev), payload.to(dev)

    def plain():
        return bitonic_sort_desc(keys, payload)

    def library():
        values, idx = torch.sort(keys, dim=1, descending=True, stable=True)
        return values, payload.gather(1, idx)

    def kernel():
        return sk.sort_desc(keys, payload)

    plan = sk.card_plan(rows, SORT_LENGTH, dev)
    with costs.recording() as launched:
        kernel()
    (cost,) = launched
    bound_ms, bound_by = costs.launches_bound_ms(launched)
    for tries in range(1, MEASURE_TRIES + 1):
        ms = device_ms(kernel, match=sk.KERNEL_PREFIX, iters=20,
                       launches_per_call=len(plan))
        plain_ms = device_ms(plain, iters=5)
        library_ms = device_ms(library, iters=20)
        events = dict(ms=time_ms(kernel, 50, 5), plain_ms=time_ms(plain, 5, 2),
                      library_ms=time_ms(library, 50, 5))
        timed_by = "profiler"
        if ms == 0.0 or plain_ms == 0.0 or library_ms == 0.0:
            ms, plain_ms, library_ms = (events["ms"], events["plain_ms"],
                                        events["library_ms"])
            timed_by = "events"
        if not under_bound(bound_ms, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms):
            break
    check_bound(f"sort [{rows}, {SORT_LENGTH}]", bound_ms, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms)
    log("kernel", name="bitonic_sort_desc", rows=rows, length=SORT_LENGTH,
        chunk=1 << plan[0].log_chunk, ms=f"{ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / ms:.4f}",
        x_library=f"{ms / library_ms:.3f}",
        device_launches_per_call=len(plan),
        bytes=cost.nbytes, compare_exchanges=cost.operations,
        timed_by=timed_by, tries=tries, events_ms=f"{events['ms']:.5f}",
        events_plain_ms=f"{events['plain_ms']:.5f}",
        events_library_ms=f"{events['library_ms']:.5f}")
    return {"name": "bitonic_sort_desc", "route": "cuda",
            "source": "salt_tpu_torch/csrc/bitonic_sort.cu",
            "replaces": "salt_tpu/ops/pallas_sort.py:46",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


#: (name, x shape [B, C, Hx, Wx], halo): the serve path's four shapes
#: (the 64x64 and 128x128 convs, SAME and, in pad_mode="reference", on a
#: halo ring), a small one, and a C = 320 one (the head's literal concat)
CONV_SHAPES = (("enc_dec_64", (48, 64, 64, 64), False),
               ("head_128", (48, 64, 128, 128), False),
               ("dec_64_halo", (48, 64, 66, 66), True),
               ("head_128_halo", (48, 64, 130, 130), True),
               ("small", (1, 64, 32, 32), False),
               ("c320", (2, 320, 128, 128), False),
               # H = 38 not a multiple of the kernel's 4-row tile, W = 34,
               # and 15 * 10 = 150 tiles, which no 132-SM grid divides
               ("ragged", (15, 64, 38, 34), False))


def _conv_inputs(shape, seed):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    b, c, hx, wx = shape
    x = torch.from_numpy(rng.randn(b, hx, wx, c).astype(np.float32))
    x = x.permute(0, 3, 1, 2).to(torch.bfloat16)        # channels_last
    w = torch.from_numpy((rng.randn(64, c, 3, 3) / np.sqrt(9 * c))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, w


def phase_conv_kernel(dev):
    """The conv kernel against its plain version (fp32 ``F.conv2d`` with
    TF32 off, rounded to bf16) on the card, bf16, at every shape of
    CONV_SHAPES. Element-wise, |kernel - plain| <= one bf16 ulp of the
    plain value + 2 K 2^-24 sum|x||w| (K = 9C): the two sum the same
    exact bf16 products in fp32 in another order, each within K 2^-24
    sum|x||w| of the exact sum, and the rounding to bf16 adds at most one
    ulp. The second term is the floor where cancellation makes a value
    tiny next to its terms. Times at the 128x128 and 64x64 shapes (SAME)
    from the profiler: the kernel, the plain version, and ``F.conv2d`` in
    bf16 on channels_last (cuDNN, the yardstick; the port never calls
    it)."""
    import torch
    import torch.nn.functional as F
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import costs
    from salt_tpu_torch.ops.conv_pair import conv3x3_pair
    max_err = 0.0
    for i, (name, shape, halo) in enumerate(CONV_SHAPES):
        x, w = _conv_inputs(shape, seed=20 + i)
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
        w = w.to(dev)
        with torch.no_grad():
            got = ck.conv3x3_pair_kernel(x, w, halo=halo)
            torch.cuda.synchronize()
            want = conv3x3_pair(x, w, halo=halo).float()
            terms = conv3x3_pair(x.float().abs(), w.float().abs(), halo=halo)
        _, exp = torch.frexp(want)
        ulp = torch.where(want == 0, torch.zeros_like(want),
                          torch.ldexp(torch.ones_like(want), exp - 8))
        tol = ulp + 2 * 9 * shape[1] * 2.0 ** -24 * terms
        err = (got.float() - want).abs()
        worst = float((err / tol.clamp_min(1e-30)).max())
        max_err = max(max_err, float(err.max()))
        log("conv_kernel", shape=name, x=list(shape), halo=halo,
            max_abs_err=float(err.max()), worst_err_over_tol=f"{worst:.3f}",
            over_one_ulp=int((err > ulp).sum()), elements=err.numel())
        if got.shape != want.shape or not worst <= 1.0:
            raise AssertionError(f"conv kernel {name}: error {worst} x "
                                 "the tolerance")
    records = {}
    for name, shape, halo in CONV_SHAPES[:2]:
        x, w = _conv_inputs(shape, seed=7)
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
        w = w.to(dev)

        def kernel():
            return ck.conv3x3_pair_kernel(x, w, halo=halo)

        def plain():
            return conv3x3_pair(x, w, halo=halo)

        def library():
            return F.conv2d(x, w, padding=0 if halo else 1)

        with torch.no_grad(), costs.recording() as launched:
            kernel()
        (cost,) = launched
        bound_ms, bound_by = costs.launches_bound_ms(launched)
        flops, nbytes = cost.operations, cost.nbytes
        for tries in range(1, MEASURE_TRIES + 1):
            with torch.no_grad():
                ms = device_ms(kernel, match="conv3x3_pair_kernel", iters=20)
                plain_ms = device_ms(plain, iters=10)
                library_ms = device_ms(library, iters=20)
                events = dict(ms=time_ms(kernel, 50, 5),
                              plain_ms=time_ms(plain, 20, 3),
                              library_ms=time_ms(library, 50, 5))
            timed_by = "profiler"
            if 0.0 in (ms, plain_ms, library_ms):
                ms, plain_ms, library_ms = (events["ms"], events["plain_ms"],
                                            events["library_ms"])
                timed_by = "events"
            if not under_bound(bound_ms, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms):
                break
        check_bound(f"conv kernel {name}", bound_ms, ms=ms,
                    plain_ms=plain_ms, library_ms=library_ms)
        log("conv_kernel", shape=name, x=list(shape), ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, flops=flops,
            bytes=nbytes, tflops=f"{flops / ms / 1e9:.1f}",
            roofline_share=f"{bound_ms / ms:.3f}", timed_by=timed_by,
            tries=tries, events_ms=f"{events['ms']:.5f}",
            events_library_ms=f"{events['library_ms']:.5f}")
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    head = records["head_128"]
    return {"name": "conv3x3_pair", "route": "cuda",
            "source": "salt_tpu_torch/csrc/conv3x3_pair.cu",
            "replaces": "salt_tpu/ops/pallas_conv.py:66",
            "launches": None, "max_abs_err": max_err, **head}


def _probe_counts():
    from salt_tpu_torch.ops import (conv128_kernel, conv64p_kernel,
                                    matmul_kernel)
    return dict(conv128=conv128_kernel.launches,
                conv64p=conv64p_kernel.launches,
                matmul=matmul_kernel.launches,
                conv64p_v2=conv64p_kernel.launches_v2)


def phase_probe_path(card):
    """The probe harnesses at their full size, as a user runs them: the
    conv probe (the pair-packed conv at tile_h 16 and 32, the im2col conv
    at tile_h 16 and 32, the matmul at two GEMMs; 3 windows of 20
    launches each after one warm-up, and one correctness call per conv)
    and the variant sweep (5 variants: one correctness call, one warm-up,
    2 windows of 20). Returns the four kernels' launch counts."""
    from salt_tpu_torch.ops import (conv128_kernel, conv64p_kernel,
                                    matmul_kernel)
    from salt_tpu_torch.tools import conv_probe, conv_probe2
    conv128_kernel.launches = conv64p_kernel.launches = 0
    conv64p_kernel.launches_v2 = matmul_kernel.launches = 0
    t0 = time.perf_counter()
    conv_probe.main(["--device", "cuda"])
    conv_probe2.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = _probe_counts()
    expected = dict(conv128=2 * 61 + 1, conv64p=2 * 61 + 1, matmul=2 * 61,
                    conv64p_v2=5 * (1 + 1 + 2 * 20))
    if counts != expected:
        raise AssertionError(f"probe kernels launched {counts}, expected "
                             f"{expected}")
    log("probe_path", wall_s=f"{wall:.3f}", **counts, card=repr(card))
    return counts


def _ulp_check(name, got, want, terms, k):
    """|got - want| <= one bf16 ulp of want + 2 K 2^-24 sum|x||w| (the rule
    of phase_conv_kernel); returns max |got - want|."""
    import torch
    want = want.float()
    _, exp = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    tol = ulp + 2 * k * 2.0 ** -24 * terms
    err = (got.float() - want).abs()
    worst = float((err / tol.clamp_min(1e-30)).max())
    log("probe_kernel", check=name, max_abs_err=float(err.max()),
        worst_err_over_tol=f"{worst:.3f}", over_one_ulp=int((err > ulp).sum()),
        elements=err.numel())
    if got.shape != want.shape or not worst <= 1.0:
        raise AssertionError(f"{name}: error {worst} x the tolerance")
    return float(err.max())


def _timed(kernel, match, plain, library):
    """ms, plain_ms, library_ms (None without a library call) from the
    profiler; CUDA events where the profiler records no device time."""
    import torch
    with torch.no_grad():
        t = dict(ms=device_ms(kernel, match=match, iters=20),
                 plain_ms=device_ms(plain, iters=5),
                 library_ms=device_ms(library, iters=20) if library else None)
        if 0.0 in t.values():
            t = dict(ms=time_ms(kernel, 20, 3), plain_ms=time_ms(plain, 5, 1),
                     library_ms=time_ms(library, 20, 3) if library else None)
            t["timed_by"] = "events"
        else:
            t["timed_by"] = "profiler"
    return t


def phase_probe_kernels(dev, card):
    """The four probe kernels on the card at the harnesses' full size,
    bf16 within one bf16 ulp plus 2 K 2^-24 sum|x||w| of their plain
    versions (K = 768, 1152 and the matmul's K), int8 bit for bit:
    - pair-packed conv, x_packed [64,130,72,128], with a w_packed random in
      every slot (the structural ones too): row 5 at tile_h 16, 32 and 64,
      row 7 at the same with db off and on, in bf16 and int8;
    - im2col conv, x [64,130,136,128] (columns 130..135 NaN), w_flat
      [1152,128]: tile_h 16 and 32;
    - matmul [524288,768]x[768,128] and [1048576,576]x[576,64], tile_m 2048.
    Times from the profiler with weights packed from a 3x3 kernel, so that
    ``F.conv2d`` (cuDNN, bf16, channels_last, VALID on the unpacked
    input) computes the same function: row 5 at tile_h 16, row 7 at
    tile_h 32 with db (and its int8 twin), row 4 at tile_h 16, row 6 at both
    GEMMs (both in the record, under ``shapes``); beside the plain version
    and the bound. Rows 4, 5 and 7 run one kernel (``csrc/conv_valid.cu``,
    the profiler's ``conv_valid_kernel``; row 7 int8 its s8 instantiation),
    which picks its own tile: their tile_h and db lines run the same
    launches; row 7 int8's K-major weight copy is timed on a line of its
    own. Row 6 runs ``csrc/matmul_wgmma.cu`` (``matmul_wgmma_kernel``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from salt_tpu_torch.ops import costs
    from salt_tpu_torch.ops.conv128_kernel import make_conv128_kernel
    from salt_tpu_torch.ops.conv64p_kernel import (make_conv64p_kernel,
                                                   make_conv64p_v2)
    from salt_tpu_torch.ops.conv_valid import kmajor_weights
    from salt_tpu_torch.ops.matmul_kernel import make_matmul_kernel
    from salt_tpu_torch.ops.probe_conv import (conv128_plain, conv64p_plain,
                                               matmul_plain,
                                               pack_pair_weights)
    B, H, W = PROBE_BATCH, PROBE_SIZE, PROBE_SIZE
    P, PO = (W + 16) // 2, W // 2
    g = torch.Generator(dev).manual_seed(0)
    cl = torch.channels_last
    err = {}

    # ---------- pair-packed conv: correctness, every weight slot live --
    x = torch.rand(B, H + 2, P, 128, generator=g, device=dev).bfloat16()
    wp = (torch.randn(768, 128, generator=g, device=dev) * 0.05).bfloat16()
    with torch.no_grad():
        want = conv64p_plain(x, wp, H, W)
        terms = conv64p_plain(x.float().abs(), wp.float().abs(), H, W)
        convs = [(f"conv64p th{th}", make_conv64p_kernel(th, H, W))
                 for th in (16, 32, 64)]
        convs += [(f"conv64p_v2 th{th}{' +db' if db else ''}",
                   make_conv64p_v2(th, H, W, db=db))
                  for th in (16, 32, 64) for db in (False, True)]
        for name, fn in convs:
            e = _ulp_check(name, fn(x, wp), want, terms, 768)
            key = name.split()[0]
            err[key] = max(err.get(key, 0.0), e)
        del want, terms
        xq = torch.randint(-127, 128, (B, H + 2, P, 128), generator=g,
                           device=dev, dtype=torch.int8)
        wq = torch.randint(-128, 128, (768, 128), generator=g, device=dev,
                           dtype=torch.int8)
        want = conv64p_plain(xq, wq, H, W)
        for th in (16, 32, 64):
            for db in (False, True):
                got = make_conv64p_v2(th, H, W, db=db, int8=True)(xq, wq)
                same = torch.equal(got, want)
                log("probe_kernel", check=f"conv64p_v2 th{th} db={db} INT8",
                    bit_identical=same)
                if not same:
                    raise AssertionError(f"int8 conv64p_v2 th{th} db={db}: "
                                         "not bit-identical to the plain "
                                         "version")
        del want

    # ---------- im2col conv: correctness --------------------------------
    x4 = torch.randn(B, H + 2, W + 8, 128, generator=g, device=dev)
    x4[:, :, W + 2:] = float("nan")
    x4 = x4.bfloat16()
    w4 = (torch.randn(1152, 128, generator=g, device=dev) / 1152 ** 0.5
          ).bfloat16()
    with torch.no_grad():
        want = conv128_plain(x4, w4, H, W)
        terms = conv128_plain(x4.float().abs(), w4.float().abs(), H, W)
        for th in (16, 32):
            err["conv128"] = max(err.get("conv128", 0.0), _ulp_check(
                f"conv128 th{th}", make_conv128_kernel(th, H, W, 128, 128)(
                    x4, w4), want, terms, 1152))
        del want, terms

    # ---------- matmul: correctness --------------------------------------
    gemms = ((B * H * PO, 768, 128), (B * H * W, 576, 64))
    mats = {}
    for m, k, n in gemms:
        a = torch.randn(m, k, generator=g, device=dev).bfloat16()
        b = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).bfloat16()
        mats[m] = (a, b)
        with torch.no_grad():
            want = matmul_plain(a, b)
            terms = matmul_plain(a.float().abs(), b.float().abs())
            err["matmul"] = max(err.get("matmul", 0.0), _ulp_check(
                f"matmul {m}x{k}x{n}", make_matmul_kernel(m, k, n)(a, b),
                want, terms, k))
        del want, terms

    # ---------- times -----------------------------------------------------
    rng = np.random.RandomState(1)
    w3 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    wp3 = torch.from_numpy(pack_pair_weights(w3)).to(dev).bfloat16()
    w_oihw = torch.from_numpy(w3).permute(3, 2, 0, 1).contiguous().to(
        dev).bfloat16()
    x_nchw = x.reshape(B, H + 2, 2 * P, 64)[:, :, :W + 2].contiguous(
        ).permute(0, 3, 1, 2)
    wq3 = torch.clamp(torch.round(wp3.float() / wp3.float().abs().max()
                                  * 127), -127, 127).to(torch.int8)
    c64_bytes = x.numel() * 2 + 768 * 128 * 2 + B * H * PO * 128 * 2
    c64_ops = 2 * B * H * PO * 768 * 128
    records = {}

    def record(key, variant, kernel, match, plain, library, nbytes, ops,
               ops_rate=costs.BF16_DENSE_FLOPS):
        bound_ms, bound_by = costs.bound_ms(nbytes, ops, ops_rate)
        for tries in range(1, MEASURE_TRIES + 1):
            t = _timed(kernel, match, plain, library)
            if not under_bound(bound_ms, ms=t["ms"], plain_ms=t["plain_ms"],
                               library_ms=t["library_ms"]):
                break
        lib = t["library_ms"]
        check_bound(f"{key} {variant}", bound_ms, ms=t["ms"],
                    plain_ms=t["plain_ms"], library_ms=lib)
        log("probe_kernel", name=key, variant=variant, ms=f"{t['ms']:.5f}",
            plain_ms=f"{t['plain_ms']:.5f}",
            library_ms=f"{lib:.5f}" if lib is not None else None,
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, bytes=nbytes,
            ops=ops, tops=f"{ops / t['ms'] / 1e9:.1f}",
            roofline_share=f"{bound_ms / t['ms']:.3f}",
            timed_by=t["timed_by"], tries=tries, card=repr(card))
        rec = dict(variant=variant, ms=t["ms"], plain_ms=t["plain_ms"],
                   library_ms=lib, bound_ms=bound_ms, bound_by=bound_by)
        records.setdefault(key, []).append(rec)
        return rec

    conv5 = make_conv64p_kernel(16, H, W)
    v2 = make_conv64p_v2(32, H, W, db=True)
    v2q = make_conv64p_v2(32, H, W, db=True, int8=True)
    library64 = lambda: F.conv2d(x_nchw, w_oihw)
    record("conv64p", "th16", lambda: conv5(x, wp3), "conv_valid_kernel",
           lambda: conv64p_plain(x, wp3, H, W), library64, c64_bytes, c64_ops)
    record("conv64p_v2", "th32 +db bf16", lambda: v2(x, wp3),
           "conv_valid_kernel", lambda: conv64p_plain(x, wp3, H, W),
           library64, c64_bytes, c64_ops)
    record("conv64p_v2_int8", "th32 +db INT8", lambda: v2q(xq, wq3),
           "conv_valid_kernel", lambda: conv64p_plain(xq, wq3, H, W), None,
           x.numel() + 768 * 128 + B * H * PO * 128 * 2, c64_ops,
           costs.INT8_DENSE_OPS)
    # the int8 call's K-major weight copy (98 KB), outside its kernel time
    copy_ms = device_ms(lambda: kmajor_weights(wq3), iters=20)
    copy_bound = costs.bound_ms(2 * wq3.numel(), 0, 1.0)[0]
    check_bound("int8 weight copy", copy_bound, ms=copy_ms)
    log("probe_kernel", name="conv64p_v2_int8 weight copy",
        variant="kmajor_weights [768,128] -> [128,768] int8",
        ms=f"{copy_ms:.5f}", bound_ms=f"{copy_bound:.5f}", bound_by="bytes",
        card=repr(card))
    conv4 = make_conv128_kernel(16, H, W, 128, 128)
    x4v = x4[:, :, :W + 2].contiguous().permute(0, 3, 1, 2)
    w4_oihw = w4.reshape(3, 3, 128, 128).permute(3, 2, 0, 1).contiguous()
    record("conv128", "th16", lambda: conv4(x4, w4), "conv_valid_kernel",
           lambda: conv128_plain(x4, w4, H, W),
           lambda: F.conv2d(x4v, w4_oihw),
           x4.numel() * 2 + w4.numel() * 2 + B * H * W * 128 * 2,
           2 * B * H * W * 1152 * 128)
    for m, k, n in gemms:
        a, b = mats[m]
        mm = make_matmul_kernel(m, k, n)
        record("matmul", f"{m}x{k}x{n}", lambda: mm(a, b),
               "matmul_wgmma_kernel",
               lambda: matmul_plain(a, b), lambda: torch.matmul(a, b),
               (m * k + k * n + m * n) * 2, 2 * m * k * n)
    sources = dict(
        conv128=("salt_tpu_torch/csrc/conv_valid.cu",
                 "tools/pallas_conv.py:35"),
        conv64p=("salt_tpu_torch/csrc/conv_valid.cu",
                 "tools/pallas_conv.py:115"),
        matmul=("salt_tpu_torch/csrc/matmul_wgmma.cu",
                "tools/pallas_conv.py:173"),
        conv64p_v2=("salt_tpu_torch/csrc/conv_valid.cu",
                    "tools/pallas_conv2.py:53"))
    out = {}
    for key, (source, replaces) in sources.items():
        rec, *more = records[key]
        out[key] = {"name": key, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": err[key], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"],
                    "variant": rec["variant"]}
        if more:
            out[key]["shapes"] = [rec, *more]
    int8 = records["conv64p_v2_int8"][0]
    out["conv64p_v2"].update(int8_ms=int8["ms"],
                             int8_plain_ms=int8["plain_ms"],
                             int8_bound_ms=int8["bound_ms"],
                             int8_bound_by=int8["bound_by"],
                             int8_weight_copy_ms=copy_ms)
    return out



def phase_ab(card):
    """``python -m salt_tpu_torch.tools.ab_conv`` at batch 64, 2 windows of
    3 steps: the flagship bf16 TTA step with the conv kernel off, on,
    on+res64 and on+res128 from one seeded model. The kernel launches 14,
    9 (6 encoder + 3 decoder convs at 64x64) and 5 (the head at 128x128)
    times per step, and never "off"; every variant's probabilities within
    0.05 of "off" (bf16 rounding of some convs in another order). Returns
    the kernel's launches in the run."""
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.tools import ab_conv
    ck.launches = 0
    results = ab_conv.main(["--batches", "64", "--iters", "3", "--windows",
                            "2"])[64]
    launches = ck.launches
    per_step = {name: r["launches"] for name, r in results.items()}
    if per_step != {"off": 0, "on": 14, "on+res64": 9, "on+res128": 5}:
        raise AssertionError(f"ab: conv kernel launches per step {per_step}")
    if launches != 7 * (14 + 9 + 5):
        raise AssertionError(f"ab: {launches} conv kernel launches")
    worst = max(r["dprob"] for r in results.values())
    if not worst <= 0.05:
        raise AssertionError(f"ab: max |d prob| vs off {worst}")
    log("ab", batch=64, launches=launches, card=repr(card),
        **{f"{name}_ms": f"{r['ms']:.3f}" for name, r in results.items()},
        **{f"{name}_dprob": r["dprob"] for name, r in results.items()})
    return launches


def _flat_grads(model):
    return {n: p.grad.detach().float().cpu() for n, p in
            model.named_parameters()}


def _train_step_on(device, cfg, x, y, dtype):
    """One ``runner.update`` of the seeded flagship on ``device`` from the
    network inputs ``x, y``; the network computes in ``dtype`` (fp32 or
    fp64: the parameters are cast in place after the optimizer is
    built)."""
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.train.steps import SegmentationRunner
    runner = SegmentationRunner(cfg, device)
    state = runner.train_state(init_seeded(build_model(cfg.model), 0))
    state.model.to(dtype)
    state.model.compute_dtype = dtype
    before = {n: p.detach().cpu().clone()
              for n, p in state.model.named_parameters()}
    loss = runner.update(state, x.to(device, dtype), y.to(device))
    return dict(
        loss=float(loss), grads=_flat_grads(state.model),
        steps={n: (p.detach().cpu() - before[n]).double()
               for n, p in state.model.named_parameters()},
        buffers={n: b.detach().cpu().double() for n, b in
                 state.model.named_buffers() if b.is_floating_point()})


def _compare_steps(card, cpu):
    import torch
    loss_err = abs(card["loss"] - cpu["loss"])
    worst_grad = 0.0
    for n, g in cpu["grads"].items():
        err = float((card["grads"][n] - g).abs().max())
        worst_grad = max(worst_grad, err / (float(g.abs().max()) + 1e-30))
    diffs = torch.cat([(card["steps"][n] - v).abs().flatten()
                       for n, v in cpu["steps"].items()])
    buf_err = max(float((card["buffers"][n] - b).abs().max())
                  for n, b in cpu["buffers"].items())
    return loss_err, worst_grad, diffs, buf_err


def phase_train_step(dev):
    """One train step of the full-width flagship on the card (TF32 off,
    the sort kernel) and on the CPU (the plain network), from the same
    seeded weights, on 2 images with the same augmentation draws.

    The step's first half, ``_train_inputs``: the network input within
    2.5e-4 and at most 0.05% of target pixels flipped (the CPU and the card
    round sin/cos, the 8x8 solve and the resizes differently, and a warped
    mask value within that of 0.5 may threshold either way). The second
    half, ``update``, then runs on the CPU's inputs on both.

    In float64 (the network; the Lovász errors are fp32 on both, as the
    loss casts them and sums them in fp32) the two must agree tightly:
    loss within 1e-6, every gradient leaf within 1e-6 of its max, every
    Adam step within 1e-3 lr (an element whose gradient is near Adam's
    eps moves its step by eps * dg / g^2), BatchNorm statistics within
    1e-9. In fp32 the BatchNorm backward at
    this batch cancels (on the CPU the port's fp32 gradients sit ~1e-3 of
    a leaf's max from float64 at UNetResNet18, and JAX's up to 23%,
    tests/test_torch_train_step.py), so fp32 is held to the loss within
    1e-4, BatchNorm statistics within 1e-4, and every Adam step within 2
    lr (a step is ~lr * sign(g)); its gradient gap is printed."""
    import torch
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops.augment import draw_augment_params
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = default_config()
    cfg.training.dtype = "float32"
    lr = cfg.training.lr
    imgs = torch.from_numpy(seeded_images(2, seed=31))
    masks = (imgs > 140).to(torch.uint8)
    params = draw_augment_params(torch.Generator().manual_seed(3), 2, 101, 101)
    x, y = SegmentationRunner(cfg, "cpu")._train_inputs(imgs, masks, params)
    xd, yd = SegmentationRunner(cfg, dev)._train_inputs(
        imgs.to(dev), masks.to(dev), params.to(dev))
    x_err = float((xd.cpu() - x).abs().max())
    y_flips = float((yd.cpu() != y).float().mean())
    log("train_step", half="_train_inputs", x_max_abs_err=x_err,
        target_flipped_share=y_flips)
    if x_err > 2.5e-4 or y_flips > 5e-4:
        raise AssertionError(f"_train_inputs card vs cpu: {x_err}, "
                             f"{y_flips} of target pixels")
    for dtype, tol in ((torch.float64, dict(loss=1e-6, grad=1e-6, step=1e-3,
                                            buf=1e-9)),
                       (torch.float32, dict(loss=1e-4, grad=None, step=2.001,
                                            buf=1e-4))):
        card = _train_step_on(dev, cfg, x, y, dtype)
        cpu = _train_step_on(torch.device("cpu"), cfg, x, y, dtype)
        loss_err, worst_grad, diffs, buf_err = _compare_steps(card, cpu)
        step_err = float(diffs.max()) / lr
        log("train_step", arch="UNetResNet34", batch=2, dtype=str(dtype),
            loss_card=card["loss"], loss_cpu=cpu["loss"], loss_err=loss_err,
            worst_grad_leaf_err_of_max=f"{worst_grad:.3e}",
            step_max_diff_over_lr=f"{step_err:.3e}",
            steps_within_hundredth_lr=
            f"{float((diffs <= 1e-2 * lr).double().mean()):.5f}",
            bn_stats_max_err=f"{buf_err:.3e}")
        if (loss_err > tol["loss"] or step_err > tol["step"]
                or buf_err > tol["buf"]
                or (tol["grad"] is not None and worst_grad > tol["grad"])):
            raise AssertionError(f"train step {dtype} card vs cpu: loss "
                                 f"{loss_err}, gradient leaf {worst_grad}, "
                                 f"step {step_err} lr, BN stats {buf_err}")


class _EpochTimes:
    """Collects ``ExperimentTiming``'s per-epoch record (wall seconds and
    mean batch seconds) from the package logger."""

    def __init__(self):
        import logging
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.epochs = []

    def _emit(self, record):
        if record.msg.startswith("epoch %d time"):
            self.epochs.append(record.args)


def phase_train(dev, card):
    """The main train path: ``pipeline.api.train`` on a synthetic bundle at
    full width, bf16, batch 24, 2 epochs; then ``serve`` of its best.npz.
    Every loss finite; the sort kernel launched once per train step and
    once per validation-loss batch; the preprocess kernel once per
    validation predict and validation-loss batch."""
    import math
    import numpy as np
    import torch
    from PIL import Image
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.core.logging import get_logger, init_logger
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.pipeline import api
    from salt_tpu_torch.pipeline.serving import serve

    cfg = default_config()                    # bf16, batch 24, Lovász
    bundle = synthetic_bundle(N_TRAIN_IMAGES, seed=cfg.execution.seed)
    n_valid = math.ceil(N_TRAIN_IMAGES / cfg.execution.n_cv_splits)
    steps_per_epoch = (N_TRAIN_IMAGES - n_valid) // TRAIN_BATCH
    val_batches = math.ceil(n_valid / cfg.training.batch_size_inference)
    times = _EpochTimes()
    init_logger()
    get_logger().addHandler(times.handler)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.paths.experiment_dir = os.path.join(tmp, "exp")
        cfg.training.epochs = TRAIN_EPOCHS
        experiment = Experiment(cfg.paths.experiment_dir)

        # the main path
        sk.launches = sk.device_launches = 0
        pk.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        api.train(cfg, experiment, bundle, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sort_launches, pre_launches = sk.launches, pk.launches
        sort_device_launches = sk.device_launches
        peak = torch.cuda.max_memory_allocated()
        get_logger().removeHandler(times.handler)

        train_steps = TRAIN_EPOCHS * steps_per_epoch
        if sort_launches != train_steps + TRAIN_EPOCHS * val_batches:
            raise AssertionError(
                f"sort kernel launched {sort_launches} times for "
                f"{train_steps} train steps + {TRAIN_EPOCHS * val_batches} "
                "validation-loss batches")
        # validation pads its last batch to the inference batch size
        want_device = (
            train_steps * len(sk.card_plan(TRAIN_BATCH, SORT_LENGTH, dev))
            + TRAIN_EPOCHS * val_batches * len(sk.card_plan(
                cfg.training.batch_size_inference, SORT_LENGTH, dev)))
        if sort_device_launches != want_device:
            raise AssertionError(
                f"sort kernel: {sort_device_launches} device launches for "
                f"{sort_launches} calls, not the plans' {want_device}")
        if pre_launches != 2 * TRAIN_EPOCHS * val_batches:
            raise AssertionError(
                f"preprocess kernel launched {pre_launches} times for "
                f"{TRAIN_EPOCHS * val_batches} validation batches x "
                "(predict + loss)")
        with open(os.path.join(cfg.paths.experiment_dir,
                               "channels_network.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        losses = [e["train_loss"] for e in epochs] + [e["sum"] for e in epochs]
        if len(epochs) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train epochs {epochs}")
        best = experiment.checkpoint_path("network")
        if not os.path.exists(best):
            raise AssertionError("no best.npz")

        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        for i, img in enumerate(bundle.images[:30]):
            Image.fromarray(img).save(os.path.join(img_dir, f"{i:03d}.png"))
        out_csv = os.path.join(tmp, "submission.csv")
        served = serve(default_config(), cfg.paths.experiment_dir, img_dir,
                       out_csv, device=dev)
        with open(out_csv) as f:
            if len(f.read().splitlines()) != 31:
                raise AssertionError("submission.csv row count")
    wall1, mean_batch1 = times.epochs[-1][1], times.epochs[-1][2]
    log("train", images=N_TRAIN_IMAGES, train_images=N_TRAIN_IMAGES - n_valid,
        valid_images=n_valid, epochs=TRAIN_EPOCHS, batch=TRAIN_BATCH,
        dtype=cfg.training.dtype, steps=train_steps, wall_s=f"{wall:.3f}",
        epoch2_ms_per_step=f"{mean_batch1 * 1e3:.3f}",
        epoch2_train_images_per_s=f"{TRAIN_BATCH / mean_batch1:.1f}",
        epoch2_wall_s=f"{wall1:.3f}",
        epoch2_validation_s=f"{wall1 - steps_per_epoch * mean_batch1:.3f}",
        epoch1_wall_s=f"{times.epochs[0][1]:.3f}",
        peak_mem_bytes=peak, sort_launches=sort_launches,
        sort_device_launches=sort_device_launches,
        preprocess_launches=pre_launches,
        train_loss=[round(e["train_loss"], 5) for e in epochs],
        val_iout=[round(e["iout"], 5) for e in epochs],
        served_images=served["n"], card=repr(card))
    return sort_launches, pre_launches


def phase_train_profile(dev, card, steps=5, top=14):
    """Where one bf16 train step's time goes (24 images, the flagship at
    full width): host wall and device ms per step, the busy share,
    GFLOP (conv + matmul, forward and backward) and TFLOP/s, the top
    kernels, and the sort's share of device time, every launch of its
    plan counted."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.tools.profiling import (name_readings,
                                                session_reading,
                                                whole_sessions)
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = default_config()
    runner = SegmentationRunner(cfg, dev)
    state = runner.init_state(5)
    imgs = torch.from_numpy(seeded_images(TRAIN_BATCH, seed=41)).to(dev)
    masks = (imgs > 140).to(torch.uint8)
    g = torch.Generator(device=dev)

    def step(i):
        g.manual_seed(i)
        return runner.train_step(state, imgs, masks, g)

    for i in range(3):
        step(i)
    with FlopCounterMode(display=False) as counter:
        step(3)
    gflop = counter.get_total_flops() / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        float(step(i))             # the loop reads each loss, as fit does
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    prof, reading = next(whole_sessions(lambda i: float(step(i)), steps,
                                        cpu=True))
    device_ms_step = reading["ms"]
    sort = session_reading(prof.events(), steps, sk.KERNEL_PREFIX)
    sort_ms = sort["ms"]
    log("train_profile", step="train_step", images=TRAIN_BATCH,
        dtype=cfg.training.dtype, wall_ms=f"{wall_ms:.3f}",
        device_ms=f"{device_ms_step:.3f}",
        busy_share=f"{device_ms_step / wall_ms:.3f}", gflop=f"{gflop:.1f}",
        tflops_on_wall=f"{gflop / wall_ms:.1f}",
        tflops_on_device=f"{gflop / device_ms_step:.1f}",
        sort_kernel_ms=f"{sort_ms:.4f}",
        sort_kernel_share=f"{sort_ms / device_ms_step:.4f}",
        sort_device_launches_per_step=sort["launches_per_call"],
        card=repr(card))
    for name, r in list(name_readings(prof.events(), steps).items())[:top]:
        log("train_profile", kernel=repr(name[:90]),
            calls_per_step=r["launches_per_call"],
            device_ms_per_step=f"{r['ms']:.3f}")
    # the host side: the ops whose own CPU time is largest (the profiler
    # adds its own cost to each, so these rank, they do not time)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    log("train_profile", kernel_launches_per_step=launches // steps)
    for e in host[:8]:
        log("train_profile", host_op=repr(e.key[:60]),
            calls_per_step=e.count // steps,
            self_cpu_ms_per_step=f"{e.self_cpu_time_total / steps / 1e3:.3f}")


def phase_cv(card, n_folds=6):
    """The slice's CV path at full width, through the command line as a
    user runs it: ``train-evaluate-predict-cv`` with
    ``model.pallas_conv="on"`` (bf16, hflip TTA, batch 24, N_CV_IMAGES
    synthetic images in ``n_folds`` folds, 1 epoch per fold, the CLI's
    synthetic test set of N_CV_IMAGES // 4), then ``evaluate-predict-cv``
    with "off" on the same experiment directory. The conv kernel launches
    14 times per infer forward of the first (the validation predictions
    of each fit, the out-of-fold and the test predictions) and never in
    the second; the sort and preprocess kernels once per train step,
    validation-loss or predict batch. The out-of-fold masks (hence the
    fold scores) and the submission agree under the threshold-margin rule
    (fp32 archives: no slack), and a fold with no undecidable pixel has
    the same IOUT in both. Then the int8 gate over the same experiment
    (:func:`_cv_int8_gate`). Returns the launches of the three."""
    import numpy as np
    import torch
    from salt_tpu_torch import cli
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk

    if N_CV_IMAGES % n_folds:
        raise ValueError("the cv phase counts launches for equal folds")
    n_valid = N_CV_IMAGES // n_folds
    n_test = max(N_CV_IMAGES // 4, 8)
    val_batches = math.ceil(n_valid / SERVE_BATCH)
    test_batches = math.ceil(n_test / SERVE_BATCH)
    steps = (N_CV_IMAGES - n_valid) // TRAIN_BATCH
    expected = {
        "on": dict(conv=CONV_KERNEL_PER_FORWARD * n_folds
                   * (2 * val_batches + test_batches),
                   preprocess=n_folds * (3 * val_batches + test_batches),
                   sort=n_folds * (steps + val_batches)),
        "off": dict(conv=0, preprocess=n_folds * (val_batches + test_batches),
                    sort=0)}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "cv")
        flags = ["--synthetic", str(N_CV_IMAGES), "--epochs", "1",
                 "--set", f"paths.experiment_dir={exp}",
                 "--set", "postpro.use_tta=true",
                 "--set", f"execution.n_cv_splits={n_folds}",
                 "--set", f"training.batch_size_train={TRAIN_BATCH}",
                 "--set", f"training.batch_size_inference={SERVE_BATCH}"]
        for command, mode in (("train-evaluate-predict-cv", "on"),
                              ("evaluate-predict-cv", "off")):
            ck.launches = pk.launches = sk.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([command, *flags,
                           "--set", f"model.pallas_conv={mode}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(conv=ck.launches, preprocess=pk.launches,
                          sort=sk.launches)
            if rc != 0 or counts != expected[mode]:
                raise AssertionError(f"{command} ({mode}): rc {rc}, kernel "
                                     f"launches {counts}, expected "
                                     f"{expected[mode]}")
            with open(os.path.join(exp, "cv_scores.json")) as f:
                scores = json.load(f)
            out = {}
            for name in ("out_of_fold_train_predictions",
                         "out_of_fold_test_predictions"):
                with np.load(os.path.join(exp, "outputs", f"{name}.npz"),
                             allow_pickle=True) as z:
                    out[name] = (list(z["ids"]), z["images"][:, 1])
            ids, masks = _csv_masks(os.path.join(exp, "submission.csv"))
            runs[mode] = dict(wall=wall, counts=counts, scores=scores,
                              out=out, ids=ids, masks=masks)
            log("cv", command=command, pallas_conv=mode, wall_s=f"{wall:.3f}",
                folds=n_folds, images=N_CV_IMAGES, test_images=n_test,
                conv_launches=counts["conv"],
                preprocess_launches=counts["preprocess"],
                sort_launches=counts["sort"],
                fold_iout=[round(v, 5) for v in scores["fold_iout"]],
                fold_iou=[round(v, 5) for v in scores["fold_iou"]],
                iout_mean=f"{scores['iout_mean']:.5f}", card=repr(card))
        gate = _cv_int8_gate(exp, flags, card, n_folds, val_batches,
                             test_batches)
    on, off = runs["on"], runs["off"]
    oof_ids, p_on = on["out"]["out_of_fold_train_predictions"]
    oof_ids_off, p_off = off["out"]["out_of_fold_train_predictions"]
    if oof_ids != oof_ids_off or on["ids"] != off["ids"]:
        raise AssertionError("cv: ids differ between the two commands")
    if not (np.isfinite(p_on).all() and len(on["ids"]) == n_test):
        raise AssertionError("cv: non-finite predictions or a short "
                             "submission")
    oof_delta, oof_undecidable = margin_rule(
        "cv out-of-fold masks", p_on, p_off, p_on > 0.5, p_off > 0.5)
    _, t_on = on["out"]["out_of_fold_test_predictions"]
    _, t_off = off["out"]["out_of_fold_test_predictions"]
    test_delta, test_undecidable = margin_rule(
        "cv submission", t_on, t_off, on["masks"], off["masks"])
    for fold in range(n_folds):
        part = slice(fold * n_valid, (fold + 1) * n_valid)
        exact = not (np.abs(p_off[part] - 0.5) <= oof_delta).any()
        a, b = on["scores"]["fold_iout"][fold], off["scores"]["fold_iout"][fold]
        if exact and a != b:
            raise AssertionError(f"cv fold {fold}: IOUT {a} vs {b} with no "
                                 "undecidable pixel")
    log("cv", oof_delta=oof_delta, oof_undecidable_pixels=oof_undecidable,
        test_delta=test_delta, test_undecidable_pixels=test_undecidable,
        submission_pixels_differing=int((on["masks"] != off["masks"]).sum()),
        card=repr(card))
    return on["counts"], off["counts"], gate


def phase_metadata(card):
    """The real-data path from a TGS-layout tree, as a user runs it: the
    port's ``write_synthetic_dataset`` writes N_META_TRAIN train (image,
    mask) and N_META_TEST test PNGs and depths.csv; ``cli
    prepare-metadata`` writes metadata.csv (its column contract checked);
    ``cli train --epochs 1`` trains the flagship (bf16, batch 24) from
    that CSV on the card, fold 0 of 6. The sort kernel launches once per
    train step and validation-loss batch, the preprocess kernel once per
    validation predict and validation-loss batch."""
    import pandas as pd
    import torch
    from salt_tpu_torch import cli
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.data.metadata import COLUMNS
    from salt_tpu_torch.data.synthetic import write_synthetic_dataset
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk

    n_valid = math.ceil(N_META_TRAIN / default_config().execution.n_cv_splits)
    steps = (N_META_TRAIN - n_valid) // TRAIN_BATCH
    val_batches = math.ceil(n_valid / SERVE_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, test_dir, depths = write_synthetic_dataset(
            tmp, n_train=N_META_TRAIN, n_test=N_META_TEST, seed=5)
        csv = os.path.join(tmp, "metadata.csv")
        exp = os.path.join(tmp, "exp")
        paths = ["--set", f"paths.train_images_dir={train_dir}",
                 "--set", f"paths.test_images_dir={test_dir}",
                 "--set", f"paths.depths_filepath={depths}",
                 "--set", f"paths.metadata_filepath={csv}",
                 "--set", f"paths.experiment_dir={exp}"]
        t0 = time.perf_counter()
        rc = cli.main(["prepare-metadata", *paths])
        meta_s = time.perf_counter() - t0
        meta = pd.read_csv(csv)
        train = meta[meta["is_train"] == 1]
        if (rc != 0 or list(meta.columns) != COLUMNS
                or len(train) != N_META_TRAIN
                or len(meta) != N_META_TRAIN + N_META_TEST
                or train["size"].isna().any()
                or not meta[meta["is_train"] == 0]["size"].isna().all()):
            raise AssertionError(f"prepare-metadata: rc {rc}, columns "
                                 f"{list(meta.columns)}, {len(meta)} rows")
        pk.launches = sk.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["train", "--epochs", "1", *paths,
                       "--set", f"training.batch_size_train={TRAIN_BATCH}",
                       "--set",
                       f"training.batch_size_inference={SERVE_BATCH}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = dict(preprocess=pk.launches, sort=sk.launches)
        want = dict(preprocess=2 * val_batches, sort=steps + val_batches)
        best = os.path.join(exp, "checkpoints", "network", "best.npz")
        if rc != 0 or counts != want or not os.path.exists(best):
            raise AssertionError(f"train from metadata.csv: rc {rc}, kernel "
                                 f"launches {counts}, expected {want}, "
                                 f"best.npz {os.path.exists(best)}")
        with open(os.path.join(exp, "channels_network.jsonl")) as f:
            epoch = json.loads(f.readline())
    if not math.isfinite(epoch["train_loss"]):
        raise AssertionError(f"train from metadata.csv: {epoch}")
    log("metadata", rows=len(meta), train=N_META_TRAIN, test=N_META_TEST,
        empty_masks=int((train["size"] == 0).sum()),
        prepare_s=f"{meta_s:.3f}", train_s=f"{train_s:.3f}",
        train_loss=f"{epoch['train_loss']:.5f}",
        preprocess_launches=counts["preprocess"],
        sort_launches=counts["sort"], card=repr(card))
    return counts


def phase_serve_synthetic(dev, card):
    """``serve --synthetic`` as bench.py measures serve: the flagship
    (bf16, hflip TTA, batch BENCH_BATCH) with no checkpoint, so the
    runner's seeded initial weights, over N_SERVE_IMAGES generated images
    held in memory. The preprocess kernel launches once per forward batch
    (timed and warm-up); the submission holds every generated id."""
    import numpy as np
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.pipeline.serving import serve

    cfg = default_config()
    cfg.training.batch_size_inference = BENCH_BATCH
    cfg.postpro.use_tta = True
    with tempfile.TemporaryDirectory() as tmp:
        out_csv = os.path.join(tmp, "submission.csv")
        pk.launches = 0
        t0 = time.perf_counter()
        result = serve(cfg, "", "", out_csv, synthetic=N_SERVE_IMAGES,
                       device=dev)
        wall = time.perf_counter() - t0
        launches = pk.launches
        ids, masks = _csv_masks(out_csv)
    want_ids = synthetic_bundle(N_SERVE_IMAGES, seed=cfg.execution.seed,
                                with_masks=False).meta["id"].tolist()
    if ids != want_ids or masks.shape != (N_SERVE_IMAGES, 101, 101):
        raise AssertionError("serve --synthetic: ids or masks")
    n_batches = math.ceil(N_SERVE_IMAGES / BENCH_BATCH)
    if result["batches"] != n_batches:
        raise AssertionError(f"serve --synthetic ran {result['batches']} "
                             f"batches, expected {n_batches}")
    if launches != result["batches"] + result["warmup_batches"]:
        raise AssertionError(
            f"preprocess kernel launched {launches} times for "
            f"{result['batches']} + {result['warmup_batches']} warm-up "
            "batches")
    log("serve_synthetic", images=N_SERVE_IMAGES, batch=BENCH_BATCH,
        tta="hflip", dtype=cfg.training.dtype, weights="seeded (init_state)",
        images_per_s=result["images_per_sec"],
        timed_s=f"{result['seconds']:.3f}", wall_s=f"{wall:.3f}",
        batches=result["batches"], warmup_batches=result["warmup_batches"],
        preprocess_launches=launches,
        salt_fraction=f"{float(np.mean(masks)):.4f}", card=repr(card))
    return launches


def phase_salt_unet(dev, card):
    """SaltUNet (16 filters, 4 levels) through the command line at the
    train path's sizes: ``train --synthetic N_TRAIN_IMAGES --epochs 2``
    (bf16, batch 24, Lovász, the validation image monitor every epoch),
    ``--resume`` for a third epoch, ``serve --synthetic`` from its
    experiment directory. The sort kernel launches once per train step
    and validation-loss batch, the preprocess kernel once per validation
    predict and validation-loss batch, once per monitor grid and once per
    served batch. Then the trained weights' forward: fp32 on the card
    against the CPU at rtol=atol=2e-3 and bf16 against fp32 on the card
    by the model phase's rule."""
    import numpy as np
    import torch
    from PIL import Image
    from salt_tpu_torch import cli
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import load_flat_npz
    from salt_tpu_torch.models.convert import load_flax_flat
    from salt_tpu_torch.models.registry import build_model
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.ops.preprocess import preprocess_inference

    cfg = default_config()
    n_valid = math.ceil(N_TRAIN_IMAGES / cfg.execution.n_cv_splits)
    steps = (N_TRAIN_IMAGES - n_valid) // TRAIN_BATCH
    val_batches = math.ceil(n_valid / cfg.training.batch_size_inference)
    monitor_batches = math.ceil(cfg.training.validation_image_nr
                                / cfg.training.batch_size_inference)
    counts = dict(preprocess=0, sort=0)
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp")
        flags = ["--synthetic", str(N_TRAIN_IMAGES),
                 "--set", f"paths.experiment_dir={exp}",
                 "--set", "model.architecture=SaltUNet",
                 "--set", f"model.n_filters={SALT_UNET_FILTERS}",
                 "--set", f"model.repeat_blocks={SALT_UNET_LEVELS}",
                 "--set", "training.loss=lovasz",
                 "--set", "training.validation_images_every=1"]
        for epochs, resume in ((TRAIN_EPOCHS, []),
                               (TRAIN_EPOCHS + 1, ["--resume"])):
            pk.launches = sk.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["train", *flags, "--epochs", str(epochs),
                           *resume])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = epochs - (TRAIN_EPOCHS if resume else 0)
            got = dict(preprocess=pk.launches, sort=sk.launches)
            want = dict(preprocess=ran * (2 * val_batches + monitor_batches),
                        sort=ran * (steps + val_batches))
            if rc != 0 or got != want:
                raise AssertionError(f"SaltUNet train {resume}: rc {rc}, "
                                     f"kernel launches {got}, expected {want}")
            for key in counts:
                counts[key] += got[key]
            with open(os.path.join(exp, "channels_network.jsonl")) as f:
                epoch_log = [json.loads(line) for line in f]
            pngs = sorted(os.listdir(os.path.join(
                exp, "validation_images_network")))
            log("salt_unet", command="train" + (" --resume" if resume
                                                else ""),
                epochs_run=ran, wall_s=f"{wall:.3f}",
                sort_launches=got["sort"],
                preprocess_launches=got["preprocess"],
                train_loss=[round(e["train_loss"], 5) for e in epoch_log],
                val_iout=[round(e["iout"], 5) for e in epoch_log],
                pngs=len(pngs), card=repr(card))
        if ([e["epoch"] for e in epoch_log] != list(range(TRAIN_EPOCHS + 1))
                or not all(math.isfinite(e["train_loss"]) for e in epoch_log)
                or pngs != [f"validation_epoch_{i:04d}.png"
                            for i in range(TRAIN_EPOCHS + 1)]):
            raise AssertionError(f"SaltUNet epochs {epoch_log}, PNGs {pngs}")
        grid = np.asarray(Image.open(os.path.join(
            exp, "validation_images_network", pngs[-1])))
        if grid.shape != (cfg.training.validation_image_nr * 101, 3 * 101):
            raise AssertionError(f"monitor grid {grid.shape}")

        out_csv = os.path.join(tmp, "submission.csv")
        n_serve = 512
        pk.launches = 0
        rc = cli.main(["serve", "--checkpoint", exp, "--synthetic",
                       str(n_serve), "--out", out_csv])
        served = pk.launches
        batches = math.ceil(n_serve / cfg.training.batch_size_inference)
        ids, _ = _csv_masks(out_csv)
        if rc != 0 or len(ids) != n_serve or served != 2 * batches:
            raise AssertionError(f"SaltUNet serve: rc {rc}, {len(ids)} rows, "
                                 f"{served} preprocess launches")
        counts["preprocess"] += served
        best = load_flat_npz(os.path.join(exp, "checkpoints", "network",
                                          "best.npz"))
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = SALT_UNET_FILTERS
    cfg.model.repeat_blocks = SALT_UNET_LEVELS
    model = load_flax_flat(build_model(cfg.model), best)
    x = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        cpu = model(x)
        model = model.to(dev, memory_format=torch.channels_last)
        fp32 = model(x.to(dev))
        model.set_compute_dtype(torch.bfloat16)
        bf16 = model(x.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(fp32.cpu(), cpu, rtol=2e-3, atol=2e-3)
    scale = float(fp32.abs().max())
    err16 = float((bf16 - fp32).abs().max())
    if not (torch.isfinite(bf16).all() and err16 <= 0.1 * scale):
        raise AssertionError(f"SaltUNet bf16 vs fp32 logits: max err {err16},"
                             f" logit scale {scale}")
    log("salt_unet", serve_images=n_serve, serve_preprocess_launches=served,
        params=sum(p.numel() for p in model.parameters()),
        fp32_vs_cpu=float((fp32.cpu() - cpu).abs().max()),
        bf16_vs_fp32=err16, logit_scale=scale, card=repr(card))
    return counts


#: the losses ported in this slice of the port, held on the card
NEW_LOSSES = ("dice", "mixed_dice_bce", "mixed_dice_ce", "focal",
              "focal_weighted")


def phase_losses(dev):
    """Each of NEW_LOSSES and its gradient with respect to the logits on
    the card against the CPU, fp32, at a train batch's shape (24 NHWC
    128 x 128 x 2 logits, one-hot targets of disc masks, one image empty
    and one full): rtol 1e-4 on the value and on each gradient element
    plus 1e-6 of the gradient's largest magnitude (the two devices sum
    the 786,432 terms of a mean in different orders)."""
    import numpy as np
    import torch
    from salt_tpu_torch.losses.api import get_loss_fn
    rng = np.random.RandomState(8)
    logits = torch.from_numpy(
        (3 * rng.randn(TRAIN_BATCH, 128, 128, 2)).astype(np.float32))
    yy, xx = np.mgrid[:128, :128]
    masks = np.zeros((TRAIN_BATCH, 128, 128), np.float32)
    for i in range(2, TRAIN_BATCH):
        cy, cx, r = rng.rand(3) * (128, 128, 40)
        masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < (r + 4) ** 2] = 1.0
    masks[1] = 1.0
    target = torch.from_numpy(np.stack([1 - masks, masks], axis=-1))
    for name in NEW_LOSSES:
        fn = get_loss_fn(name)
        out = {}
        for d in (dev, torch.device("cpu")):
            x = logits.to(d, copy=True).requires_grad_(True)
            value = fn(x, target.to(d))
            value.backward()
            out[d.type] = (value.detach().cpu(), x.grad.cpu())
        (v_card, g_card), (v_cpu, g_cpu) = out["cuda"], out["cpu"]
        torch.testing.assert_close(v_card, v_cpu, rtol=1e-4, atol=0)
        g_scale = float(g_cpu.abs().max())
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-4,
                                   atol=1e-6 * g_scale)
        log("losses", loss=name, value=float(v_cpu),
            value_err=float((v_card - v_cpu).abs()),
            grad_max_abs_err=float((g_card - g_cpu).abs().max()),
            grad_scale=g_scale)


FP_IMAGES = 480                   # 6 folds of 400 train / 80 valid
FP_TIMED_STEPS = 3


def _fp_fold_data(bundle, n_folds):
    from salt_tpu_torch.core.experiment import add_fold_suffix
    from salt_tpu_torch.data.kfold import KFoldBySortedValue
    cv = KFoldBySortedValue(n_splits=n_folds)
    fold_train, fold_valid, names = [], [], []
    for i, (tr, va) in enumerate(cv.split(bundle.meta["z"].values)):
        t, v = bundle.take(tr), bundle.take(va)
        fold_train.append((t.images, t.masks, None))
        fold_valid.append((v.images, v.masks, None))
        names.append(add_fold_suffix("network", i))
    return fold_train, fold_valid, names


def _fp_aligned(dev, card, dtype, batch, tol):
    """One aligned fold-parallel step (every fold from the same init,
    each its own batch of ``batch``, the sequential step's draws) against
    the sequential ``train_step`` of each fold on its batch from that
    init with those draws: each fold's loss (relative), every Adam step
    over lr and the BN statistics and, where ``tol["grad"]`` is set,
    every gradient leaf of each fold (the step's vmapped half,
    ``FoldParallelRunner.grads``, on the step's network inputs) within
    that share of the leaf's max. ``dtype`` "float64" is the fp32
    configuration with every network cast to float64 after its optimizer
    is built, as ``phase_train_step`` casts it. Returns the sort's
    launches (one a step, two with the gradients)."""
    import torch
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.parallel.fold_parallel import FoldParallelRunner
    cfg = default_config()
    cfg.training.dtype = "float32" if dtype == "float64" else dtype
    k, seed, lr = cfg.execution.n_cv_splits, cfg.execution.seed, \
        cfg.training.lr

    def network(model):
        if dtype == "float64":
            model.to(torch.float64)
            model.compute_dtype = torch.float64
        return model

    fp = FoldParallelRunner(cfg, k, dev)
    runner = fp.runner
    states = fp.stack([network(runner.init_state(seed).model)
                       for _ in range(k)])
    images = seeded_images(k * batch, seed=41).reshape(k, batch, 101, 101)
    di, dm = fp.shard_fold_batch(images, (images > 140).astype("uint8"))
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = fp.draw(gen, batch, aligned=True)
    sk.launches = 0
    grads = None
    if tol["grad"] is not None:
        x, y = runner._train_inputs(di.reshape(k * batch, 101, 101),
                                    dm.reshape(k * batch, 101, 101),
                                    draws[0])
        _, flat, _ = fp.grads(states, x.reshape(k, batch, *x.shape[1:]),
                              y.reshape(k, batch, *y.shape[1:]), draws[1])
        grads = [states._views(flat, states.param_layout, i)
                 for i in range(k)]
    grad_launches = sk.launches
    loss = fp.train_step(states, di, dm, draws, [True] * k).cpu()
    torch.cuda.synchronize()
    sort_launches = sk.launches - grad_launches
    if sort_launches != 1:
        raise AssertionError(f"fold-parallel step: {sort_launches} sort "
                             "launches, not 1")
    worst = dict(loss=0.0, grad=0.0, step=0.0, bn=0.0)
    for i in range(k):
        state = runner.init_state(seed)
        network(state.model)
        gen.manual_seed(7)
        seq_loss = float(runner.train_step(state, di[i], dm[i], gen))
        fold = states.fold(i).model
        worst["loss"] = max(worst["loss"], abs(float(loss[i]) - seq_loss)
                            / max(abs(seq_loss), 1e-30))
        for (name, p), q in zip(state.model.named_parameters(),
                                fold.parameters()):
            worst["step"] = max(worst["step"], float(
                (p.detach().double() - q.detach().double()).abs().max())
                / lr)
            if grads is not None:
                g = p.grad.double()
                worst["grad"] = max(worst["grad"], float(
                    (grads[i][name].double() - g).abs().max())
                    / (float(g.abs().max()) + 1e-30))
        for (name, b), c in zip(state.model.named_buffers(), fold.buffers()):
            if b.is_floating_point():
                worst["bn"] = max(worst["bn"], float(
                    (b.double() - c.double()).abs().max()))
        del state
    log("fold_parallel", check="aligned step vs sequential", folds=k,
        batch=batch, dtype=dtype, loss_rel_err=f"{worst['loss']:.3e}",
        worst_grad_leaf_err_of_max=(f"{worst['grad']:.3e}" if grads
                                    is not None else "not compared"),
        step_max_diff_over_lr=f"{worst['step']:.3e}",
        bn_stats_max_err=f"{worst['bn']:.3e}", losses=[
            round(float(v), 5) for v in loss], card=repr(card))
    if any(tol[key] is not None and worst[key] > tol[key] for key in worst):
        raise AssertionError(f"aligned fold-parallel {dtype} vs sequential:"
                             f" {worst} over {tol}")
    return sort_launches + grad_launches


def _fp_timing(dev, card):
    """One fold-parallel step of the six folds (bf16, batch 24 each)
    beside six sequential steps, after two warm-up calls each. Over
    three synchronized windows of FP_TIMED_STEPS calls: the wall ms and
    the CUDA events' ms (the card's timeline from the window's first
    kernel to its last, idle gaps included, so the wall caps it), both
    of the window with the least wall time. Then one profiler session of
    FP_TIMED_STEPS calls, with its own wall and events ms: the time in
    which any recorded device event ran (``tools/profiling.busy_us``, the
    union of their intervals) a call and its share of that session's
    events ms, the recorded durations summed (above the union where
    kernels of more than one stream overlap), the streams and events
    recorded, and the top kernels by their summed durations. Nothing is
    extrapolated from the events the profiler kept (at some 5,000
    launches a call it may lose some), so the busy time is a lower
    estimate. Returns the sort's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.parallel.fold_parallel import FoldParallelRunner
    from salt_tpu_torch.tools.profiling import busy_us, device_events
    cfg = default_config()
    k = cfg.execution.n_cv_splits
    fp = FoldParallelRunner(cfg, k, dev)
    states = fp.init_states(cfg.execution.seed)
    images = seeded_images(k * TRAIN_BATCH, seed=43).reshape(
        k, TRAIN_BATCH, 101, 101)
    di, dm = fp.shard_fold_batch(images, (images > 140).astype("uint8"))
    gen = torch.Generator(device=dev)
    seq = [fp.runner.init_state(cfg.execution.seed + i) for i in range(k)]

    def parallel_step(i):
        gen.manual_seed(i)
        return fp.train_step(states, di, dm, fp.draw(gen, TRAIN_BATCH),
                             [True] * k)

    def sequential_steps(i):
        for f in range(k):
            gen.manual_seed(i * k + f)
            fp.runner.train_step(seq[f], di[f], dm[f], gen)

    sk.launches = 0
    out = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, fn in (("parallel", parallel_step),
                     ("sequential6", sequential_steps)):
        for i in range(2):
            fn(i)
        windows = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for i in range(FP_TIMED_STEPS):
                fn(i)
            end.record()
            torch.cuda.synchronize()
            windows.append(((time.perf_counter() - t0) * 1e3
                            / FP_TIMED_STEPS,
                            start.elapsed_time(end) / FP_TIMED_STEPS))
        wall_ms, events_ms = min(windows)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for i in range(FP_TIMED_STEPS):
                fn(i)
            end.record()
            torch.cuda.synchronize()
            profiled_wall_ms = ((time.perf_counter() - t0) * 1e3
                                / FP_TIMED_STEPS)
            profiled_events_ms = start.elapsed_time(end) / FP_TIMED_STEPS
        kept = device_events(prof.events())
        by_name = {}
        for e in kept:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3
                               / FP_TIMED_STEPS)
        busy_ms = busy_us(kept) / 1e3 / FP_TIMED_STEPS
        summed_ms = sum(by_name.values())
        streams = len({getattr(e, "device_resource_id", None)
                       for e in kept})
        sort_ms = sum(v for n, v in by_name.items()
                      if sk.KERNEL_PREFIX in n)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[name] = dict(wall_ms=wall_ms, events_ms=events_ms)
        log("fold_parallel", timing=name, folds=k, batch=TRAIN_BATCH,
            dtype=cfg.training.dtype, wall_ms=f"{wall_ms:.3f}",
            events_ms=f"{events_ms:.3f}",
            profiled_wall_ms=f"{profiled_wall_ms:.3f}",
            profiled_events_ms=f"{profiled_events_ms:.3f}",
            busy_ms=f"{busy_ms:.3f}",
            busy_share=f"{busy_ms / profiled_events_ms:.3f}",
            durations_summed_ms=f"{summed_ms:.3f}", streams=streams,
            events_recorded_per_step=len(kept) / FP_TIMED_STEPS,
            sort_ms_recorded=f"{sort_ms:.4f}",
            top_recorded=[(n[:60], round(v, 3)) for n, v in top],
            card=repr(card))
    launches = sk.launches
    if launches != (2 + 4 * FP_TIMED_STEPS) * (1 + k):
        raise AssertionError(f"timing: {launches} sort launches")
    par, seq6 = out["parallel"], out["sequential6"]
    log("fold_parallel", timing="one fold-parallel step vs six sequential",
        wall_ratio=f"{par['wall_ms'] / seq6['wall_ms']:.3f}",
        events_ratio=f"{par['events_ms'] / seq6['events_ms']:.3f}",
        card=repr(card))
    return launches


def phase_fold_parallel(dev, card):
    """``parallel.fold_parallel``: the K = 6 folds of the flagship
    (UNetResNet34, bf16, batch 24 each, conv kernel "on") trained as one
    vmapped step, through the command a user runs: ``cli
    train-evaluate-predict-cv --set parallel.fold_parallel=true`` on
    FP_IMAGES synthetic images (6 folds of 400 / 80, 1 epoch, the CLI's
    120 test images). Its fit: the sort kernel launched once per
    fold-parallel step over K x 24 rows (not K times), the preprocess
    kernel once and the conv kernel 14 times per validation batch; then
    the CV loop's evaluation half from each fold's ``best.npz`` (each
    fold's validation and the test set); each fold's epoch loss finite,
    the folds' weights distinct, ``cv_scores.json`` and
    ``submission.csv`` written, each ``best.npz`` restored by
    ``SegmentationRunner`` and served. Then the aligned step against the
    sequential step of each fold, at ``phase_train_step``'s tolerances:
    float64 (batch 2 a fold) with the loss within 1e-6 relative, every
    gradient leaf of every fold within 1e-6 of its max, every Adam step
    within 1e-3 lr and BN statistics within 1e-9 (a gradient that mixed
    folds' rows, or a wrong per-fold Adam, fails here: after one step
    every element moves by about lr, so the step check alone holds only
    the sign); fp32 (TF32 off, batch 8 a fold) with the loss within 1e-4
    relative, every Adam step within 2.001 lr and BN statistics 1e-4;
    bf16 with the loss within 3e-3 relative (under the 1.9% spread of
    the folds' own losses; bf16 rounds each conv's output to 8 bits, and
    the grouped conv of the mapped step sums in another order), steps
    within 2.001 lr and BN statistics within 2e-2; and the time of one
    fold-parallel step beside six sequential steps. Returns the kernels'
    launches."""
    import numpy as np
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import load_flat_npz
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.ops import costs
    from salt_tpu_torch.train.steps import SegmentationRunner

    cfg = default_config()                    # UNetResNet34, bf16, 6 folds
    cfg.model.pallas_conv = "on"
    k = cfg.execution.n_cv_splits
    bundle = synthetic_bundle(FP_IMAGES, seed=cfg.execution.seed)
    fold_train, fold_valid, names = _fp_fold_data(bundle, k)
    steps = min(len(t[0]) for t in fold_train) // TRAIN_BATCH
    bs = cfg.training.batch_size_inference
    val_batches = sum(math.ceil(len(v[0]) / bs) for v in fold_valid)
    test_batches = k * math.ceil(max(FP_IMAGES // 4, 8) / bs)
    forwards = 2 * val_batches + test_batches  # fit + evaluation half
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp")
        _fs_reset()
        with costs.recording() as launched:
            t0 = time.perf_counter()
            rc = cli_main(["train-evaluate-predict-cv", "--synthetic",
                           str(FP_IMAGES), "--epochs", "1",
                           "--set", f"paths.experiment_dir={exp}",
                           "--set", "parallel.fold_parallel=true",
                           "--set", "model.pallas_conv=on"])
            wall = time.perf_counter() - t0
        counts = _fs_counts()
        sort_rows = [c.shape[0] for c in launched
                     if c.kernel == "bitonic_sort"]
        want = dict(preprocess=forwards, sort=steps,
                    conv=CONV_KERNEL_PER_FORWARD * forwards)
        if (rc != 0 or counts != want
                or sort_rows != [k * TRAIN_BATCH] * steps):
            raise AssertionError(f"fold-parallel CV: rc {rc}, launches "
                                 f"{counts} (sort rows {sort_rows}), "
                                 f"expected {want} and {steps} sorts of "
                                 f"{k * TRAIN_BATCH} rows")
        epochs = []
        for name in names:
            with open(os.path.join(exp, f"channels_{name}.jsonl")) as f:
                epochs.append([json.loads(line) for line in f][-1])
        losses = [e["train_loss"] for e in epochs]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"fold losses {losses}")
        best = [load_flat_npz(os.path.join(exp, "checkpoints", name,
                                           "best.npz")) for name in names]
        key = sorted(best[0])[0]
        if any(np.array_equal(best[0][key], b[key]) for b in best[1:]):
            raise AssertionError("two folds' weights are equal")
        with open(os.path.join(exp, "cv_scores.json")) as f:
            scores = json.load(f)
        with open(os.path.join(exp, "submission.csv")) as f:
            rows = len(f.read().splitlines())
        if len(scores["fold_iout"]) != k or rows != max(FP_IMAGES // 4,
                                                        8) + 1:
            raise AssertionError(f"cv_scores {scores}, {rows} CSV lines")
        runner = SegmentationRunner(cfg, dev)
        for i, b in enumerate(best):
            probs = runner.predict_dataset(runner.restore(b),
                                           fold_valid[i][0][:24])
            if probs.shape != (24, 2, 101, 101) or not np.isfinite(
                    probs).all():
                raise AssertionError(f"{names[i]} best.npz served "
                                     f"{probs.shape}")
    log("fold_parallel", command="train-evaluate-predict-cv --set "
        "parallel.fold_parallel=true", folds=k, images=FP_IMAGES,
        batch=TRAIN_BATCH, dtype=cfg.training.dtype, steps=steps,
        wall_s=f"{wall:.3f}", train_loss=[round(v, 5) for v in losses],
        val_iout=[round(e["iout"], 5) for e in epochs],
        fold_iout=[round(v, 5) for v in scores["fold_iout"]],
        sort_rows_per_launch=k * TRAIN_BATCH, **counts, card=repr(card))
    counts["sort"] += _fp_aligned(dev, card, "float64", 2,
                                  dict(loss=1e-6, grad=1e-6, step=1e-3,
                                       bn=1e-9))
    counts["sort"] += _fp_aligned(dev, card, "float32", 8,
                                  dict(loss=1e-4, grad=None, step=2.001,
                                       bn=1e-4))
    counts["sort"] += _fp_aligned(dev, card, "bfloat16", TRAIN_BATCH,
                                  dict(loss=3e-3, grad=None, step=2.001,
                                       bn=2e-2))
    counts["sort"] += _fp_timing(dev, card)
    return counts


def cli_main(argv):
    """``cli.main(argv)``, the device synchronized after it."""
    import torch
    from salt_tpu_torch import cli
    rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc


def phase_tooling(dev, card):
    """The step tooling through the command line: ``cli train
    --trace-steps --profile DIR`` of the flagship at batch 24 (96
    synthetic images, 1 epoch): the five phases in
    ``channels_trace.jsonl``, and a Chrome trace in which
    ``tools/profiling.read_trace`` finds the sort kernel; then ``cli
    cost-analysis`` of the flagship (bf16, batch 24, hflip TTA, conv
    kernel "on"): the train, predict and TTA steps, each with FLOPs and a
    temp high-water mark above 0. Returns the kernels' launches."""
    from salt_tpu_torch import cli
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.tools.profiling import read_trace
    from salt_tpu_torch.train.trace import PHASES
    total = dict(preprocess=0, sort=0, conv=0)
    with tempfile.TemporaryDirectory() as tmp:
        exp, prof = os.path.join(tmp, "exp"), os.path.join(tmp, "prof")
        _fs_reset()
        rc = cli.main(["train", "--synthetic", "96", "--epochs", "1",
                       "--trace-steps", "--profile", prof,
                       "--set", f"paths.experiment_dir={exp}"])
        counts = _fs_counts()
        if rc != 0:
            raise AssertionError(f"train --trace-steps --profile: rc {rc}")
        with open(os.path.join(exp, "channels_trace.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        phases = {line["phase"]: line["ms"] for line in lines}
        if (set(phases) != set(PHASES) or len(lines) != len(PHASES)
                or any(line["batch_size"] != TRAIN_BATCH for line in lines)
                or min(phases[p] for p in PHASES if p != "bwd_opt") <= 0):
            raise AssertionError(f"channels_trace.jsonl: {lines}")
        sorts = read_trace(os.path.join(prof, "trace.json"), sk.KERNEL_PREFIX)
        if not sorts:
            raise AssertionError("the --profile trace holds no sort kernel")
        log("tooling", command="train --trace-steps --profile", batch=
            TRAIN_BATCH, **{f"{p}_ms": phases[p] for p in PHASES},
            trace_sort_kernels=len(sorts),
            trace_sort_launches=sum(v["launches"] for v in sorts.values()),
            trace_sort_us=f"{sum(v['us'] for v in sorts.values()):.1f}",
            **counts, card=repr(card))
        for key in total:
            total[key] += counts[key]

        exp2 = os.path.join(tmp, "cost")
        _fs_reset()
        rc = cli.main(["cost-analysis",
                       "--set", f"paths.experiment_dir={exp2}",
                       "--set", "postpro.use_tta=true",
                       "--set", "model.pallas_conv=on"])
        counts = _fs_counts()
        with open(os.path.join(exp2, "cost_analysis.json")) as f:
            analyses = json.load(f)
        steps = ("train_step", "predict_step", "predict_tta_step")
        if rc != 0 or set(analyses) != set(steps) or any(
                not analyses[s]["temp_bytes"] or analyses[s]["flops"] <= 0
                for s in steps):
            raise AssertionError(f"cost-analysis: rc {rc}, {analyses}")
        for s in steps:
            a = analyses[s]
            log("tooling", command="cost-analysis", step=s,
                gflops=a["gflops"],
                gb_moved=f"{a['bytes_accessed'] / 1e9:.3f}",
                flop_per_byte=a["arithmetic_intensity"],
                ideal_ms_flop=a["ideal_ms_flop_bound"],
                ideal_ms_bytes=a["ideal_ms_bw_bound"], bound=a["bound"],
                temp_mb=f"{a['temp_bytes'] / 1e6:.1f}",
                hand_kernels={n: v["launches"]
                              for n, v in a["hand_kernels"].items()},
                card=repr(card))
        for key in total:
            total[key] += counts[key]
    return total


def phase_data_parallel(dev, card):
    """``parallel/mesh.py`` on the card: a process group of one rank on
    NCCL (tcp://localhost), one data-parallel train step of the flagship
    (fp32, TF32 off, batch 24: BatchNorm's sums and the gradients
    all-reduced through NCCL) against the plain step from the same
    weights and draws, at ``phase_train_step``'s fp32 tolerances (loss
    1e-4, every Adam step within 2.001 lr, BN statistics 1e-4). Returns
    the sort's launches."""
    import torch
    import torch.distributed as dist
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.parallel.mesh import (data_parallel_train_step,
                                              init_process_group)
    from salt_tpu_torch.train.steps import SegmentationRunner
    mesh = init_process_group(0, 1, device="cuda")
    try:
        if mesh.backend != "nccl" or mesh.size != 1:
            raise AssertionError(f"process group {mesh}")
        cfg = default_config()
        cfg.training.dtype = "float32"
        lr = cfg.training.lr
        runner = SegmentationRunner(cfg, dev)
        images = seeded_images(TRAIN_BATCH, seed=47)
        imgs, masks = runner.device_batch(images,
                                          (images > 140).astype("uint8"))
        gen = torch.Generator(device=dev)
        plain, dp = runner.init_state(0), runner.init_state(0)
        gen.manual_seed(5)
        loss_plain = float(runner.train_step(plain, imgs, masks, gen))
        gen.manual_seed(5)
        sk.launches = 0
        loss_dp = float(data_parallel_train_step(runner, dp, imgs, masks,
                                                 gen, mesh))
        torch.cuda.synchronize()
        launches = sk.launches
        step = max(float((a.detach().double() - b.detach().double())
                         .abs().max()) for a, b in
                   zip(plain.model.parameters(), dp.model.parameters())) / lr
        bn = max(float((a.double() - b.double()).abs().max()) for a, b in
                 zip(plain.model.buffers(), dp.model.buffers())
                 if a.is_floating_point())
    finally:
        dist.destroy_process_group()
    log("data_parallel", backend="nccl", world_size=1, batch=TRAIN_BATCH,
        dtype="float32", loss_plain=loss_plain, loss_dp=loss_dp,
        loss_err=abs(loss_plain - loss_dp),
        step_max_diff_over_lr=f"{step:.3e}", bn_stats_max_err=f"{bn:.3e}",
        sort_launches=launches, card=repr(card))
    if (abs(loss_plain - loss_dp) > 1e-4 or step > 2.001 or bn > 1e-4
            or launches != 1):
        raise AssertionError(f"data-parallel step vs plain: loss "
                             f"{loss_plain} / {loss_dp}, step {step} lr, BN "
                             f"{bn}, {launches} sort launches")
    return launches


def phase_bench(card):
    """``python -m salt_tpu_torch.tools.bench`` at reduced windows (it
    prints its line; its keys and rates are checked). The TTA steps launch
    the preprocess kernel, the int8 TTA step and the int8 serve the int8
    kernels (INT8_CONV_PER_FORWARD convs a forward, INT8_WGMMA_PER_FORWARD
    of them on the wgmma kernel, each after two quantize calls; the
    profiled int8 step reads both conv kernels) and the train steps the
    sort kernel; with no distill curve under its ``--distill-root`` the
    line holds no student context. Returns their launches and the line's
    ``flagship_tta_int8`` images/s."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.tools import bench
    pk.launches = sk.launches = 0
    _int8_reset()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as no_curve:
        line = bench.main(["--iters", "10", "--windows", "2",
                           "--train-iters", "5", "--profile-steps", "3",
                           "--distill-root", no_curve])
    wall = time.perf_counter() - t0
    counts = dict(_int8_counts(), preprocess=pk.launches, sort=sk.launches)
    int8_forwards = counts["int8_conv"] // INT8_CONV_PER_FORWARD
    rates = ("flagship_tta_bf16", "flagship_tta_int8", "flagship_train",
             "salt_unet16_tta", "serve_synthetic_2048")
    steps = line["breakdown"]
    # the int8 launches are exact in the counters (a profiler session may
    # lose a few events of the step's 57 + 228)
    if (not all(line[k]["value"] > 0 for k in rates)
            or line["flagship_tta_int8"]["quant_bits"] != 8
            or steps["tta_step"]["kernels"]["preprocess_inference_kernel"][
                "launches_per_step"] != 1
            or not all(steps["tta_step_int8"]["kernels"][k][
                "launches_per_step"] > 0 for k in ("int8_conv_wgmma_kernel",
                                                   "int8_conv_kernel"))
            or counts["int8_conv"] % INT8_CONV_PER_FORWARD
            or {k: counts[k] for k in _int8_want(0)} != _int8_want(
                int8_forwards)
            or not steps["train_step"]["kernels"][bench.KERNEL_PREFIX][
                "launches_per_step"] > 0
            or not all(counts.values())):
        raise AssertionError(f"bench line {line}, launches {counts}")
    for name in ("tta_step", "tta_step_int8"):
        b = steps[name]
        log("bench_step", step=name, batch=b["batch"],
            wall_ms=f"{b['wall_ms']:.3f}", device_ms=f"{b['device_ms']:.3f}",
            busy_share=f"{b['busy_share']:.3f}",
            launches_per_step=b["launches_per_step"],
            device_launches_per_step=b["device_launches_per_step"],
            kernels={k: (round(v["ms_per_step"], 4), v["launches_per_step"])
                     for k, v in b["kernels"].items()},
            top=[(t["kernel"][:50], t["calls_per_step"],
                  round(t["ms_per_step"], 3)) for t in b["top"][:6]],
            card=repr(card))
    if any(k.startswith(("distill", "serve_student")) for k in line):
        raise AssertionError(f"bench line without a curve: {sorted(line)}")
    log("bench", wall_s=f"{wall:.3f}", card=repr(card),
        **{f"{k}_launches": v for k, v in counts.items()},
        **{k: f"{line[k]['value']:.1f}" for k in rates})
    return counts, line["flagship_tta_int8"]["value"]


#: the arch phase's architectures: (name, encoder_depth, the conv kernel's
#: launches per infer forward at 128x128 under the JAX dispatch's rules:
#: the three layer1 3x3 64 -> 64 conv2s of a bottleneck ResNet; the
#: flagship trunk's 6 encoder and 3 dec2 convs for the depth net, whose
#: final_conv sees 320 channels; none in SE-ResNeXt (32 groups of 4) or
#: DenseNet (growth 32))
ARCH_CELLS = (("UNetSeResNet", 50, 3), ("UNetSeResNetXt", 50, 0),
              ("UNetDenseNet", 121, 0), ("UNetResNet", 50, 3),
              ("UNetResNetWithDepth", 34, 9))
ARCH_TRAIN = ("UNetSeResNet", "UNetResNetWithDepth")
N_ARCH_TTA = 64                   # hflip-TTA masks, card bf16 vs CPU fp32
#: the arch phase's U-Nets take 16 (their CPU fp32 references took 20-40
#: s each at 64, and 30-35 s at 32 for the three bottleneck U-Nets on a
#: slow host, which held the whole run near 900 s of its 1,200)
N_ARCH_TTA_UNETS = 16
N_ARCH_SERVE = 480                # serve --synthetic, batch 24
N_ARCH_TRAIN = 144                # fold 0 of 6: 120 train / 24 valid


def _arch_config(arch, depth):
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()                 # bf16, batch 24, hflip TTA
    cfg.model.architecture = arch
    cfg.model.encoder_depth = depth
    cfg.model.pallas_conv = "on"
    cfg.postpro.use_tta = True
    return cfg


def _arch_forward(dev, card, arch, depth, per_forward, n_tta=N_ARCH_TTA):
    """One architecture from seeded weights: fp32 logits on the card (TF32
    off) against the CPU at batch 2, in both forms, at rtol=atol=2e-3;
    hflip-TTA probabilities of ``n_tta`` synthetic images (with their
    depths) in bf16 through the conv kernel on the card against fp32 on
    the CPU, masks under the threshold-margin rule at the CPU
    probabilities' median (seeded weights leave nearly every pixel on one
    side of 0.5); the conv kernel's launches per infer forward; where one
    TTA step's device time goes (5 steps of 24 images). Returns the conv
    launches."""
    import copy
    import numpy as np
    import torch
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    from salt_tpu_torch.tools.profiling import step_breakdown
    from salt_tpu_torch.train.steps import SegmentationRunner

    cfg = _arch_config(arch, depth)
    model = init_seeded(build_model(cfg.model), seed=0)
    takes = model.takes_depth
    x = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
    x = x.permute(0, 3, 1, 2)
    d = torch.tensor([[0.25], [0.8]]) if takes else None
    on = (lambda t: t.to(dev)) if takes else (lambda t: None)
    with torch.no_grad():
        cpu = model(x, depth=d)
        cpu_infer = model(x, infer=True, depth=d)
        card_model = copy.deepcopy(model).to(
            dev, memory_format=torch.channels_last)
        fp32 = card_model(x.to(dev), depth=on(d))
        fp32_infer = card_model(x.to(dev), infer=True, depth=on(d))
    torch.cuda.synchronize()
    torch.testing.assert_close(fp32.cpu(), cpu, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(fp32_infer.cpu(), cpu_infer, rtol=2e-3,
                               atol=2e-3)

    bundle = synthetic_bundle(n_tta, seed=7, with_masks=False)
    cpu_cfg = _arch_config(arch, depth)
    cpu_cfg.training.dtype = "float32"
    cpu_cfg.training.batch_size_inference = 8
    cpu_runner = SegmentationRunner(cpu_cfg, "cpu")
    t0 = time.perf_counter()
    p_cpu = cpu_runner.predict_dataset(cpu_runner.place(model), bundle.images,
                                       bundle.depths, tta=True)
    cpu_s = time.perf_counter() - t0
    runner = SegmentationRunner(cfg, dev)
    card_model = runner.place(card_model)
    ck.launches = 0
    p_card = runner.predict_dataset(card_model, bundle.images, bundle.depths,
                                    tta=True)
    torch.cuda.synchronize()
    launches = ck.launches
    forwards = math.ceil(n_tta / cfg.training.batch_size_inference)
    if launches != per_forward * forwards:
        raise AssertionError(f"{arch}: conv kernel launched {launches} times "
                             f"in {forwards} infer forwards, expected "
                             f"{per_forward} each")
    if not np.isfinite(p_card).all():
        raise AssertionError(f"{arch}: non-finite card probabilities")
    threshold = float(np.median(p_cpu[:, 1]))
    delta, undecidable = margin_rule(
        f"{arch} bf16 card vs fp32 CPU", p_card[:, 1], p_cpu[:, 1],
        p_card[:, 1] > threshold, p_cpu[:, 1] > threshold, threshold)
    imgs = torch.from_numpy(bundle.images[:SERVE_BATCH]).to(dev)
    depths = (torch.from_numpy(bundle.depths[:SERVE_BATCH]).to(dev)
              if takes else None)
    steps = step_breakdown(
        lambda i: runner.predict_tta_step(card_model, imgs, depths),
        steps=5, top=4)
    log("arch_profile", arch=f"{arch}-{depth}", step="predict_tta_step",
        images=SERVE_BATCH, wall_ms=f"{steps['wall_ms']:.3f}",
        device_ms=f"{steps['device_ms']:.3f}",
        busy_share=f"{steps['busy_share']:.3f}",
        launches_per_step=steps["launches_per_step"],
        top=[(t["kernel"][:60], t["calls_per_step"],
              round(t["ms_per_step"], 3)) for t in steps["top"]],
        card=repr(card))
    log("arch", arch=f"{arch}-{depth}", params=sum(
        p.numel() for p in model.parameters()),
        fp32_vs_cpu=float((fp32.cpu() - cpu).abs().max()),
        fp32_infer_vs_cpu=float((fp32_infer.cpu() - cpu_infer).abs().max()),
        logit_scale=float(cpu.abs().max()), tta_images=n_tta,
        tta_prob_delta=delta, tta_undecidable_px=undecidable,
        salt_fraction_at_half=f"{float(np.mean(p_cpu[:, 1] > 0.5)):.4f}",
        mask_threshold=threshold,
        conv_launches_per_forward=launches // max(forwards, 1),
        cpu_fp32_tta_s=f"{cpu_s:.3f}", card=repr(card))
    return launches


def _arch_serve(dev, card, arch, depth, per_forward):
    """``serve --synthetic N_ARCH_SERVE`` of the runner's seeded weights,
    bf16, hflip TTA, batch 24, the conv kernel on: images/s, and the
    launches of rows 1 and 3 (each forward batch, timed and warm-up)."""
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.pipeline.serving import serve

    cfg = _arch_config(arch, depth)
    with tempfile.TemporaryDirectory() as tmp:
        out_csv = os.path.join(tmp, "submission.csv")
        pk.launches = ck.launches = 0
        t0 = time.perf_counter()
        result = serve(cfg, "", "", out_csv, synthetic=N_ARCH_SERVE,
                       device=dev)
        wall = time.perf_counter() - t0
        counts = dict(preprocess=pk.launches, conv=ck.launches)
        ids, _ = _csv_masks(out_csv)
    if ids != synthetic_bundle(N_ARCH_SERVE, seed=cfg.execution.seed,
                               with_masks=False).meta["id"].tolist():
        raise AssertionError(f"{arch} serve: ids")
    forwards = result["batches"] + result["warmup_batches"]
    if (result["batches"] != math.ceil(N_ARCH_SERVE / SERVE_BATCH)
            or counts != dict(preprocess=forwards,
                              conv=per_forward * forwards)):
        raise AssertionError(f"{arch} serve: {result}, launches {counts}")
    log("arch_serve", arch=f"{arch}-{depth}", images=N_ARCH_SERVE,
        batch=SERVE_BATCH, tta="hflip", dtype=cfg.training.dtype,
        images_per_s=result["images_per_sec"],
        timed_s=f"{result['seconds']:.3f}", wall_s=f"{wall:.3f}",
        batches=result["batches"], warmup_batches=result["warmup_batches"],
        preprocess_launches=counts["preprocess"],
        conv_launches=counts["conv"], card=repr(card))
    return counts


def _arch_train(dev, card, arch, depth, per_forward):
    """``pipeline.api.train`` on N_ARCH_TRAIN synthetic images (their depths
    reach the depth net), bf16, batch 24, 2 epochs, the conv kernel on:
    the sort kernel once per train step and validation-loss batch, the
    preprocess kernel once per validation predict and loss batch, the
    conv kernel in the validation predicts; finite losses and a validation
    sweep each epoch; the step time of the second epoch."""
    import torch
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.core.logging import get_logger, init_logger
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.pipeline import api

    cfg = _arch_config(arch, depth)
    cfg.training.epochs = TRAIN_EPOCHS
    bundle = synthetic_bundle(N_ARCH_TRAIN, seed=cfg.execution.seed)
    n_valid = math.ceil(N_ARCH_TRAIN / cfg.execution.n_cv_splits)
    steps = TRAIN_EPOCHS * ((N_ARCH_TRAIN - n_valid) // TRAIN_BATCH)
    val = TRAIN_EPOCHS * math.ceil(n_valid / cfg.training.batch_size_inference)
    times = _EpochTimes()
    init_logger()
    get_logger().addHandler(times.handler)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.paths.experiment_dir = os.path.join(tmp, "exp")
        sk.launches = pk.launches = ck.launches = 0
        t0 = time.perf_counter()
        runner = api.train(cfg, Experiment(cfg.paths.experiment_dir), bundle,
                           device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sort=sk.launches, preprocess=pk.launches,
                      conv=ck.launches)
        get_logger().removeHandler(times.handler)
        with open(os.path.join(cfg.paths.experiment_dir,
                               "channels_network.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
    want = dict(sort=steps + val, preprocess=2 * val, conv=per_forward * val)
    losses = [e["train_loss"] for e in epochs] + [e["sum"] for e in epochs]
    if (counts != want or len(epochs) != TRAIN_EPOCHS
            or not all(map(math.isfinite, losses))
            or not all(0.0 <= e["iout"] <= 1.0 for e in epochs)
            or runner.use_depth != (arch == "UNetResNetWithDepth")):
        raise AssertionError(f"{arch} train: launches {counts} (expected "
                             f"{want}), epochs {epochs}")
    mean_batch = times.epochs[-1][2]
    log("arch_train", arch=f"{arch}-{depth}", images=N_ARCH_TRAIN,
        train_images=N_ARCH_TRAIN - n_valid, valid_images=n_valid,
        epochs=TRAIN_EPOCHS, batch=TRAIN_BATCH, steps=steps,
        use_depth=runner.use_depth, wall_s=f"{wall:.3f}",
        epoch2_ms_per_step=f"{mean_batch * 1e3:.3f}",
        epoch2_train_images_per_s=f"{TRAIN_BATCH / mean_batch:.1f}",
        sort_launches=counts["sort"], preprocess_launches=counts[
            "preprocess"], conv_launches=counts["conv"],
        train_loss=[round(e["train_loss"], 5) for e in epochs],
        val_iout=[round(e["iout"], 5) for e in epochs], card=repr(card))
    return counts


def _se_resnet50_state_dict(seed):
    """A pretrainedmodels-layout se_resnet50 encoder: the ``layer0.``
    stem, SEResNetBottleneck blocks with ``se_module.fc1/fc2`` gates;
    conv weights N(0, 1 / fan_in), BN and biases as the seeded
    initializer draws them."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = (rng.randn(o, i, k, k)
                                / np.sqrt(i * k * k)).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = (0.8 + 0.4 * rng.rand(c)).astype(np.float32)
        sd[name + ".bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_var"] = (0.8 + 0.4 * rng.rand(c)).astype(
            np.float32)

    conv("layer0.conv1", 64, 3, 7)
    bn("layer0.bn1", 64)
    cin = 64
    for stage, (w, n) in enumerate(zip((256, 512, 1024, 2048),
                                       (3, 4, 6, 3)), start=1):
        for i in range(n):
            pre, c_in = f"layer{stage}.{i}", cin if i == 0 else w
            for k, (o, ci, ks) in enumerate(((w // 4, c_in, 1),
                                             (w // 4, w // 4, 3),
                                             (w, w // 4, 1)), start=1):
                conv(f"{pre}.conv{k}", o, ci, ks)
                bn(f"{pre}.bn{k}", o)
            if i == 0:
                conv(pre + ".downsample.0", w, c_in, 1)
                bn(pre + ".downsample.1", w)
            conv(pre + ".se_module.fc1", w // 16, w, 1)
            sd[pre + ".se_module.fc1.bias"] = (0.05 * rng.randn(w // 16)
                                               ).astype(np.float32)
            conv(pre + ".se_module.fc2", w, w // 16, 1)
            sd[pre + ".se_module.fc2.bias"] = (0.05 * rng.randn(w)
                                               ).astype(np.float32)
        cin = w
    return sd


def _port_key(key):
    """The port's state_dict key of a pretrainedmodels SENet key."""
    import re
    key = key.replace("layer0.", "")
    key = re.sub(r"^layer(\d)\.(\d+)\.", r"layer\1_\2.", key)
    key = key.replace("downsample.0.", "downsample_conv.")
    key = key.replace("downsample.1.", "downsample_bn.BatchNorm_0.")
    key = key.replace("se_module.", "se.")
    key = re.sub(r"(^|\.)(bn\d)\.", r"\1\2.BatchNorm_0.", key)
    return "encoder." + key


def _arch_pretrained(dev, card):
    """``model.pretrained``: a seeded pretrainedmodels-layout se_resnet50
    ``.npz`` grafted into UNetSeResNet-50 by ``init_state`` on the card;
    every encoder tensor equals the file's (mapped by name here, apart
    from the port's converter) before one train step of 24 synthetic
    images, whose loss is finite and which moves the encoder."""
    import numpy as np
    import torch
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.train.steps import SegmentationRunner

    sd = _se_resnet50_state_dict(seed=50)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "se_resnet50.npz")
        np.savez(path, **sd)
        cfg = _arch_config("UNetSeResNet", 50)
        cfg.model.pretrained = True
        cfg.model.pretrained_weights_path = path
        runner = SegmentationRunner(cfg, dev)
        state = runner.init_state(0)
    have = state.model.state_dict()
    bad = [k for k, v in sd.items()
           if not torch.equal(have[_port_key(k)].cpu(), torch.from_numpy(v))]
    if bad:
        raise AssertionError(f"grafted encoder differs from the file at "
                             f"{bad[:5]} ({len(bad)} of {len(sd)})")
    before = state.model.encoder.conv1.weight.detach().clone()
    bundle = synthetic_bundle(TRAIN_BATCH, seed=9)
    imgs, masks = runner.device_batch(bundle.images, bundle.masks)
    g = torch.Generator(device=dev).manual_seed(0)
    loss = float(runner.train_step(state, imgs, masks, g))
    moved = float((state.model.encoder.conv1.weight.detach() - before)
                  .abs().max())
    if not (math.isfinite(loss) and moved > 0):
        raise AssertionError(f"pretrained train step: loss {loss}, encoder "
                             f"moved {moved}")
    log("arch_pretrained", arch="UNetSeResNet-50", layout="pretrainedmodels "
        "se_resnet50 (.npz)", tensors=len(sd), equal_to_file=len(sd),
        step_loss=f"{loss:.5f}", conv1_moved=moved, card=repr(card))


def phase_arch(dev, card):
    """The U-Net on every encoder and the depth net at full width, bf16,
    ``model.pallas_conv`` "on": for each of ARCH_CELLS the card against
    the CPU and its serve; UNetSeResNet-50 and UNetResNetWithDepth-34
    trained; a pretrained se_resnet50 encoder grafted. Returns the
    kernels' launches on the serve and train paths."""
    total = dict(preprocess=0, sort=0, conv=0)
    for arch, depth, per_forward in ARCH_CELLS:
        _arch_forward(dev, card, arch, depth, per_forward, N_ARCH_TTA_UNETS)
        counts = _arch_serve(dev, card, arch, depth, per_forward)
        if arch in ARCH_TRAIN:
            train = _arch_train(dev, card, arch, depth, per_forward)
            counts = {k: counts.get(k, 0) + train.get(k, 0) for k in total}
        for k in total:
            total[k] += counts.get(k, 0)
    _arch_pretrained(dev, card)
    return total


#: the arch2 phase: the last architectures of the JAX registry at full
#: width (encoder_depth 34 as the default config gives it); neither takes
#: a conv callable, so no conv kernel launches in them
ARCH2_CELLS = (("LargeKernelMatters", 34), ("PSPNet", 34))
ARCH2_TRAIN = ("PSPNet",)
#: the second-level modules, card against CPU (their runners run in the
#: full_solution phase)
ARCH2_MODULES = ("EmptinessClassifier", "StackingFCN", "StackingFCNWithDepth")


def _module_forward(dev, card, arch):
    """One module held as a module (its runner runs in the full_solution
    phase), full width from seeded weights: fp32 logits on the card (TF32 off) against
    the CPU at batch 2, rtol=atol=2e-3 (train mode too, with the same
    batch statistics). A stacking head takes ``input_model_nr`` (18)
    probability maps, the classifier 3 channels; the depth head the
    depths."""
    import copy
    import torch
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.ops.preprocess import preprocess_inference

    cfg = _arch_config(arch, 34)
    model = init_seeded(build_model(cfg.model), seed=0)
    if arch.startswith("Stacking"):
        x = torch.rand(2, cfg.model.input_model_nr, 128, 128,
                       generator=torch.Generator().manual_seed(4))
    else:
        x = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
        x = x.permute(0, 3, 1, 2)
    d = torch.tensor([[0.25], [0.8]]) if model.takes_depth else None
    card_model = copy.deepcopy(model).to(dev,
                                         memory_format=torch.channels_last)
    errs = {}
    with torch.no_grad():
        for mode in ("eval", "train"):
            model.train(mode == "train")
            card_model.train(mode == "train")
            cpu = model(x, depth=d)
            got = card_model(x.to(dev), depth=None if d is None
                             else d.to(dev))
            torch.cuda.synchronize()
            torch.testing.assert_close(got.cpu(), cpu, rtol=2e-3, atol=2e-3)
            errs[mode] = float((got.cpu() - cpu).abs().max())
    log("arch2_module", arch=arch, params=sum(p.numel()
                                              for p in model.parameters()),
        input=list(x.shape), logits=list(cpu.shape),
        fp32_vs_cpu_eval=errs["eval"], fp32_vs_cpu_train=errs["train"],
        logit_scale=float(cpu.abs().max()), card=repr(card))


N_ARCH2_CV = 96                   # 2 folds of 48 / 48, a 24-image test set


def _arch2_cv(card, arch, depth):
    """``cli train-evaluate-predict-cv`` of ``arch`` as a user runs it
    (N_ARCH2_CV synthetic images, 2 folds, 1 epoch, hflip TTA, batch 24):
    the sort kernel once per train step and validation-loss batch, the
    preprocess kernel once per validation predict, loss and test
    predict batch; fold scores and a submission of every test id."""
    import torch
    from salt_tpu_torch import cli
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk

    n_folds = 2
    n_valid, n_test = N_ARCH2_CV // n_folds, max(N_ARCH2_CV // 4, 8)
    val_batches = math.ceil(n_valid / SERVE_BATCH)
    test_batches = math.ceil(n_test / SERVE_BATCH)
    steps = (N_ARCH2_CV - n_valid) // TRAIN_BATCH
    want = dict(sort=n_folds * (steps + val_batches),
                preprocess=n_folds * (3 * val_batches + test_batches))
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "cv")
        pk.launches = sk.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["train-evaluate-predict-cv", "--synthetic",
                       str(N_ARCH2_CV), "--epochs", "1",
                       "--set", f"paths.experiment_dir={exp}",
                       "--set", f"model.architecture={arch}",
                       "--set", f"model.encoder_depth={depth}",
                       "--set", "postpro.use_tta=true",
                       "--set", f"execution.n_cv_splits={n_folds}",
                       "--set", f"training.batch_size_train={TRAIN_BATCH}",
                       "--set",
                       f"training.batch_size_inference={SERVE_BATCH}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sort=sk.launches, preprocess=pk.launches)
        with open(os.path.join(exp, "cv_scores.json")) as f:
            scores = json.load(f)
        ids, _ = _csv_masks(os.path.join(exp, "submission.csv"))
    if (rc != 0 or counts != want or len(scores["fold_iout"]) != n_folds
            or len(ids) != n_test):
        raise AssertionError(f"{arch} cv: rc {rc}, launches {counts} "
                             f"(expected {want}), scores {scores}")
    log("arch2_cv", arch=f"{arch}-{depth}", images=N_ARCH2_CV, folds=n_folds,
        wall_s=f"{wall:.3f}", fold_iout=[round(v, 5)
                                         for v in scores["fold_iout"]],
        test_images=len(ids), **counts, card=repr(card))
    return counts


def phase_arch2(dev, card):
    """LargeKernelMatters-34 and PSPNet-34 at full width, bf16, seeded
    weights, through the same checks as the arch phase (card against CPU,
    64 TTA masks under the margin rule, ``serve --synthetic 480`` at 24,
    a TTA step profiled); PSPNet trained 2 epochs of 5 steps under Lovász
    (the sort kernel); each through the CV commands (:func:`_arch2_cv`);
    the emptiness classifier and the two stacking heads card against CPU.
    Returns the kernels' launches."""
    total = dict(preprocess=0, sort=0, conv=0)
    for arch, depth in ARCH2_CELLS:
        _arch_forward(dev, card, arch, depth, 0)
        counts = [_arch_serve(dev, card, arch, depth, 0),
                  _arch2_cv(card, arch, depth)]
        if arch in ARCH2_TRAIN:
            counts.append(_arch_train(dev, card, arch, depth, 0))
        for k in total:
            total[k] += sum(c.get(k, 0) for c in counts)
    for arch in ARCH2_MODULES:
        _module_forward(dev, card, arch)
    return total


#: the full_solution phase: synthetic images (2 folds of 96 / 96, a
#: 48-image test set), cut from the reference's 6 folds trained to a
#: plateau (depth, not width); the stacking level's own epochs
N_FULL_SOLUTION = 192
FS_FOLDS = 2
FS_STACKING_EPOCHS = 2
#: images of the card-against-CPU checks of the stage checkpoints
N_FS_CHECK = 32


def _fs_counts():
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk
    return dict(preprocess=pk.launches, sort=sk.launches, conv=ck.launches)


def _fs_reset():
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops import sort_kernel as sk
    ck.launches = pk.launches = sk.launches = 0


def _fs_command(argv, want, what, card, phase="full_solution"):
    """``cli.main(argv)`` with the three kernels' counts set to 0 just
    before and read just after; they must equal ``want``. Returns (wall
    seconds, counts)."""
    import torch
    from salt_tpu_torch import cli
    _fs_reset()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _fs_counts()
    if rc != 0 or counts != want:
        raise AssertionError(f"{what}: rc {rc}, kernel launches {counts}, "
                             f"expected {want}")
    log(phase, command=what, wall_s=f"{wall:.3f}", **counts,
        card=repr(card))
    return wall, counts


def _fs_outputs(directory, name):
    import numpy as np
    with np.load(os.path.join(directory, "outputs", f"{name}.npz"),
                 allow_pickle=True) as z:
        return list(z["ids"]), z["images"]


def _fs_gating_check(work):
    """The final submission recomputed from the persisted test
    probabilities in numpy: an image whose P(non-empty) is under 0.5 is
    empty, every other keeps its salt mask (p > 0.5). Same ids, same
    masks."""
    import numpy as np
    seg_ids, seg = _fs_outputs(os.path.join(work, "segmentation"),
                               "out_of_fold_test_predictions")
    emp_ids, emp = _fs_outputs(os.path.join(work, "emptiness"),
                               "emptiness_oof_test_predictions")
    p_non_empty = dict(zip(emp_ids, emp[:, 1]))
    keep = np.array([p_non_empty[i] >= 0.5 for i in seg_ids])
    want = (seg[:, 1] > 0.5) & keep[:, None, None]
    ids, masks = _csv_masks(os.path.join(work, "final_submission.csv"))
    if ids != seg_ids or not np.array_equal(masks, want.astype(np.uint8)):
        raise AssertionError("full_solution: the final submission is not "
                             "the numpy gating of the persisted "
                             "probabilities")
    return int((~keep).sum())


def _fs_card_vs_cpu(dev, work, card):
    """One emptiness and one stacking fold checkpoint of the run on the
    card and on the CPU, fp32 (TF32 off): the classifier's probabilities
    of N_FS_CHECK images at 2e-3 and their AUC (equal unless two scores
    swap order); the stacking head's masks of N_FS_CHECK cubes under the
    margin rule."""
    import numpy as np
    from salt_tpu_torch.core.config import load_config
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.metrics.auc import roc_auc
    from salt_tpu_torch.pipeline.stacking import join_experiment_predictions
    from salt_tpu_torch.train.classifier import ClassifierRunner
    from salt_tpu_torch.train.stacking import StackingRunner

    cfg = load_config(None, {"training.dtype": "float32"})
    bundle = synthetic_bundle(N_FULL_SOLUTION, seed=cfg.execution.seed)
    images = bundle.images[:N_FS_CHECK]
    labels = bundle.meta["is_not_empty"].values[:N_FS_CHECK]
    arrays = Experiment(os.path.join(work, "emptiness")).load_params(
        "emptiness_fold_0")
    cfg.model.architecture = "EmptinessClassifier"
    probs = {}
    for where in (dev, "cpu"):
        runner = ClassifierRunner(cfg, where)
        probs[str(where)] = runner.predict_dataset(runner.restore(arrays),
                                                   images)[:, 1]
    p_card, p_cpu = probs[str(dev)], probs["cpu"]
    emp_delta = float(np.abs(p_card - p_cpu).max())
    auc_card, auc_cpu = roc_auc(labels, p_card), roc_auc(labels, p_cpu)
    swaps = (np.sign(p_card[:, None] - p_card[None])
             != np.sign(p_cpu[:, None] - p_cpu[None])).any()
    if emp_delta > 2e-3 or (not swaps and auc_card != auc_cpu):
        raise AssertionError(f"emptiness card vs CPU: delta {emp_delta}, "
                             f"AUC {auc_card} vs {auc_cpu}")

    seg = os.path.join(work, "segmentation")
    _, cube = join_experiment_predictions([seg], "train")
    cube = cube[:N_FS_CHECK]
    arrays = Experiment(os.path.join(work, "stacking")).load_params(
        "stacking_network_fold_0")
    out = {}
    for where in (dev, "cpu"):
        scfg = load_config(None, {"training.dtype": "float32",
                                  "model.architecture": "StackingFCN",
                                  "model.input_model_nr": 1})
        runner = StackingRunner(scfg, where)
        out[str(where)] = runner.predict_dataset(runner.restore(arrays),
                                                 cube)[:, 1]
    s_card, s_cpu = out[str(dev)], out["cpu"]
    s_delta, undecidable = margin_rule("stacking card vs CPU", s_card, s_cpu,
                                       s_card > 0.5, s_cpu > 0.5)
    log("full_solution", check="card_vs_cpu", images=N_FS_CHECK,
        emptiness_delta=emp_delta, auc_card=auc_card, auc_cpu=auc_cpu,
        order_swaps=bool(swaps), stacking_delta=s_delta,
        stacking_undecidable_pixels=undecidable, card=repr(card))


@contextlib.contextmanager
def _stage_timer(seconds):
    """Record each full-solution stage's wall seconds (to the card's
    synchronize) into ``seconds`` while the block runs: its three stage
    functions are wrapped where ``pipeline/full_solution.py`` looks them
    up."""
    import torch
    from salt_tpu_torch.pipeline import api, emptiness, stacking
    stages = ((api, "train_evaluate_predict_cv", "segmentation"),
              (emptiness, "train_evaluate_predict_cv", "emptiness"),
              (stacking, "train_evaluate_stacking", "stacking"))
    saved = [(module, name, getattr(module, name))
             for module, name, _ in stages]

    def timed(fn, stage):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[stage] = time.perf_counter() - t0
            return out
        return run

    for (module, name, fn), (_, _, stage) in zip(saved, stages):
        setattr(module, name, timed(fn, stage))
    try:
        yield seconds
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def phase_full_solution(dev, card):
    """``cli full-solution`` at full width as a user runs it: the flagship
    UNetResNet34 segmentation CV (bf16, hflip TTA, ``model.pallas_conv``
    "on"), the EmptinessClassifier's CV (its ResNet-18 trunk) and the
    StackingFCN level (32 filters, one input model), then the gated
    ``final_submission.csv`` and ``gating_scores.json``. Cut, in depth
    only: N_FULL_SOLUTION synthetic images in FS_FOLDS folds (the
    reference: 6 folds of its 4,000 images), 1 epoch a first-level fold
    and FS_STACKING_EPOCHS a stacking fold (the reference trains both to
    a plateau). Then: the final submission against a numpy gating of the
    persisted probabilities; a stage checkpoint of each second-level
    model on the card against the CPU; ``--set execution.resume=true``
    on the same workdir (no kernel launch, no ``best.npz`` rewritten,
    the same submission byte for byte); ``empty-evaluate-predict-cv`` on
    the emptiness stage (its fold AUCs), ``ensemble`` of the segmentation
    stage with itself (its submission), ``stacking-cv`` over it and
    ``distill`` of SaltUNet-16 from it. The preprocess, sort and conv
    kernels' launches of each command are held against what its
    configuration implies. Returns their sums."""
    import filecmp
    import glob
    import numpy as np

    n_valid = N_FULL_SOLUTION // FS_FOLDS
    n_test = max(N_FULL_SOLUTION // 4, 8)
    val_b = math.ceil(n_valid / SERVE_BATCH)
    test_b = math.ceil(n_test / SERVE_BATCH)
    steps = (N_FULL_SOLUTION - n_valid) // TRAIN_BATCH
    # stage 1 as the cv phase counts it; stage 2 none (the classifier's
    # inputs are plain ops, its Lovász sorts P = 2 plainly, no conv
    # callable); stage 3 a sort a train step and a validation-loss batch
    seg = dict(conv=CONV_KERNEL_PER_FORWARD * FS_FOLDS * (2 * val_b + test_b),
               preprocess=FS_FOLDS * (3 * val_b + test_b),
               sort=FS_FOLDS * (steps + val_b))
    stack_sort = FS_FOLDS * FS_STACKING_EPOCHS * (steps + val_b)
    want = dict(conv=seg["conv"], preprocess=seg["preprocess"],
                sort=seg["sort"] + stack_sort)
    zero = dict(preprocess=0, sort=0, conv=0)
    total = dict(zero)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "fs")
        common = ["--synthetic", str(N_FULL_SOLUTION), "--epochs", "1",
                  "--set", "postpro.use_tta=true",
                  "--set", "model.pallas_conv=on",
                  "--set", f"execution.n_cv_splits={FS_FOLDS}",
                  "--set", f"training.batch_size_train={TRAIN_BATCH}",
                  "--set", f"training.batch_size_inference={SERVE_BATCH}"]
        fs = ["full-solution", "--workdir", work, *common,
              "--set", f"paths.experiment_dir={tmp}/unused",
              "--set", f"training.stacking_epochs={FS_STACKING_EPOCHS}"]
        stage_s = {}
        with _stage_timer(stage_s):
            wall, counts = _fs_command(fs, want, "full-solution", card)
        for k in total:
            total[k] += counts[k]
        with open(os.path.join(work, "gating_scores.json")) as f:
            gating = json.load(f)
        scores = {}
        for stage, name in (("segmentation", "cv_scores"),
                            ("emptiness", "emptiness_cv_scores"),
                            ("stacking", "stacking_cv_scores")):
            with open(os.path.join(work, stage, f"{name}.json")) as f:
                scores[stage] = json.load(f)
        ids, _ = _csv_masks(os.path.join(work, "final_submission.csv"))
        if len(ids) != n_test:
            raise AssertionError(f"final submission: {len(ids)} rows, "
                                 f"expected {n_test}")
        gated_out = _fs_gating_check(work)
        log("full_solution", images=N_FULL_SOLUTION, folds=FS_FOLDS,
            test_images=n_test, wall_s=f"{wall:.3f}",
            stage_s={k: round(v, 3) for k, v in stage_s.items()},
            seg_fold_iout=[round(v, 5) for v in
                           scores["segmentation"]["fold_iout"]],
            emptiness_fold_auc=[round(v, 5) for v in
                                scores["emptiness"]["fold_auc"]],
            stacking_fold_iout=[round(v, 5) for v in
                                scores["stacking"]["fold_iout"]],
            gating=gating, gated_out_test_images=gated_out, card=repr(card))
        _fs_card_vs_cpu(dev, work, card)

        # resume: every stage complete, nothing trains or predicts
        best = sorted(glob.glob(os.path.join(work, "*", "checkpoints", "*",
                                             "best.npz")))
        mtimes = [os.path.getmtime(p) for p in best]
        with open(os.path.join(work, "final_submission.csv"), "rb") as f:
            submission = f.read()
        _fs_command([*fs, "--set", "execution.resume=true"], zero,
                    "full-solution resume", card)
        with open(os.path.join(work, "final_submission.csv"), "rb") as f:
            same = f.read() == submission
        if (len(best) != 3 * FS_FOLDS or not same
                or [os.path.getmtime(p) for p in best] != mtimes):
            raise AssertionError(f"resume: {len(best)} best.npz, submission "
                                 f"the same: {same}, or a checkpoint "
                                 "rewritten")

        # the other commands, on the stage directories
        emp_dir = os.path.join(work, "emptiness")
        _, p_stage = _fs_outputs(emp_dir, "emptiness_oof_train_predictions")
        _fs_command(["empty-evaluate-predict-cv", *common,
                     "--set", f"paths.experiment_dir={emp_dir}"], zero,
                    "empty-evaluate-predict-cv", card)
        _, p_again = _fs_outputs(emp_dir, "emptiness_oof_train_predictions")
        with open(os.path.join(emp_dir, "emptiness_cv_scores.json")) as f:
            again = json.load(f)
        delta = float(np.abs(p_again - p_stage).max())
        if delta > 2e-3 or (delta == 0.0 and again["fold_auc"]
                            != scores["emptiness"]["fold_auc"]):
            raise AssertionError(f"empty-evaluate-predict-cv: delta {delta},"
                                 f" fold AUC {again['fold_auc']} against "
                                 f"{scores['emptiness']['fold_auc']}")
        seg_dir = os.path.join(work, "segmentation")
        out_csv = os.path.join(tmp, "ensemble.csv")
        _fs_command(["ensemble", "--experiments", seg_dir, seg_dir,
                     "--synthetic", str(N_FULL_SOLUTION), "--out", out_csv],
                    zero, "ensemble", card)
        if not filecmp.cmp(out_csv, os.path.join(seg_dir, "submission.csv"),
                           shallow=False):
            raise AssertionError("ensemble of the segmentation stage with "
                                 "itself is not its submission")
        stack_dir = os.path.join(tmp, "stacking_cv")
        _, counts = _fs_command(
            ["stacking-cv", "--stacking-experiments", seg_dir, *common,
             "--set", f"paths.experiment_dir={stack_dir}"],
            dict(zero, sort=FS_FOLDS * (steps + val_b)), "stacking-cv", card)
        for k in total:
            total[k] += counts[k]
        with open(os.path.join(stack_dir, "stacking_submission.csv")) as f:
            if sum(1 for _ in f) != n_test + 1:
                raise AssertionError("stacking-cv: short submission")
        # distill: fold 0's split, the SaltUNet takes no conv callable
        distill_dir = os.path.join(tmp, "distill")
        _, counts = _fs_command(
            ["distill", "--teacher", seg_dir, *common,
             "--set", f"paths.experiment_dir={distill_dir}",
             "--set", "model.architecture=SaltUNet",
             "--set", "model.n_filters=16"],
            dict(conv=0, sort=steps + val_b, preprocess=3 * val_b),
            "distill", card)
        for k in total:
            total[k] += counts[k]
        with open(os.path.join(distill_dir, "distill_report.json")) as f:
            report = json.load(f)
        log("full_solution", command="distill", student="SaltUNet-16",
            student_iout=f"{report['student_iout']:.5f}",
            teacher_iout=f"{report['teacher_iout']:.5f}", card=repr(card))
    log("full_solution", phase_wall_s=f"{time.perf_counter() - t_phase:.3f}")
    log("full_solution", **{f"{k}_launches": v for k, v in total.items()},
        card=repr(card))
    return total


#: int8 convs of one flagship (UNetResNet-34) infer form with
#: model.quant_bits=8, JAX's AQT route as tests/test_torch_int8_model.py
#: counts it: the encoder's 36 (stem, 32 block convs, 3 projections), the
#: center's 2, 12 in the decoders' sums and convs, dec1's 2, the
#: hypercolumn head's 5 branches. With pallas_conv "on" its 14 64 -> 64
#: convs take row 3 instead.
INT8_CONV_PER_FORWARD = 57
INT8_CONV_PER_FORWARD_ON = 43
#: of those, the stride-1 3x3 convs with C_in a multiple of 64 that
#: ``ops/int8_conv.py::conv_path`` sends to csrc/int8_conv_wgmma.cu "off"
#: (the rest, 8, to csrc/int8_conv.cu); "on" hands 14 of them to row 3
INT8_WGMMA_PER_FORWARD = 49
INT8_WGMMA_PER_FORWARD_ON = INT8_WGMMA_PER_FORWARD - CONV_KERNEL_PER_FORWARD
N_INT8_SERVE = 2048
#: calls of an int8 conv captured in one CUDA graph, and the graph's
#: timed replays (the median counts)
INT8_GRAPH_CALLS, INT8_GRAPH_REPLAYS = 20, 5


def _int8_reset():
    """Set the int8 kernels' counters to 0."""
    from salt_tpu_torch.ops import int8_conv as ic
    ic.conv_launches = ic.quantize_launches = 0
    ic.wgmma_launches = ic.mma_launches = 0


def _int8_counts():
    """The int8 kernels' counters: both conv paths, each path, the
    quantizer."""
    from salt_tpu_torch.ops import int8_conv as ic
    return dict(int8_conv=ic.conv_launches, int8_wgmma=ic.wgmma_launches,
                int8_mma=ic.mma_launches, int8_quant=ic.quantize_launches)


def _int8_want(forwards, on=False):
    """:func:`_int8_counts` after ``forwards`` flagship int8 forwards with
    ``model.pallas_conv`` "off" (or "on")."""
    conv = INT8_CONV_PER_FORWARD_ON if on else INT8_CONV_PER_FORWARD
    wgmma = INT8_WGMMA_PER_FORWARD_ON if on else INT8_WGMMA_PER_FORWARD
    return dict(int8_conv=conv * forwards, int8_wgmma=wgmma * forwards,
                int8_mma=(conv - wgmma) * forwards,
                int8_quant=2 * conv * forwards)


def _int8_config(quant_bits=8, pallas_conv="off", batch=SERVE_BATCH):
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()                 # the flagship, bf16
    cfg.model.quant_bits = quant_bits
    cfg.model.pallas_conv = pallas_conv
    cfg.postpro.use_tta = True
    cfg.training.batch_size_inference = batch
    return cfg


def _int8_sites(dev):
    """The int8 route's calls in one hflip-TTA step of the flagship at
    batch 24 (48 images a forward), recorded by wrapping the conv of
    ``models.quant``: [(x shape, w shape, stride, padding, groups)]."""
    import torch
    from salt_tpu_torch.models import quant
    from salt_tpu_torch.train.steps import SegmentationRunner

    runner = SegmentationRunner(_int8_config(), dev)
    model = runner.init_model(0)
    sites = []
    conv = quant.conv2d_int8

    def record(x, w, stride=1, padding=0, groups=1):
        sites.append((tuple(x.shape), tuple(w.shape), _int8_pair(stride),
                      _int8_pair(padding), groups))
        return conv(x, w, stride, padding, groups)

    quant.conv2d_int8 = record
    try:
        imgs = torch.from_numpy(seeded_images(SERVE_BATCH, seed=5)).to(dev)
        runner.predict_tta_step(model, imgs)
    finally:
        quant.conv2d_int8 = conv
    return sites


def _int8_pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(i) for i in v)


def graph_ms(fn, calls=INT8_GRAPH_CALLS, replays=INT8_GRAPH_REPLAYS):
    """Device ms a call of ``fn``: ``calls`` back-to-back calls captured
    in one CUDA graph, replayed ``replays`` times under CUDA events, the
    median replay over ``calls``. No host work runs between the
    kernels, so a small kernel reads its own time and not its launch's;
    the launches' own gaps in the graph stay in."""
    import statistics
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def _int8_ulps(got, want):
    """The largest distance of ``got`` from ``want`` in bf16 ulps of
    ``want`` (both fp32 tensors of bf16 values)."""
    import torch
    _, exp = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    return float(((got - want).abs() / ulp).max())


def _int8_check(dev, xs, ws, stride, padding, groups, seed, plain):
    """One conv of the route on random bf16 operands: the quantize
    kernel's values and scales bit-equal to its plain version's for the
    activation and the weight; the conv on the path ``conv_path`` gives
    it, the wgmma kernel bit-equal to its plain version, the mma.sync one
    within one bf16 ulp (no floor: the s32 sums are exact), and on a
    wgmma shape the mma.sync kernel too (``path="mma"``, the A/B). Times:
    each conv kernel's device time from a CUDA graph of back-to-back calls
    (:func:`graph_ms`), a whole call's by CUDA events over back-to-back
    calls (host work included; the profiler records no device event in
    some sessions of a call that launches only ctypes kernels, so it
    times neither), the quantize calls' by events, cuDNN's bf16
    ``F.conv2d`` on the same shape (the yardstick; the port never calls
    it) and, with ``plain``, the plain versions; and the bounds. Returns
    a dict."""
    import torch
    import torch.nn.functional as F
    from salt_tpu_torch.ops import costs
    from salt_tpu_torch.ops import int8_conv as ic

    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = xs
    o, cg, kh, kw = ws
    path = ic.conv_path(xs, ws, stride, padding, groups)
    x = (torch.randn(xs, generator=gen) * 2).to(torch.bfloat16).to(
        dev).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn(ws, generator=gen) / math.sqrt(kh * kw * cg)).to(
        torch.bfloat16).to(dev)
    rows_x = x.permute(0, 2, 3, 1).reshape(b, -1)
    rows_w = wt.permute(0, 2, 3, 1).reshape(o, -1).contiguous()
    with torch.no_grad():
        with costs.recording() as quantized:
            qx, sx = ic.quantize_rows(rows_x)
            qw, sw = ic.quantize_rows(rows_w)
        for (q, s), rows in (((qx, sx), rows_x), ((qw, sw), rows_w)):
            pq, ps = ic.quantize_rows_plain(rows)
            if not (torch.equal(q, pq) and torch.equal(s, ps)):
                raise AssertionError(f"int8 quantize {xs} {ws}: "
                                     f"{int((q != pq).sum())} values and "
                                     f"{int((s != ps).sum())} scales differ")
        xq = qx.view(b, h, w, c).permute(0, 3, 1, 2)
        wq = qw.view(o, kh, kw, cg).permute(0, 3, 1, 2)
        args = (xq, sx, wq, sw, stride, padding, groups, torch.bfloat16)

        def conv():
            return ic.int8_conv2d(*args)

        def mma():
            return ic.int8_conv2d(*args, path="mma")

        with costs.recording() as launched:
            got = conv().float()
        (cost,) = launched
        want = ic.int8_conv2d_plain(*args).float()
        got_mma = mma().float()
        torch.cuda.synchronize()
        worst, worst_mma = _int8_ulps(got, want), _int8_ulps(got_mma, want)
        if (got.shape != want.shape or got_mma.shape != want.shape
                or worst > (0.0 if path == "wgmma" else 1.0)
                or worst_mma > 1.0):
            raise AssertionError(f"int8 conv {xs} {ws} ({path}): {worst} "
                                 f"bf16 ulp; the mma.sync kernel "
                                 f"{worst_mma}")
        out = dict(path=path, max_abs_err=float((got - want).abs().max()),
                   max_ulp=worst)
        out["ms"] = graph_ms(conv)
        out["call_ms"] = time_ms(conv, iters=50, warmup=5)
        if path == "wgmma":
            out["mma_ms"] = graph_ms(mma)
            out["mma_call_ms"] = time_ms(mma, iters=50, warmup=5)
        else:
            out["mma_ms"], out["mma_call_ms"] = out["ms"], out["call_ms"]
        # one call is the two passes, absmax_kernel and quant_kernel
        out["quant_ms"] = sum(time_ms(lambda: ic.quantize_rows(rows),
                                      iters=50, warmup=5)
                              for rows in (rows_x, rows_w))
        out["cudnn_bf16_ms"] = time_ms(
            lambda: F.conv2d(x, wt, None, stride, padding, 1, groups),
            iters=20, warmup=3)
        out["bound_ms"], out["bound_by"] = costs.launches_bound_ms(launched)
        out["ops"], out["bytes"] = cost.operations, cost.nbytes
        out["quant_bound_ms"], _ = costs.launches_bound_ms(quantized)
        check_bound(f"int8 conv {xs} {ws}", out["bound_ms"], ms=out["ms"],
                    call_ms=out["call_ms"], mma_ms=out["mma_ms"],
                    mma_call_ms=out["mma_call_ms"])
        check_bound(f"int8 quantize {xs} {ws}", out["quant_bound_ms"],
                    quant_ms=out["quant_ms"])
        if plain:
            out["plain_ms"] = time_ms(lambda: ic.int8_conv2d_plain(*args),
                                      iters=5, warmup=1)
            out["quant_plain_ms"] = sum(
                time_ms(lambda: ic.quantize_rows_plain(rows), iters=20,
                        warmup=3) for rows in (rows_x, rows_w))
            check_bound(f"int8 conv {xs} {ws}", out["bound_ms"],
                        plain_ms=out["plain_ms"])
            check_bound(f"int8 quantize {xs} {ws}", out["quant_bound_ms"],
                        quant_plain_ms=out["quant_plain_ms"])
    return out


def _int8_forward_counts(dev, card):
    """The int8 kernels' launches in one TTA step of the flagship at batch
    24, "off" and "on", against the route's sites (JAX's, counted in
    tests/test_torch_int8_model.py): each routed conv one conv launch
    (the wgmma kernel for 49 of the 57, the mma.sync one for the rest)
    and two quantize calls; "on" sends the 14 64 -> 64 convs to row 3."""
    import torch
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.train.steps import SegmentationRunner

    imgs = torch.from_numpy(seeded_images(SERVE_BATCH, seed=6)).to(dev)
    total = dict(_int8_want(0), conv=0, preprocess=0)
    for mode in ("off", "on"):
        on = mode == "on"
        want = dict(_int8_want(1, on),
                    conv=CONV_KERNEL_PER_FORWARD if on else 0, preprocess=1)
        runner = SegmentationRunner(_int8_config(pallas_conv=mode), dev)
        model = runner.init_model(0)
        _int8_reset()
        ck.launches = pk.launches = 0
        probs = runner.predict_tta_step(model, imgs)
        torch.cuda.synchronize()
        got = dict(_int8_counts(), conv=ck.launches, preprocess=pk.launches)
        if got != want or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"int8 forward ({mode}): launches {got}; "
                                 f"expected {want}")
        log("int8_route", pallas_conv=mode, int8_conv_launches=got[
            "int8_conv"], int8_conv_wgmma_launches=got["int8_wgmma"],
            int8_conv_mma_launches=got["int8_mma"],
            quantize_calls=got["int8_quant"],
            conv3x3_pair_launches=got["conv"], card=repr(card))
        for k in total:
            total[k] += got[k]
    return total


def _int8_serve(dev, card):
    """``serve --int8 --synthetic 2048`` (the CLI's config: hflip TTA,
    batch 24, bf16, seeded weights) beside the same serve in bf16:
    images/s, the kernels' launches per forward batch, the fraction of
    mask pixels on which the two differ, and one TTA step of each
    profiled (device ms, busy share, launches)."""
    import numpy as np
    import torch
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.pipeline.serving import serve
    from salt_tpu_torch.tools.profiling import step_breakdown
    from salt_tpu_torch.train.steps import SegmentationRunner

    counts, masks = {}, {}
    imgs = torch.from_numpy(seeded_images(SERVE_BATCH, seed=8)).to(dev)
    for bits in (0, 8):
        cfg = _int8_config(quant_bits=bits)
        with tempfile.TemporaryDirectory() as tmp:
            out_csv = os.path.join(tmp, "submission.csv")
            _int8_reset()
            pk.launches = 0
            result = serve(cfg, "", "", out_csv, synthetic=N_INT8_SERVE,
                           device=dev)
            got = dict(_int8_counts(), preprocess=pk.launches)
            _, masks[bits] = _csv_masks(out_csv)
        forwards = result["batches"] + result["warmup_batches"]
        if got != dict(_int8_want(forwards if bits else 0),
                       preprocess=forwards):
            raise AssertionError(f"serve (quant_bits {bits}): launches {got}"
                                 f" for {forwards} forward batches")
        runner = SegmentationRunner(cfg, dev)
        model = runner.init_model(0)
        steps = step_breakdown(
            lambda i: runner.predict_tta_step(model, imgs), steps=5, top=5,
            kernels=("int8_conv_wgmma_kernel", "int8_conv_kernel",
                     "quant_kernel", "absmax_kernel"))
        log("int8_serve", quant_bits=bits, images=N_INT8_SERVE,
            batch=SERVE_BATCH, tta="hflip", dtype=cfg.training.dtype,
            images_per_s=result["images_per_sec"],
            timed_s=f"{result['seconds']:.3f}", batches=result["batches"],
            warmup_batches=result["warmup_batches"], **got,
            step_wall_ms=f"{steps['wall_ms']:.3f}",
            step_device_ms=f"{steps['device_ms']:.3f}",
            busy_share=f"{steps['busy_share']:.3f}",
            launches_per_step=steps["launches_per_step"],
            int8_kernels_per_step={k: (round(v["ms_per_step"], 4),
                                       v["launches_per_step"])
                                   for k, v in steps["kernels"].items()},
            top=[(t["kernel"][:50], t["calls_per_step"],
                  round(t["ms_per_step"], 3)) for t in steps["top"]],
            card=repr(card))
        counts[bits] = got
    log("int8_serve", mask_pixels_differing_bf16_int8=int(
        (masks[0] != masks[8]).sum()), pixels=int(masks[0].size),
        salt_fraction_bf16=f"{float(np.mean(masks[0])):.4f}",
        salt_fraction_int8=f"{float(np.mean(masks[8])):.4f}")
    return {k: counts[0][k] + counts[8][k] for k in counts[8]}


#: the sums phase_int8 keeps per conv path and batch
_INT8_SUMS = ("ms", "call_ms", "mma_ms", "mma_call_ms", "plain_ms",
              "bound_ms", "cudnn_bf16_ms", "ops_ms", "bytes_ms", "sites")


def _int8_record(name, source, sums, max_err, shape):
    """The kernels line's record of one int8 conv kernel: its sites'
    times summed over one forward at 128 images."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": "salt_tpu/models/quant.py:24",
            "launches": None, "max_abs_err": max_err, "ms": sums["ms"],
            "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
            "bound_by": ("operations" if sums["ops_ms"] >= sums["bytes_ms"]
                         else "bytes"),
            "library_ms": None, "timed_by": "cuda_graph",
            "call_ms": sums["call_ms"], "timed_call_by": "events",
            "yardstick_ms": sums["cudnn_bf16_ms"],
            "yardstick": "cuDNN bf16 F.conv2d, same shapes",
            "shape": shape}


def phase_int8(dev, card):
    """int8 serving (``model.quant_bits=8``) on the card: every conv shape
    of the flagship's int8 route (recorded from one TTA step at batch 24)
    checked and timed at batch 24 and 64 (48 and 128 images a forward),
    on the path ``conv_path`` gives it and, for the wgmma kernel's
    shapes, on the mma.sync kernel too (the A/B), the plain versions
    timed at 64; the launches per forward of each path against the
    route's sites, "off" and "on"; ``serve --int8 --synthetic 2048`` at
    24 beside bf16. Returns the kernel records of the two conv kernels
    and the quantizer (their times summed over one forward at batch 64,
    each site as often as the forward calls it) and the launches."""
    from salt_tpu_torch.ops import costs
    sites = _int8_sites(dev)
    if len(sites) != INT8_CONV_PER_FORWARD:
        raise AssertionError(f"int8 route: {len(sites)} sites, expected "
                             f"{INT8_CONV_PER_FORWARD}")
    shapes = {}
    for s in sites:
        shapes[s] = shapes.get(s, 0) + 1
    sums = {(path, batch): dict.fromkeys(_INT8_SUMS, 0.0)
            for path in ("wgmma", "mma") for batch in (SERVE_BATCH,
                                                       BENCH_BATCH)}
    quant = dict(quant_ms=0.0, quant_plain_ms=0.0, quant_bound_ms=0.0)
    max_err = {"wgmma": 0.0, "mma": 0.0}
    for i, ((xs, ws, stride, padding, groups), n) in enumerate(
            shapes.items()):
        for batch in (SERVE_BATCH, BENCH_BATCH):
            xb = (2 * batch,) + xs[1:]
            r = _int8_check(dev, xb, ws, stride, padding, groups, seed=i,
                            plain=batch == BENCH_BATCH)
            r["ops_ms"] = r["ops"] / costs.INT8_DENSE_OPS * 1e3
            r["bytes_ms"] = r["bytes"] / costs.HBM_BYTES_PER_S * 1e3
            r["sites"] = 1
            path = r["path"]
            max_err[path] = max(max_err[path], r["max_abs_err"])
            for k in _INT8_SUMS:
                sums[path, batch][k] += n * r.get(k, 0.0)
            if batch == BENCH_BATCH:
                for k in quant:
                    quant[k] += n * r[k]
            log("int8_shape", x=list(xb), w=list(ws), stride=stride,
                padding=padding, groups=groups, per_forward=n, path=path,
                ms=f"{r['ms']:.5f}", timed_by="cuda_graph",
                call_ms=f"{r['call_ms']:.5f}",
                mma_ms=f"{r['mma_ms']:.5f}",
                mma_call_ms=f"{r['mma_call_ms']:.5f}",
                bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
                bound_share=f"{r['bound_ms'] / r['ms']:.3f}",
                mma_bound_share=f"{r['bound_ms'] / r['mma_ms']:.3f}",
                tops=f"{r['ops'] / r['ms'] / 1e9:.1f}",
                quant_ms=f"{r['quant_ms']:.5f}",
                cudnn_bf16_ms=f"{r['cudnn_bf16_ms']:.5f}",
                plain_ms=f"{r.get('plain_ms', float('nan')):.4f}",
                max_ulp=r["max_ulp"], floor=0, card=repr(card))
    for batch in (SERVE_BATCH, BENCH_BATCH):
        new, old = sums["wgmma", batch], sums["mma", batch]
        log("int8_forward", images=2 * batch, sites=len(sites),
            shapes=len(shapes), row9_ms=f"{new['ms'] + old['ms']:.4f}",
            row9_mma_ms=f"{new['mma_ms'] + old['ms']:.4f}",
            row9_call_ms=f"{new['call_ms'] + old['call_ms']:.4f}",
            row9_mma_call_ms=f"{new['mma_call_ms'] + old['call_ms']:.4f}",
            bound_ms=f"{new['bound_ms'] + old['bound_ms']:.4f}",
            cudnn_bf16_ms=format(new["cudnn_bf16_ms"]
                                 + old["cudnn_bf16_ms"], ".4f"),
            **{f"{path}_{k}": f"{sums[path, batch][k]:.4f}"
               for path in ("wgmma", "mma")
               for k in ("sites", "ms", "mma_ms", "bound_ms")},
            card=repr(card))
    counts = _int8_forward_counts(dev, card)
    serve_counts = _int8_serve(dev, card)
    for k in serve_counts:
        counts[k] = counts.get(k, 0) + serve_counts[k]
    new, old = sums["wgmma", BENCH_BATCH], sums["mma", BENCH_BATCH]
    shape = (f"the {{}} of the {len(sites)} int8 convs of one flagship "
             f"infer forward, {2 * BENCH_BATCH} images, bf16 (summed)")
    wgmma = _int8_record(
        "int8_conv_wgmma", "salt_tpu_torch/csrc/int8_conv_wgmma.cu", new,
        max_err["wgmma"], shape.format(f"{INT8_WGMMA_PER_FORWARD} stride-1 "
                                       "3x3"))
    wgmma["mma_kernel_ms"] = new["mma_ms"]  # int8_conv.cu on these sites
    mma = _int8_record(
        "int8_conv", "salt_tpu_torch/csrc/int8_conv.cu", old,
        max_err["mma"],
        shape.format(f"{INT8_CONV_PER_FORWARD - INT8_WGMMA_PER_FORWARD} "
                     "other"))
    quant_rec = {"name": "int8_quant", "route": "cuda",
                 "source": "salt_tpu_torch/csrc/int8_quant.cu",
                 "replaces": "salt_tpu/models/quant.py:24",
                 "launches": None, "max_abs_err": 0.0,
                 "ms": quant["quant_ms"],
                 "plain_ms": quant["quant_plain_ms"],
                 "bound_ms": quant["quant_bound_ms"], "bound_by": "bytes",
                 "library_ms": None, "timed_by": "events",
                 "shape": shape.format("activation and weight quantizations "
                                       f"of all {len(sites)}")}
    return wgmma, mma, quant_rec, counts


def _cv_int8_gate(exp, flags, card, n_folds, val_batches, test_batches):
    """The int8 quality gate over the cv phase's experiment, as a user runs
    it: ``evaluate-predict-cv --set model.quant_bits=8`` writes one
    ``int8_gate_network_fold_<i>.json`` a fold (the int8 predictions of
    each fold's validation split and test set, the float ones of its
    validation split), then ``serve --int8 --checkpoint <experiment>
    --synthetic 48`` writes ``<out>.int8_gate.json`` with every fold's
    checkpoint hash and ``gate_status`` "measured". Returns the launches."""
    import glob
    import torch
    from salt_tpu_torch import cli
    from salt_tpu_torch.ops import preprocess_kernel as pk

    int8 = ["--set", "model.pallas_conv=off", "--set", "model.quant_bits=8"]
    _int8_reset()
    pk.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["evaluate-predict-cv", *flags, *int8])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forwards = n_folds * (val_batches + test_batches)
    got = dict(_int8_counts(), preprocess=pk.launches)
    want = dict(_int8_want(forwards),
                preprocess=n_folds * (2 * val_batches + test_batches))
    paths = sorted(glob.glob(os.path.join(exp, "int8_gate_*.json")))
    gates = []
    for p in paths:
        with open(p) as f:
            gates.append(json.load(f))
    keys = {"checkpoint", "checkpoint_sha256", "quant_bits",
            "n_validation_images", "float", "int8", "iout_delta"}
    if (rc != 0 or got != want or len(gates) != n_folds
            or not all(set(g) == keys and g["quant_bits"] == 8
                       for g in gates)):
        raise AssertionError(f"int8 gate: rc {rc}, launches {got} (expected "
                             f"{want}), {len(gates)} artifacts")
    log("int8_gate", command="evaluate-predict-cv --set model.quant_bits=8",
        wall_s=f"{wall:.3f}", folds=n_folds, artifacts=len(gates),
        iout_delta=[round(g["iout_delta"], 5) for g in gates],
        iout_float=[round(g["float"]["iout"], 5) for g in gates],
        iout_int8=[round(g["int8"]["iout"], 5) for g in gates], **got,
        card=repr(card))
    out_csv = os.path.join(exp, "int8_submission.csv")
    n_serve = 2 * SERVE_BATCH
    _int8_reset()
    pk.launches = 0
    rc = cli.main(["serve", "--int8", "--checkpoint", exp, "--synthetic",
                   str(n_serve), "--out", out_csv, "--set",
                   "model.pallas_conv=off", "--set",
                   f"training.batch_size_inference={SERVE_BATCH}"])
    torch.cuda.synchronize()
    with open(out_csv + ".int8_gate.json") as f:
        prov = json.load(f)
    batches = math.ceil(n_serve / SERVE_BATCH)
    forwards = batches * n_folds + batches       # timed, and the warm-up
    served = dict(_int8_counts(), preprocess=pk.launches)
    if (rc != 0 or prov["gate_status"] != "measured"
            or len(prov["gates"]) != n_folds
            or len(prov["checkpoints"]) != n_folds
            or served != dict(_int8_want(forwards), preprocess=forwards)):
        raise AssertionError(f"serve --int8: rc {rc}, provenance "
                             f"{prov['gate_status']!r} with "
                             f"{len(prov['gates'])} gates, launches {served}")
    log("int8_gate", command="serve --int8 --checkpoint <cv experiment>",
        images=n_serve, gate_status=prov["gate_status"],
        gates=len(prov["gates"]), checkpoints=len(prov["checkpoints"]),
        **served, card=repr(card))
    return {k: got[k] + served[k] for k in got}


# -- import: whole reference checkpoints, converted and grafted --------------

#: ResNet-34's BasicBlocks a stage, and the stage widths
REF_LAYERS = (3, 4, 6, 3)
REF_WIDTHS = (64, 128, 256, 512)
#: hflip-TTA masks of the imported flagship, card bf16 vs CPU fp32
N_IMPORT_TTA = 32
#: the imported flagship's infer form with model.pallas_conv "on": 14
#: convs of 64 -> 64 take row 3 (the CPU count of the route), the 8 of the
#: decoders and head in its halo form (the reference's replication pad
#: comes first, then a VALID conv), the 6 of the encoder's layer1 SAME
IMPORT_CONV_PER_FORWARD = 14
IMPORT_HALO_PER_FORWARD = 8


def _ref_conv(rng, o, i, kh, kw=None):
    kw = kh if kw is None else kw
    return (rng.randn(o, i, kh, kw) / math.sqrt(i * kh * kw)).astype("f4")


def _ref_vec(rng, n, scale=0.05):
    return (scale * rng.randn(n)).astype("f4")


def _ref_bn(sd, rng, name, c):
    sd[f"{name}.weight"] = (0.8 + 0.4 * rng.rand(c)).astype("f4")
    sd[f"{name}.bias"] = _ref_vec(rng, c, 0.1)
    sd[f"{name}.running_mean"] = _ref_vec(rng, c, 0.1)
    sd[f"{name}.running_var"] = (0.8 + 0.4 * rng.rand(c)).astype("f4")


def _ref_cbr(sd, rng, pre, cin, cout, kh=3, kw=3):
    """The reference's Conv2dBnRelu: the conv keeps its bias under BN."""
    sd[f"{pre}.conv.weight"] = _ref_conv(rng, cout, cin, kh, kw)
    sd[f"{pre}.conv.bias"] = _ref_vec(rng, cout)
    _ref_bn(sd, rng, f"{pre}.batch_norm", cout)


def _ref_resnet34(sd, rng, prefix):
    """torchvision ResNet-34's keys (no fc) under ``prefix``."""
    sd[f"{prefix}conv1.weight"] = _ref_conv(rng, 64, 3, 7)
    _ref_bn(sd, rng, f"{prefix}bn1", 64)
    cin = 64
    for stage, (w, n) in enumerate(zip(REF_WIDTHS, REF_LAYERS), start=1):
        for i in range(n):
            pre = f"{prefix}layer{stage}.{i}"
            c = cin if i == 0 else w
            sd[f"{pre}.conv1.weight"] = _ref_conv(rng, w, c, 3)
            _ref_bn(sd, rng, f"{pre}.bn1", w)
            sd[f"{pre}.conv2.weight"] = _ref_conv(rng, w, w, 3)
            _ref_bn(sd, rng, f"{pre}.bn2", w)
            if i == 0 and c != w:
                sd[f"{pre}.downsample.0.weight"] = _ref_conv(rng, w, c, 1)
                _ref_bn(sd, rng, f"{pre}.downsample.1", w)
        cin = w


def _ref_decoder(sd, rng, pre, cin, cmid, cout):
    _ref_cbr(sd, rng, f"{pre}.conv1", cin, cmid)
    _ref_cbr(sd, rng, f"{pre}.conv2", cmid, cout)
    hid = max(cout // 16, 1)
    sd[f"{pre}.channel_se.fc.0.weight"] = _ref_conv(rng, hid, cout, 1)[
        :, :, 0, 0]
    sd[f"{pre}.channel_se.fc.0.bias"] = _ref_vec(rng, hid)
    sd[f"{pre}.channel_se.fc.2.weight"] = _ref_conv(rng, cout, hid, 1)[
        :, :, 0, 0]
    sd[f"{pre}.channel_se.fc.2.bias"] = _ref_vec(rng, cout)
    sd[f"{pre}.spatial_se.fc.weight"] = _ref_conv(rng, 1, cout, 1)
    sd[f"{pre}.spatial_se.fc.bias"] = _ref_vec(rng, 1)


def _ref_unet_sd(seed):
    """A seeded state_dict of the reference's flagship, UNetResNet34 with
    scSE decoders and the hypercolumn, under its own key names
    (``encoders.encoder.*``, ``center``, ``dec5..dec1``, ``final``), as
    tests/test_flagship_golden.py builds it at ResNet-18."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sd = {}
    _ref_resnet34(sd, rng, "encoders.encoder.")
    b = 512
    _ref_cbr(sd, rng, "center.0", b, b)
    _ref_cbr(sd, rng, "center.1", b, b // 2)
    _ref_decoder(sd, rng, "dec5", b + b // 2, b, b // 8)
    _ref_decoder(sd, rng, "dec4", b // 2 + b // 8, b // 2, b // 8)
    _ref_decoder(sd, rng, "dec3", b // 4 + b // 8, b // 4, b // 8)
    _ref_decoder(sd, rng, "dec2", b // 8 + b // 8, b // 8, b // 8)
    _ref_decoder(sd, rng, "dec1", b // 8, b // 16, b // 8)
    _ref_cbr(sd, rng, "final.0", 5 * b // 8, b // 8)
    sd["final.1.weight"] = _ref_conv(rng, 2, b // 8, 1)
    sd["final.1.bias"] = _ref_vec(rng, 2)
    return sd


def _ref_encoder_only(seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    sd = {}
    _ref_resnet34(sd, rng, "encoders.encoder.")
    return sd, rng


def _ref_lkm_sd(seed, k=9, ic=21):
    """LargeKernelMatters-34 as the registry builds it (k 9, 21 internal
    channels), tests/test_arch_goldens.py's layout."""
    sd, rng = _ref_encoder_only(seed)
    for stage, cin in zip(range(2, 6), REF_WIDTHS):
        _ref_cbr(sd, rng, f"gcn{stage}.conv1.0", cin, ic, k, 1)
        _ref_cbr(sd, rng, f"gcn{stage}.conv1.1", ic, ic, 1, k)
        _ref_cbr(sd, rng, f"gcn{stage}.conv2.0", cin, ic, 1, k)
        _ref_cbr(sd, rng, f"gcn{stage}.conv2.1", ic, ic, k, 1)
        _ref_cbr(sd, rng, f"enc_br{stage}.conv.0", ic, ic)
        _ref_cbr(sd, rng, f"enc_br{stage}.conv.1", ic, ic)
    for stage in range(2, 6):
        sd[f"deconv{stage}.deconv.weight"] = _ref_conv(rng, ic, ic, 3)
        sd[f"deconv{stage}.deconv.bias"] = _ref_vec(rng, ic)
        _ref_bn(sd, rng, f"deconv{stage}.batch_norm", ic)
    for stage in range(1, 5):
        _ref_cbr(sd, rng, f"dec_br{stage}.conv.0", ic, ic)
        _ref_cbr(sd, rng, f"dec_br{stage}.conv.1", ic, ic)
    sd["final.weight"] = _ref_conv(rng, 2, ic, 1)
    sd["final.bias"] = _ref_vec(rng, 2)
    return sd


def _ref_pspnet_sd(seed, f=1024):
    """PSPNet-34 as the registry builds it (1024 deep features)."""
    import numpy as np
    sd, rng = _ref_encoder_only(seed)
    for i in range(4):
        sd[f"psp.stages.{i}.1.weight"] = _ref_conv(rng, 512, 512, 1)
    sd["psp.bottleneck.weight"] = _ref_conv(rng, f, 512 * 5, 1)
    sd["psp.bottleneck.bias"] = _ref_vec(rng, f)
    c = f
    for up in ("up4", "up3", "up2", "up1"):
        sd[f"{up}.conv.0.weight"] = _ref_conv(rng, c // 2, c, 3)
        sd[f"{up}.conv.0.bias"] = _ref_vec(rng, c // 2)
        _ref_bn(sd, rng, f"{up}.conv.1", c // 2)
        sd[f"{up}.conv.2.weight"] = np.full((1,), 0.2, "f4")
        c //= 2
    _ref_cbr(sd, rng, "final.0", f // 16 * 15, 64)
    sd["final.1.weight"] = _ref_conv(rng, 2, 64, 1)
    sd["final.1.bias"] = _ref_vec(rng, 2)
    return sd


def _ref_depth_sd(seed):
    import numpy as np
    sd = _ref_unet_sd(seed)
    rng = np.random.RandomState(seed + 1)
    c = 5 * 512 // 8
    sd["depth_channel_excitation.fc.0.weight"] = rng.randn(c, 1).astype("f4")
    sd["depth_channel_excitation.fc.0.bias"] = _ref_vec(rng, c)
    return sd


def _ref_emptiness_sd(seed):
    """EmptinessClassifier-34: the torchvision ResNet under ``encoder.*``
    with its ImageNet ``fc`` (which the converter skips), and
    ``classifier.1``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sd = {}
    _ref_resnet34(sd, rng, "encoder.")
    sd["encoder.fc.weight"] = _ref_conv(rng, 1000, 512, 1)[:, :, 0, 0]
    sd["encoder.fc.bias"] = _ref_vec(rng, 1000)
    sd["classifier.1.weight"] = _ref_conv(rng, 2, 512, 1)
    sd["classifier.1.bias"] = _ref_vec(rng, 2)
    return sd


def _ref_stacking_sd(seed, with_depth, n_models=18, filters=32):
    import numpy as np
    rng = np.random.RandomState(seed)
    sd = {}
    _ref_cbr(sd, rng, "conv.0", n_models, filters)
    if with_depth:
        sd["depth_channel_excitation.fc.0.weight"] = rng.randn(
            filters, 1).astype("f4")
        sd["depth_channel_excitation.fc.0.bias"] = _ref_vec(rng, filters)
    sd["final.0.weight"] = _ref_conv(rng, 2, filters, 1)
    sd["final.0.bias"] = _ref_vec(rng, 2)
    return sd


def _ref_unet_logits(sd, x):
    """The reference flagship's forward (architectures/unet.py:89-109,
    eval mode, hypercolumn on) in ``torch.nn.functional`` on the
    state_dict itself, as tests/test_flagship_golden.py:103-187 evaluates
    it at ResNet-18: replication pad of 2 rows on top and 2 columns on the
    right before each decoder conv (base.py:26-31), align-corners bilinear
    upsampling (torch 0.3.1's), the conv biases under BN."""
    import torch
    import torch.nn.functional as F

    def t(k):
        return torch.from_numpy(sd[k]).to(x.device)

    def bn(y, p):
        return F.batch_norm(y, t(f"{p}.running_mean"), t(f"{p}.running_var"),
                            t(f"{p}.weight"), t(f"{p}.bias"), False, 0.9,
                            1e-5)

    def cbr(y, pre):
        y = F.pad(y, (0, 2, 2, 0), mode="replicate")
        y = F.conv2d(y, t(f"{pre}.conv.weight"), t(f"{pre}.conv.bias"))
        return F.relu(bn(y, f"{pre}.batch_norm"))

    def up(y, factor=2):
        return F.interpolate(y, scale_factor=factor, mode="bilinear",
                             align_corners=True)

    def decoder(y, e, pre):
        y = up(y)
        if e is not None:
            y = torch.cat([y, e], 1)
        y = cbr(cbr(y, f"{pre}.conv1"), f"{pre}.conv2")
        g = F.relu(F.linear(y.mean(dim=(2, 3)),
                            t(f"{pre}.channel_se.fc.0.weight"),
                            t(f"{pre}.channel_se.fc.0.bias")))
        g = torch.sigmoid(F.linear(g, t(f"{pre}.channel_se.fc.2.weight"),
                                   t(f"{pre}.channel_se.fc.2.bias")))
        s = torch.sigmoid(F.conv2d(y, t(f"{pre}.spatial_se.fc.weight"),
                                   t(f"{pre}.spatial_se.fc.bias")))
        return F.relu(y * g[:, :, None, None] + y * s)

    pre0 = "encoders.encoder."
    y = F.conv2d(x, t(f"{pre0}conv1.weight"), stride=2, padding=3)
    y = F.relu(bn(y, f"{pre0}bn1"))
    feats = []
    for stage, n in enumerate(REF_LAYERS, start=1):
        for i in range(n):
            pre = f"{pre0}layer{stage}.{i}"
            stride = 2 if stage > 1 and i == 0 else 1
            z = F.relu(bn(F.conv2d(y, t(f"{pre}.conv1.weight"),
                                   stride=stride, padding=1), f"{pre}.bn1"))
            z = bn(F.conv2d(z, t(f"{pre}.conv2.weight"), padding=1),
                   f"{pre}.bn2")
            if f"{pre}.downsample.0.weight" in sd:
                y = bn(F.conv2d(y, t(f"{pre}.downsample.0.weight"),
                                stride=stride), f"{pre}.downsample.1")
            y = F.relu(z + y)
        feats.append(y)
    enc2, enc3, enc4, enc5 = feats
    center = F.avg_pool2d(cbr(cbr(enc5, "center.0"), "center.1"), 2, 2)
    dec5 = decoder(center, enc5, "dec5")
    dec4 = decoder(dec5, enc4, "dec4")
    dec3 = decoder(dec4, enc3, "dec3")
    dec2 = decoder(dec3, enc2, "dec2")
    dec1 = decoder(dec2, None, "dec1")
    hyper = torch.cat([dec1, up(dec2, 2), up(dec3, 4), up(dec4, 8),
                       up(dec5, 16)], 1)
    return F.conv2d(cbr(hyper, "final.0"), t("final.1.weight"),
                    t("final.1.bias"))


def _import_config(arch="UNetResNet", **model):
    """The reference-fidelity build (``conv_pad_mode="reference"``,
    ``upsample_mode="align_corners"``) of ``arch`` at encoder_depth 34,
    bf16, hflip TTA, batch 24."""
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()
    cfg.model.architecture = arch
    cfg.model.encoder_depth = 34
    cfg.model.conv_pad_mode = "reference"
    cfg.model.upsample_mode = "align_corners"
    for k, v in model.items():
        setattr(cfg.model, k, v)
    cfg.postpro.use_tta = True
    cfg.training.batch_size_inference = SERVE_BATCH
    return cfg


def _graft(model, convert, sd):
    """``graft_model`` of ``convert(sd)`` into ``model``; every leaf of
    the model must come from the state_dict."""
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.torch_import import graft_model
    n = graft_model(model, *convert(sd))
    if n != len(to_flax_flat(model)):
        raise AssertionError(f"{type(model).__name__}: {n} leaves grafted "
                             f"of {len(to_flax_flat(model))}")
    return model


@contextlib.contextmanager
def _halo_calls(calls):
    """Append each row-3 call's ``halo`` to ``calls`` while the block runs
    (``ops/conv_pair.py`` looks the kernel up in ``ops.conv_kernel``)."""
    from salt_tpu_torch.ops import conv_kernel as ck
    kernel = ck.conv3x3_pair_kernel

    def observed(x, w, halo=False):
        calls.append(bool(halo))
        return kernel(x, w, halo=halo)

    ck.conv3x3_pair_kernel = observed
    try:
        yield calls
    finally:
        ck.conv3x3_pair_kernel = kernel


def _import_flagship(dev, card):
    """The reference flagship: the direct forward against the grafted
    port model in fp32 on the card, bf16 TTA masks against the CPU's
    fp32, then ``serve`` of the grafted weights as a 2-fold experiment.
    Returns the launches of rows 1 and 3."""
    import copy
    import numpy as np
    import torch
    from salt_tpu_torch.core.experiment import checkpoint_path, save_flat_npz
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.registry import build_model
    from salt_tpu_torch.models.torch_import import convert_unet_resnet
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    from salt_tpu_torch.pipeline.serving import serve
    from salt_tpu_torch.train.steps import SegmentationRunner

    sd = _ref_unet_sd(seed=34)
    cfg = _import_config(pallas_conv="on")
    model = _graft(build_model(cfg.model), convert_unet_resnet, sd)
    x = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
    x = x.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        want = _ref_unet_logits(sd, x)
        card_model = copy.deepcopy(model).to(
            dev, memory_format=torch.channels_last)
        got = card_model(x.to(dev)).cpu()
        got_infer = card_model(x.to(dev), infer=True).cpu()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got_infer, want, rtol=2e-3, atol=2e-3)

    bundle = synthetic_bundle(N_IMPORT_TTA, seed=7, with_masks=False)
    cpu_cfg = _import_config(pallas_conv="on")
    cpu_cfg.training.dtype = "float32"
    cpu_runner = SegmentationRunner(cpu_cfg, "cpu")
    p_cpu = cpu_runner.predict_dataset(cpu_runner.place(copy.deepcopy(model)),
                                       bundle.images, tta=True)
    runner = SegmentationRunner(cfg, dev)
    bf16_model = runner.place(copy.deepcopy(model))
    ck.launches = 0
    with _halo_calls([]) as halo:
        p_card = runner.predict_dataset(bf16_model, bundle.images, tta=True)
        torch.cuda.synchronize()
    forwards = math.ceil(N_IMPORT_TTA / SERVE_BATCH)
    if (ck.launches != IMPORT_CONV_PER_FORWARD * forwards
            or sum(halo) != IMPORT_HALO_PER_FORWARD * forwards
            or not np.isfinite(p_card).all()):
        raise AssertionError(f"import TTA: row 3 launched {ck.launches} "
                             f"times ({sum(halo)} halo) in {forwards} "
                             "forwards, or non-finite probabilities")
    threshold = float(np.median(p_cpu[:, 1]))
    delta, undecidable = margin_rule(
        "imported flagship bf16 card vs fp32 CPU", p_card[:, 1], p_cpu[:, 1],
        p_card[:, 1] > threshold, p_cpu[:, 1] > threshold, threshold)
    del bf16_model, card_model

    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "imported")
        flat = to_flax_flat(model)
        for fold in range(N_FOLDS):
            save_flat_npz(checkpoint_path(exp, f"network_fold_{fold}"), flat)
        with open(os.path.join(exp, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
        out_csv = os.path.join(tmp, "submission.csv")
        pk.launches = ck.launches = 0
        with _halo_calls([]) as halo:
            t0 = time.perf_counter()
            result = serve(_import_config(), exp, "", out_csv,
                           synthetic=N_SERVE_IMAGES, device=dev)
            wall = time.perf_counter() - t0
        counts = dict(preprocess=pk.launches, conv=ck.launches)
        ids, masks = _csv_masks(out_csv)
    forwards = result["batches"] + result["warmup_batches"]
    want_counts = dict(preprocess=forwards,
                       conv=IMPORT_CONV_PER_FORWARD * forwards)
    if (counts != want_counts or len(ids) != N_SERVE_IMAGES
            or sum(halo) != IMPORT_HALO_PER_FORWARD * forwards
            or result["batches"] != N_FOLDS * math.ceil(
                N_SERVE_IMAGES / SERVE_BATCH)):
        raise AssertionError(f"imported serve: {result}, launches {counts} "
                             f"({sum(halo)} halo), expected {want_counts}")
    log("import", arch="UNetResNet-34 (reference checkpoint)",
        leaves=len(to_flax_flat(model)), fp32_vs_direct=float(
            (got - want).abs().max()),
        fp32_infer_vs_direct=float((got_infer - want).abs().max()),
        logit_scale=float(want.abs().max()), tta_images=N_IMPORT_TTA,
        tta_prob_delta=delta, tta_undecidable_px=undecidable,
        mask_threshold=threshold, card=repr(card))
    log("import_serve", images=N_SERVE_IMAGES, folds=N_FOLDS,
        batch=SERVE_BATCH, tta="hflip", dtype=cfg.training.dtype,
        pad="reference", upsample="align_corners", pallas_conv="on",
        images_per_s=result["images_per_sec"],
        timed_s=f"{result['seconds']:.3f}", wall_s=f"{wall:.3f}",
        batches=result["batches"], warmup_batches=result["warmup_batches"],
        preprocess_launches=counts["preprocess"],
        conv_launches=counts["conv"], conv_halo_launches=sum(halo),
        salt_fraction=f"{float(masks.mean()):.4f}", card=repr(card))
    return counts


def phase_import(dev, card):
    """Whole reference checkpoints through the port's converters
    (``models/torch_import.py``) at full width: the flagship
    (:func:`_import_flagship`), then LKM-34, PSPNet-34,
    UNetResNetWithDepth-34, EmptinessClassifier-34 and StackingFCN with
    and without depth (18 inputs, 32 filters), each from a seeded
    reference state_dict, grafted, fp32 logits on the card (TF32 off)
    against the same model on the CPU at rtol=atol=2e-3. Returns the
    launches of rows 1 and 3."""
    import copy
    import torch
    from salt_tpu_torch.models import torch_import as ti
    from salt_tpu_torch.models.emptiness import EmptinessClassifier
    from salt_tpu_torch.models.registry import build_model
    from salt_tpu_torch.models.stacking import (StackingFCN,
                                                StackingFCNWithDepth)
    from salt_tpu_torch.ops.preprocess import preprocess_inference

    t_phase = time.perf_counter()
    counts = _import_flagship(dev, card)
    cells = (
        ("LargeKernelMatters-34", _ref_lkm_sd, ti.convert_lkm,
         lambda: build_model(_import_config("LargeKernelMatters").model)),
        ("PSPNet-34", _ref_pspnet_sd, ti.convert_pspnet,
         lambda: build_model(_import_config("PSPNet").model)),
        ("UNetResNetWithDepth-34", _ref_depth_sd,
         ti.convert_unet_resnet_with_depth,
         lambda: build_model(_import_config("UNetResNetWithDepth").model)),
        ("EmptinessClassifier-34", _ref_emptiness_sd, ti.convert_emptiness,
         lambda: EmptinessClassifier(encoder_depth=34)),
        ("StackingFCN", lambda s: _ref_stacking_sd(s, False),
         ti.convert_stacking_fcn,
         lambda: StackingFCN(pad_mode="reference")),
        ("StackingFCNWithDepth", lambda s: _ref_stacking_sd(s, True),
         ti.convert_stacking_fcn,
         lambda: StackingFCNWithDepth(pad_mode="reference")),
    )
    images = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
    images = images.permute(0, 3, 1, 2).contiguous()
    stacked = torch.rand(2, 18, 128, 128,
                         generator=torch.Generator().manual_seed(4))
    depth = torch.tensor([[0.25], [0.8]])
    for seed, (name, make_sd, convert, make_model) in enumerate(cells, 35):
        model = _graft(make_model(), convert, make_sd(seed)).eval()
        x = stacked if name.startswith("Stacking") else images
        d = depth if model.takes_depth else None
        with torch.no_grad():
            cpu = model(x, depth=d)
            card_model = copy.deepcopy(model).to(
                dev, memory_format=torch.channels_last)
            got = card_model(x.to(dev), depth=None if d is None
                             else d.to(dev)).cpu()
        torch.testing.assert_close(got, cpu, rtol=2e-3, atol=2e-3)
        log("import", arch=name, params=sum(p.numel()
                                            for p in model.parameters()),
            logits=list(cpu.shape), fp32_vs_cpu=float((got - cpu).abs().max()),
            logit_scale=float(cpu.abs().max()), card=repr(card))
    log("import", phase_wall_s=f"{time.perf_counter() - t_phase:.3f}")
    return counts


# -- distill_curve: a teacher, the curve's students, the bench's context -----

#: the teacher's CV and the curve's bundle: 480 synthetic images of the
#: calibrated "real" difficulty, 2 folds of the teacher, 1 epoch each
#: (the JAX tool's defaults: 3000 images, 80 epochs; depth only)
N_DISTILL = 480
DISTILL_FOLDS = 2
DISTILL_SEED = 0
#: the curve's batches (tools/distill_curve.py) and the TTA probe's steps
#: (train/throughput.py: a warm-up step and 3 windows of 25)
DISTILL_TRAIN_BATCH, DISTILL_INFER_BATCH = 128, 64
PROBE_STEPS = 1 + 3 * 25


def _int8_sites_of(model):
    """(wgmma, mma) int8 convs of one infer forward of a scratch net:
    every ConvBnRelu's conv (stride 1, SAME), on the path
    ``ops/int8_conv.py::conv_path`` gives its weight's shape."""
    from salt_tpu_torch.ops.int8_conv import conv_path
    paths = [conv_path((1, m.Conv_0.weight.shape[1], 8, 8),
                       tuple(m.Conv_0.weight.shape), 1, 1, 1)
             for m in model.modules() if type(m).__name__ == "ConvBnRelu"]
    return paths.count("wgmma"), paths.count("mma")


def _distill_teacher(teacher, card):
    """``cli train-evaluate-predict-cv`` of the flagship (bf16, hflip TTA,
    row 3 "on") on N_DISTILL synthetic images of the "real" difficulty:
    its out-of-fold predictions are the students' soft targets."""
    n_valid = N_DISTILL // DISTILL_FOLDS
    n_test = max(N_DISTILL // 4, 8)
    val_b = math.ceil(n_valid / SERVE_BATCH)
    test_b = math.ceil(n_test / SERVE_BATCH)
    steps = (N_DISTILL - n_valid) // TRAIN_BATCH
    want = dict(conv=CONV_KERNEL_PER_FORWARD * DISTILL_FOLDS
                * (2 * val_b + test_b),
                preprocess=DISTILL_FOLDS * (3 * val_b + test_b),
                sort=DISTILL_FOLDS * (steps + val_b))
    wall, counts = _fs_command(
        ["train-evaluate-predict-cv", "--synthetic", str(N_DISTILL),
         "--synthetic-difficulty", "real", "--epochs", "1",
         "--set", f"execution.seed={DISTILL_SEED}",
         "--set", f"paths.experiment_dir={teacher}",
         "--set", "postpro.use_tta=true", "--set", "model.pallas_conv=on",
         "--set", f"execution.n_cv_splits={DISTILL_FOLDS}",
         "--set", f"training.batch_size_train={TRAIN_BATCH}",
         "--set", f"training.batch_size_inference={SERVE_BATCH}"],
        want, "train-evaluate-predict-cv", card, phase="distill_teacher")
    with open(os.path.join(teacher, "cv_scores.json")) as f:
        scores = json.load(f)
    log("distill_teacher", images=N_DISTILL, folds=DISTILL_FOLDS,
        difficulty="real", wall_s=f"{wall:.3f}",
        fold_iout=[round(v, 5) for v in scores["fold_iout"]], **counts,
        card=repr(card))
    return counts


def phase_distill_curve(dev, card, bar):
    """``python -m salt_tpu_torch.tools.distill_curve`` as a user runs it
    (its ``main``, in this process): a teacher (:func:`_distill_teacher`),
    then each of the five students at the tool's widths and batches (128
    train, 64 inference) for 1 epoch with the TTA probe, one student a
    call so that each one's launches of rows 1, 2, 8 and 9 are held
    against its configuration's (rows 8 and 9 from ``saltunet32_int8``
    alone, row 3 from none); a last call gathers the curve from the
    reports. Then the bench's ``emit_distill_context`` (``bar``: this
    run's ``flagship_tta_int8`` images/s) and ``measure_serve_student``
    (``serve --synthetic 2048`` of the newest student, int8, batch 64).
    Returns the launches."""
    import torch
    from salt_tpu_torch.core.config import load_config
    from salt_tpu_torch.models.registry import build_model
    from salt_tpu_torch.tools import bench
    from salt_tpu_torch.tools import distill_curve as dc

    t_phase = time.perf_counter()
    total = dict(preprocess=0, sort=0, conv=0, **_int8_want(0))
    with tempfile.TemporaryDirectory() as tmp:
        teacher = os.path.join(tmp, "teacher")
        for k, v in _distill_teacher(teacher, card).items():
            total[k] += v
        argv = ["--teacher", teacher, "--n-images", str(N_DISTILL),
                "--epochs", "1", "--seed", str(DISTILL_SEED)]
        for name, sets in dc.STUDENTS.items():
            _fs_reset()
            _int8_reset()
            t0 = time.perf_counter()
            dc.main(argv + ["--students", name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(_fs_counts(), **_int8_counts())
            with open(os.path.join(dc.student_dir(teacher, name),
                                   "distill_report.json")) as f:
                rep = json.load(f)
            steps = rep["n_train"] // DISTILL_TRAIN_BATCH
            val_b = math.ceil(rep["n_valid"] / DISTILL_INFER_BATCH)
            # fit's validation (predict + loss), the report's TTA predict,
            # the probe; every infer forward quantizes for int8
            forwards = 2 * val_b + PROBE_STEPS
            want = dict(preprocess=3 * val_b + PROBE_STEPS,
                        sort=steps + val_b, conv=0, **_int8_want(0))
            if sets.get("model.quant_bits") == 8:
                cfg = load_config(None, {**sets, "training.dtype":
                                         "bfloat16"})
                wgmma, mma = _int8_sites_of(build_model(cfg.model))
                want.update(int8_conv=(wgmma + mma) * forwards,
                            int8_wgmma=wgmma * forwards,
                            int8_mma=mma * forwards,
                            int8_quant=2 * (wgmma + mma) * forwards)
            if counts != want:
                raise AssertionError(f"distill_curve {name}: launches "
                                     f"{counts}, expected {want}")
            ips = rep["student_tta_images_per_sec"]
            log("distill_student", student=name, wall_s=f"{wall:.3f}",
                n_train=rep["n_train"], n_valid=rep["n_valid"], epochs=1,
                tta_images_per_s=ips,
                vs_flagship_tta_int8=f"{ips / bar:.4f}",
                student_iout=f"{rep['student_iout']:.5f}",
                teacher_iout=f"{rep['teacher_iout']:.5f}",
                iout_delta=f"{rep['iout_delta']:+.5f}",
                quality="none: 1 epoch on 480 images, a check of the path",
                **counts, card=repr(card))
            for k in total:
                total[k] += counts[k]
        _fs_reset()
        _int8_reset()
        curve = dc.main(argv)               # every report on disk: no run
        if (list(curve["students"]) != list(dc.STUDENTS)
                or any(_fs_counts().values())
                or any(_int8_counts().values())):
            raise AssertionError(f"distill_curve gather: {curve}")
        context = bench.emit_distill_context(tmp, bar)
        if set(context) != {f"distill_{n}" for n in dc.STUDENTS}:
            raise AssertionError(f"bench distill context: {context}")
        qualified = bench.qualified_student_fields(context, bar)
        _fs_reset()
        _int8_reset()
        served = bench.measure_serve_student(
            bench.bench_config(False, quant_bits=8), tmp, dev)
        counts = dict(_fs_counts(), **_int8_counts())
        newest = max(dc.STUDENTS, key=lambda n: os.path.getmtime(
            os.path.join(dc.student_dir(teacher, n), "distill_report.json")))
    forwards = counts["preprocess"]
    if (served["student"] != f"distill_{newest}"
            or served["quant_bits"] != 8 or forwards == 0
            or counts["int8_conv"] % forwards or counts["int8_conv"] == 0
            or counts["int8_quant"] != 2 * counts["int8_conv"]
            or counts["sort"] or counts["conv"]):
        raise AssertionError(f"bench serve_student: {served}, launches "
                             f"{counts}")
    log("distill_bench", students=len(context), bar_flagship_tta_int8=bar,
        qualified=qualified or None, serve_student=served["student"],
        serve_student_architecture=served["architecture"],
        serve_student_images_per_s=served["value"],
        serve_student_quant_bits=served["quant_bits"],
        serve_student_seconds=f"{served['seconds']:.3f}",
        int8_convs_per_forward=counts["int8_conv"] // forwards, **counts,
        card=repr(card))
    for k in total:
        total[k] += counts[k]
    log("distill_curve", phase_wall_s=f"{time.perf_counter() - t_phase:.3f}",
        **{f"{k}_launches": v for k, v in total.items()}, card=repr(card))
    return total


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import salt_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(salt_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    name, smi = phase_device()
    phase_build()
    preprocess = phase_kernel(dev)
    sort = phase_sort_kernel(dev)
    conv = phase_conv_kernel(dev)
    probe_launches = phase_probe_path(smi)
    probes = phase_probe_kernels(dev, smi)
    phase_model(dev)
    phase_profile(dev, smi, "off")
    phase_profile(dev, smi, "on")
    ab_launches = phase_ab(smi)
    serve_preprocess, serve_conv = phase_serve(dev, smi)
    phase_train_step(dev)
    train_sort, train_preprocess = phase_train(dev, smi)
    phase_train_profile(dev, smi)
    cv_on, cv_off, cv_int8 = phase_cv(smi)
    fold_parallel = phase_fold_parallel(dev, smi)
    tooling = phase_tooling(dev, smi)
    dp_sort = phase_data_parallel(dev, smi)
    meta = phase_metadata(smi)
    synthetic_preprocess = phase_serve_synthetic(dev, smi)
    salt_unet = phase_salt_unet(dev, smi)
    phase_losses(dev)
    arch = phase_arch(dev, smi)
    arch2 = phase_arch2(dev, smi)
    imported = phase_import(dev, smi)
    full = phase_full_solution(dev, smi)
    int8_wgmma, int8_conv, int8_quant, int8 = phase_int8(dev, smi)
    bench_counts, bar = phase_bench(smi)
    distill = phase_distill_curve(dev, smi, bar)
    preprocess["launches"] = (serve_preprocess + train_preprocess
                              + cv_on["preprocess"] + cv_off["preprocess"]
                              + cv_int8["preprocess"]
                              + meta["preprocess"] + synthetic_preprocess
                              + salt_unet["preprocess"]
                              + bench_counts["preprocess"]
                              + arch["preprocess"] + arch2["preprocess"]
                              + full["preprocess"] + int8["preprocess"]
                              + fold_parallel["preprocess"]
                              + tooling["preprocess"]
                              + imported["preprocess"]
                              + distill["preprocess"])
    sort["launches"] = (train_sort + cv_on["sort"] + meta["sort"]
                        + salt_unet["sort"] + bench_counts["sort"]
                        + arch["sort"] + arch2["sort"] + full["sort"]
                        + fold_parallel["sort"] + tooling["sort"] + dp_sort
                        + distill["sort"])
    conv["launches"] = (serve_conv + cv_on["conv"] + ab_launches
                        + arch["conv"] + arch2["conv"] + full["conv"]
                        + int8["conv"] + fold_parallel["conv"]
                        + tooling["conv"] + imported["conv"]
                        + distill["conv"])
    int8_wgmma["launches"] = (int8["int8_wgmma"] + cv_int8["int8_wgmma"]
                              + bench_counts["int8_wgmma"]
                              + distill["int8_wgmma"])
    int8_conv["launches"] = (int8["int8_mma"] + cv_int8["int8_mma"]
                             + bench_counts["int8_mma"] + distill["int8_mma"])
    int8_quant["launches"] = (int8["int8_quant"] + cv_int8["int8_quant"]
                              + bench_counts["int8_quant"]
                              + distill["int8_quant"])
    for key, count in probe_launches.items():
        probes[key]["launches"] = count
    log("launches", preprocess_serve=serve_preprocess,
        preprocess_train=train_preprocess,
        preprocess_cv=cv_on["preprocess"] + cv_off["preprocess"],
        preprocess_int8_gate=cv_int8["preprocess"],
        preprocess_metadata=meta["preprocess"],
        preprocess_serve_synthetic=synthetic_preprocess,
        preprocess_salt_unet=salt_unet["preprocess"],
        preprocess_bench=bench_counts["preprocess"],
        preprocess_arch=arch["preprocess"],
        preprocess_arch2=arch2["preprocess"],
        preprocess_full_solution=full["preprocess"],
        preprocess_int8=int8["preprocess"],
        preprocess_fold_parallel=fold_parallel["preprocess"],
        preprocess_tooling=tooling["preprocess"],
        preprocess_import=imported["preprocess"],
        preprocess_distill_curve=distill["preprocess"],
        sort_distill_curve=distill["sort"], conv_import=imported["conv"],
        conv_distill_curve=distill["conv"],
        int8_conv_wgmma_distill_curve=distill["int8_wgmma"],
        int8_conv_distill_curve=distill["int8_mma"],
        int8_quant_distill_curve=distill["int8_quant"], sort_train=train_sort,
        sort_fold_parallel=fold_parallel["sort"],
        sort_tooling=tooling["sort"], sort_data_parallel=dp_sort,
        conv_fold_parallel=fold_parallel["conv"],
        conv_tooling=tooling["conv"],
        sort_cv=cv_on["sort"], sort_metadata=meta["sort"],
        sort_salt_unet=salt_unet["sort"], sort_bench=bench_counts["sort"],
        sort_arch=arch["sort"], sort_arch2=arch2["sort"],
        sort_full_solution=full["sort"],
        conv_serve=serve_conv, conv_cv=cv_on["conv"], conv_ab=ab_launches,
        conv_arch=arch["conv"], conv_full_solution=full["conv"],
        conv_int8=int8["conv"],
        int8_conv_wgmma_int8=int8["int8_wgmma"],
        int8_conv_wgmma_gate=cv_int8["int8_wgmma"],
        int8_conv_wgmma_bench=bench_counts["int8_wgmma"],
        int8_conv_int8=int8["int8_mma"], int8_conv_gate=cv_int8["int8_mma"],
        int8_conv_bench=bench_counts["int8_mma"],
        int8_quant_int8=int8["int8_quant"],
        int8_quant_gate=cv_int8["int8_quant"],
        int8_quant_bench=bench_counts["int8_quant"], **probe_launches)
    print(json.dumps({"kernels": [
        preprocess, sort, conv, probes["conv128"], probes["conv64p"],
        probes["matmul"], probes["conv64p_v2"], int8_quant, int8_wgmma,
        int8_conv]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
