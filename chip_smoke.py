#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the flagship
UNetResNet34 hflip-TTA ``serve`` path at full width, end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — every CUDA kernel, from the sources in the checkout;
3. kernel  — each kernel against its plain PyTorch version on the card at
             the shapes the serve path gives it, and its time beside the
             plain version's and its bound;
4. model   — the flagship at full width from seeded weights: fp32 forward
             on the card (TF32 off) against the CPU, bf16 against fp32;
5. serve   — a 2-fold CV experiment directory of seeded weights and 2048
             seeded PNGs through ``salt_tpu_torch.pipeline.serving.serve``
             (hflip TTA, batch 24, bf16); the kernel launch counts are set
             to 0 just before and read just after.
It then prints one JSON line of kernel records and, last, one JSON line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it prints no result and exits non-zero.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so the fp32 comparison of
phase 4 is a real fp32 one; the bf16 serve path does not use TF32.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores

N_SERVE_IMAGES = 2048
N_FOLDS = 2
SERVE_BATCH = 24
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


def _self_device_us(event):
    """A profiler row's own device time in us; 0 for host-side rows (an
    aten op row repeats the time of the kernels it launched)."""
    import torch
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_ms(fn, match="", iters=50):
    """Device time per call of ``fn`` from ``torch.profiler``: the CUDA
    kernels' own time (those whose name contains ``match``) over
    ``iters`` calls. 0.0 when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_self_device_us(e) for e in prof.key_averages()
               if match in e.key) / iters / 1e3


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
    to bf16, at B = 1, 5 and 48 (48 = 24 images x 2 TTA passes, the serve
    batch). Times are at B = 48, bf16 output, as serve calls it."""
    import torch
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    max_err = 0.0
    for b in (1, 5, 48):
        imgs = torch.from_numpy(seeded_images(b, seed=b)).to(dev)
        imgs[0, 0, :7] = torch.tensor([0, 1, 127, 128, 254, 255, 3])
        want = preprocess_inference(imgs)
        got = pk.preprocess_inference_kernel(imgs, torch.float32)
        got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        want16 = want.to(torch.bfloat16).float()
        ulps = float(((got16.float() - want16).abs()
                      / (want16.abs() * 2.0 ** -7 + 1e-30)).max())
        if got.shape != (b, 128, 128, 3) or not err <= 1e-5 or ulps > 1.0:
            raise AssertionError(f"preprocess kernel B={b}: max_abs_err "
                                 f"{err} (fp32, atol 1e-5), {ulps} bf16 ulp")
        max_err = max(max_err, err)
        log("kernel", name="preprocess_inference", batch=b,
            fp32_max_abs_err=err, bf16_max_ulp=ulps)

    b = 2 * SERVE_BATCH
    imgs = torch.from_numpy(seeded_images(b, seed=7)).to(dev)

    def kernel():
        return pk.preprocess_inference_kernel(imgs)

    def plain():
        return preprocess_inference(imgs, "edge", torch.bfloat16)

    # device time per call from the profiler; back-to-back CUDA events
    # measure the host's enqueue rate for a kernel this short
    ms = device_ms(kernel, match="preprocess_inference_kernel")
    plain_ms = device_ms(plain)
    enqueue_ms, plain_enqueue_ms = time_ms(kernel), time_ms(plain)
    timed_by = "profiler"
    if ms == 0.0 or plain_ms == 0.0:
        ms, plain_ms, timed_by = enqueue_ms, plain_enqueue_ms, "events"
    bytes_moved = b * (101 * 101 + 128 * 128 * 3 * 2)
    flops = b * 128 * 128 * 6           # /255, -mean, /std, ramp, x*ramp
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS
                else "operations")
    log("kernel", name="preprocess_inference", batch=b, ms=f"{ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_s * 1e3:.5f}",
        bound_by=bound_by, bytes=bytes_moved, timed_by=timed_by,
        enqueue_ms=f"{enqueue_ms:.5f}",
        plain_enqueue_ms=f"{plain_enqueue_ms:.5f}")
    return {"name": "preprocess_inference", "route": "cuda",
            "source": "salt_tpu_torch/csrc/preprocess.cu",
            "replaces": "salt_tpu/ops/pallas_preprocess.py:38",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None}


def phase_model(dev):
    """Full-width UNetResNet34 from seed 0. fp32 on the card vs the CPU at
    rtol=atol=2e-3 (the whole-model tolerance of the CPU parity tests).
    bf16 vs fp32 on the card: max |d logits| <= 0.1 * max |fp32 logits|,
    because bf16 keeps 8 significant bits and its rounding compounds
    through ~70 convolution/BN layers; the tolerance bounds a drift, it
    does not claim agreement digit for digit."""
    import torch
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    cfg = default_config()
    x = preprocess_inference(torch.from_numpy(seeded_images(2, seed=3)))
    x = x.permute(0, 3, 1, 2)
    model = init_seeded(build_model(cfg.model), seed=0)
    with torch.no_grad():
        cpu = model(x)
        model = model.to(dev, memory_format=torch.channels_last)
        fp32 = model(x.to(dev))
        model.set_compute_dtype(torch.bfloat16)
        bf16 = model(x.to(dev))
    torch.cuda.synchronize()
    err32 = float((fp32.cpu() - cpu).abs().max())
    torch.testing.assert_close(fp32.cpu(), cpu, rtol=2e-3, atol=2e-3)
    scale = float(fp32.abs().max())
    err16 = float((bf16 - fp32).abs().max())
    if not (torch.isfinite(bf16).all() and err16 <= 0.1 * scale):
        raise AssertionError(f"bf16 vs fp32 logits: max err {err16}, "
                             f"logit scale {scale}")
    log("model", arch="UNetResNet34", params=sum(
        p.numel() for p in model.parameters()), fp32_vs_cpu=err32,
        bf16_vs_fp32=err16, logit_scale=scale)


def phase_profile(dev, card, steps=5, top=12):
    """Where one serve batch's time goes: the bf16 flagship hflip-TTA step
    on SERVE_BATCH images, ``steps`` steps under ``torch.profiler``. Host
    wall time per step (synchronized), device kernel time per step, the
    device's busy share of the wall time, and the kernels that take the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = default_config()
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            runner.predict_tta_step(model, imgs)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    device_ms_step = sum(_self_device_us(e) for e in events) / steps / 1e3
    log("profile", step="predict_tta_step", images=SERVE_BATCH,
        dtype=cfg.training.dtype, wall_ms=f"{wall_ms:.3f}",
        device_ms=f"{device_ms_step:.3f}",
        busy_share=f"{device_ms_step / wall_ms:.3f}", gflop=f"{gflop:.1f}",
        tflops_on_wall=f"{gflop / wall_ms:.1f}",
        tflops_on_device=f"{gflop / device_ms_step:.1f}", card=repr(card))
    events.sort(key=_self_device_us, reverse=True)
    for e in events[:top]:
        log("profile", kernel=repr(e.key[:90]), calls_per_step=e.count // steps,
            device_ms_per_step=f"{_self_device_us(e) / steps / 1e3:.3f}")


def phase_serve(dev, card):
    import numpy as np
    import torch
    from PIL import Image
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import checkpoint_path, save_flat_npz
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.registry import build_model, init_seeded
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
    return launches


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
    record = phase_kernel(dev)
    phase_model(dev)
    phase_profile(dev, smi)
    record["launches"] = phase_serve(dev, smi)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
