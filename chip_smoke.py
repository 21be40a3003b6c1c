#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the flagship
UNetResNet34 at full width, end to end, on its two paths — hflip-TTA
``serve`` and ``train``.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. device     — the card's name, and its name and power limit from
                nvidia-smi;
2. build      — every CUDA kernel, from the sources in the checkout, one
                nvcc per source, all at once;
3. kernel     — each kernel against its plain PyTorch version on the card
                at the shapes its path gives it, and its time beside the
                plain version's, a library call's where there is one, and
                its bound;
4. model      — the flagship from seeded weights: fp32 forward on the card
                (TF32 off) against the CPU, bf16 against fp32;
5. profile    — where one bf16 serve step's device time goes;
6. serve      — a 2-fold CV experiment directory of seeded weights and
                2048 seeded PNGs through ``pipeline.serving.serve`` (hflip
                TTA, batch 24, bf16);
7. train step — one fp32 train step of the flagship on the card against
                the CPU, from the same weights and augmentation draws;
8. train      — ``pipeline.api.train`` on 480 synthetic images (fold 0:
                400 train / 80 valid, 16 steps per epoch), 2 epochs, bf16,
                batch 24; its ``best.npz`` then served;
9. train profile — where one bf16 train step's device time goes.
Each path's kernel launch counts are set to 0 just before it runs and read
just after. The script then prints one JSON line of kernel records and,
last, one JSON line ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it prints no result and exits
non-zero.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so the fp32 comparisons are
real fp32 ones; the bf16 paths do not use TF32.
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
TRAIN_BATCH = 24
SORT_LENGTH = 2 * 128 * 128       # one image's logits in the Lovász hinge
N_TRAIN_IMAGES = 480              # fold 0 of 6: 400 train / 80 valid
TRAIN_EPOCHS = 2
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
    aten op row repeats the time of the kernels it launched) and for
    annotation ranges on the device's timeline (``Optimizer.step#...``
    spans the kernels it launched, which have rows of their own)."""
    import torch
    if (event.device_type != torch.autograd.DeviceType.CUDA
            or getattr(event, "is_user_annotation", False)):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_ms(fn, match="", iters=50):
    """Device time per call of ``fn`` from ``torch.profiler``: with
    ``match``, the mean time of one launch of the kernels whose name
    contains it (the kernels here launch once per call; dividing by the
    launches the profiler recorded, not by ``iters``, keeps a run whose
    trace dropped events right); without, all CUDA kernels' own time
    over ``iters`` calls. 0.0 when the profiler records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if match in e.key and _self_device_us(e) > 0]
    calls = sum(e.count for e in rows) if match else iters
    return sum(_self_device_us(e) for e in rows) / max(calls, 1) / 1e3


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


def _sort_inputs(b, p, ties, seed):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    keys = rng.randn(b, p).astype(np.float32)
    if ties:
        keys = np.round(keys * 4) / 4
    payload = ((rng.randint(0, 2, (b, p)) << 20)
               | np.arange(p)).astype(np.int32)
    return torch.from_numpy(keys), torch.from_numpy(payload)


def phase_sort_kernel(dev):
    """The bitonic sort kernel against the plain network on the card:
    keys and payload bit-identical, with and without ties, at 1, 5 and 24
    rows of 32,768 (24 = the train batch) and at (3, 1024). The Lovász
    hinge through the kernel against the same loss on the CPU, where the
    plain network sorts: value and gradient at rtol 1e-5 / atol 1e-7 (the
    sort is the same permutation; the CPU and the card sum the 32,768
    terms in another order). Times at 24 x 32,768, as a train step calls
    it: the kernel, the plain network, and ``torch.sort`` (stable,
    descending) with the payload gathered along, the library yardstick."""
    import torch
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.ops.bitonic import bitonic_sort_desc
    for b, p in ((1, SORT_LENGTH), (5, SORT_LENGTH), (TRAIN_BATCH, SORT_LENGTH),
                 (3, 1024)):
        for ties in (False, True):
            keys, payload = _sort_inputs(b, p, ties, seed=b)
            keys, payload = keys.to(dev), payload.to(dev)
            got_k, got_p = sk.sort_desc(keys, payload)
            torch.cuda.synchronize()
            want_k, want_p = bitonic_sort_desc(keys, payload)
            same = (torch.equal(got_k.view(torch.int32),
                                want_k.view(torch.int32))
                    and torch.equal(got_p, want_p))
            if not same:
                raise AssertionError(f"sort kernel ({b}, {p}) ties={ties}: "
                                     "not bit-identical to the network")
            log("kernel", name="bitonic_sort_desc", rows=b, length=p,
                ties=ties, bit_identical=same)

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

    keys, payload = _sort_inputs(TRAIN_BATCH, SORT_LENGTH, False, seed=11)
    keys, payload = keys.to(dev), payload.to(dev)

    def kernel():
        return sk.sort_desc(keys, payload)

    def plain():
        return bitonic_sort_desc(keys, payload)

    def library():
        values, idx = torch.sort(keys, dim=1, descending=True, stable=True)
        return values, payload.gather(1, idx)

    ms = device_ms(kernel, match="bitonic_sort_desc_kernel", iters=20)
    plain_ms = device_ms(plain, iters=5)
    library_ms = device_ms(library, iters=20)
    events = dict(ms=time_ms(kernel, 50, 5), plain_ms=time_ms(plain, 5, 2),
                  library_ms=time_ms(library, 50, 5))
    timed_by = "profiler"
    if ms == 0.0 or plain_ms == 0.0 or library_ms == 0.0:
        ms, plain_ms, library_ms = (events["ms"], events["plain_ms"],
                                    events["library_ms"])
        timed_by = "events"
    n = TRAIN_BATCH * SORT_LENGTH
    bytes_moved = n * 16            # keys and payload, read once, written once
    n_exp = SORT_LENGTH.bit_length() - 1
    compare_exchanges = n_exp * (n_exp + 1) // 2 * (n // 2)
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, compare_exchanges / FP32_FLOPS)
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                >= compare_exchanges / FP32_FLOPS else "operations")
    log("kernel", name="bitonic_sort_desc", rows=TRAIN_BATCH,
        length=SORT_LENGTH, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        library_ms=f"{library_ms:.5f}", bound_ms=f"{bound_s * 1e3:.5f}",
        bound_by=bound_by, bytes=bytes_moved,
        compare_exchanges=compare_exchanges, timed_by=timed_by,
        events_ms=f"{events['ms']:.5f}",
        events_plain_ms=f"{events['plain_ms']:.5f}",
        events_library_ms=f"{events['library_ms']:.5f}")
    return {"name": "bitonic_sort_desc", "route": "cuda",
            "source": "salt_tpu_torch/csrc/bitonic_sort.cu",
            "replaces": "salt_tpu/ops/pallas_sort.py:46",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms}


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
        sk.launches = 0
        pk.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        api.train(cfg, experiment, bundle, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sort_launches, pre_launches = sk.launches, pk.launches
        peak = torch.cuda.max_memory_allocated()
        get_logger().removeHandler(times.handler)

        train_steps = TRAIN_EPOCHS * steps_per_epoch
        if sort_launches != train_steps + TRAIN_EPOCHS * val_batches:
            raise AssertionError(
                f"sort kernel launched {sort_launches} times for "
                f"{train_steps} train steps + {TRAIN_EPOCHS * val_batches} "
                "validation-loss batches")
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
        preprocess_launches=pre_launches,
        train_loss=[round(e["train_loss"], 5) for e in epochs],
        val_iout=[round(e["iout"], 5) for e in epochs],
        served_images=served["n"], card=repr(card))
    return sort_launches, pre_launches


def phase_train_profile(dev, card, steps=5, top=14):
    """Where one bf16 train step's time goes (24 images, the flagship at
    full width): host wall and device ms per step, the busy share,
    GFLOP (conv + matmul, forward and backward) and TFLOP/s, the top
    kernels, and the sort kernel's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from salt_tpu_torch.core.config import default_config
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            float(step(i))
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    device_ms_step = sum(_self_device_us(e) for e in events) / steps / 1e3
    sort_ms = sum(_self_device_us(e) for e in events
                  if "bitonic_sort_desc_kernel" in e.key) / steps / 1e3
    log("train_profile", step="train_step", images=TRAIN_BATCH,
        dtype=cfg.training.dtype, wall_ms=f"{wall_ms:.3f}",
        device_ms=f"{device_ms_step:.3f}",
        busy_share=f"{device_ms_step / wall_ms:.3f}", gflop=f"{gflop:.1f}",
        tflops_on_wall=f"{gflop / wall_ms:.1f}",
        tflops_on_device=f"{gflop / device_ms_step:.1f}",
        sort_kernel_ms=f"{sort_ms:.4f}",
        sort_kernel_share=f"{sort_ms / device_ms_step:.4f}", card=repr(card))
    events.sort(key=_self_device_us, reverse=True)
    for e in events[:top]:
        log("train_profile", kernel=repr(e.key[:90]),
            calls_per_step=e.count // steps,
            device_ms_per_step=f"{_self_device_us(e) / steps / 1e3:.3f}")
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
    phase_model(dev)
    phase_profile(dev, smi)
    serve_launches = phase_serve(dev, smi)
    phase_train_step(dev)
    sort["launches"], train_preprocess = phase_train(dev, smi)
    preprocess["launches"] = serve_launches + train_preprocess
    log("launches", preprocess_serve=serve_launches,
        preprocess_train=train_preprocess, sort_train=sort["launches"])
    phase_train_profile(dev, smi)
    print(json.dumps({"kernels": [preprocess, sort]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
