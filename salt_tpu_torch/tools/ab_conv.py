"""Interleaved A/B of the conv kernel in the flagship's bf16 hflip-TTA step:
the port of ``tools/ab_pallas_conv.py``.

    python -m salt_tpu_torch.tools.ab_conv [--batches 64,128] [--iters 20] \
        [--windows 3] [--encoder-depth 34] [--device cuda|cpu]

One seeded model (``SegmentationRunner.init_model``) and one set of
random uint8 images per batch size serve four variants of the infer
form's convs: "off" (``F.conv2d``, cuDNN on the card), "on" (the conv
kernel for every eligible conv, ``ops.conv_pair.make_conv_fn("all")``),
"on+res64" and "on+res128" (the kernel only for the convs of output
height <= 64, or >= 128: the JAX package's ``SALT_TPU_PALLAS_CONV_SCOPE``
values). For each batch size it prints each variant's max |d prob|
against "off" and its conv kernel launches per step, then ms per batch
and images/s: the best of ``--windows`` windows of ``--iters`` steps, the
variants interleaved, each window timed on the host clock up to a
device synchronization.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.ops import conv_kernel
from salt_tpu_torch.ops.conv_pair import make_conv_fn
from salt_tpu_torch.tools.timing import sync
from salt_tpu_torch.train.steps import SegmentationRunner

#: variant -> the conv kernel's scope (None: the plain ``F.conv2d``)
VARIANTS = {"off": None, "on": "all", "on+res64": "res64",
            "on+res128": "res128"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="64,128")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--encoder-depth", type=int, default=34)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]

    cfg = default_config()
    cfg.model.encoder_depth = args.encoder_depth
    cfg.training.dtype = "bfloat16"
    runner = SegmentationRunner(cfg, args.device)
    dev = runner.device
    model = runner.init_model(seed=0)
    convs = {name: F.conv2d if scope is None else make_conv_fn(scope)
             for name, scope in VARIANTS.items()}

    def step(name, images):
        model.infer_conv = convs[name]
        return runner.predict_tta_step(model, images)

    rng = np.random.RandomState(0)
    results = {}
    for bs in batches:
        images = torch.from_numpy(
            (rng.rand(bs, 101, 101) * 255).astype(np.uint8)).to(dev)
        probs, launches = {}, {}
        for name in VARIANTS:
            before = conv_kernel.launches
            probs[name] = step(name, images).float().cpu().numpy()
            launches[name] = conv_kernel.launches - before
        for name in VARIANTS:
            delta = float(np.abs(probs[name] - probs["off"]).max())
            print(f"bs{bs} {name:<10} max|dprob| vs off: {delta:.2e}  "
                  f"conv kernel launches/step: {launches[name]}", flush=True)
        best = {name: float("inf") for name in VARIANTS}
        for _ in range(args.windows):
            for name in VARIANTS:
                sync(dev)
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step(name, images)
                sync(dev)
                best[name] = min(best[name], time.perf_counter() - t0)
        for name in VARIANTS:
            ms = best[name] / args.iters * 1e3
            print(f"bs{bs:<4} {name:<10} {ms:8.3f} ms/batch  "
                  f"{bs / ms * 1e3:9.1f} img/s", flush=True)
        results[bs] = {name: dict(launches=launches[name],
                                  ms=best[name] / args.iters * 1e3,
                                  dprob=float(np.abs(probs[name]
                                                     - probs["off"]).max()))
                       for name in VARIANTS}
    return results


if __name__ == "__main__":
    main()
