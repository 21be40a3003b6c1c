"""The ``serve`` kind: whole submissions through the program's
``pipeline/serving.py::serve``, as users serve a test set.

Set-up: the images (PNGs in one directory) and the fold checkpoints
(``<exp>/checkpoints/network_fold_<k>/best.npz``) made from the seed,
written once a seed into the input cache; one untimed ``serve()`` of ``warmup_images`` other images
through fold 0 (the folds share every kernel and shape). The window: ``serve()`` calls over the directory,
each a whole submission (restore the folds, decode, TTA through every
fold, fold mean, threshold, RLE, CSV), from the start of the first to
the return of the last; a call starts while the window is shorter than
``--seconds``. With ``--trace 1`` one more call runs under the profiler
after the window. Then each call's CSV is checked on ``check_images``
images drawn from the seed against the reference's probabilities, and
every call's CSV for an answer to every image.

Traffic keys: ``batch`` (``training.batch_size_inference``),
``quant_bits``, ``warmup_images``, ``check_images``.
"""
from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np
import torch

from benchmark import inputs, trace, weights
from benchmark.reference import quant
from benchmark.reference import serve as ref_serve

#: mask pixels of one image
PIXELS = inputs.SIZE * inputs.SIZE


def port_config(cfg: dict, traffic: dict):
    """The program's ``Config`` of this configuration and traffic;
    ``use_hypercolumn`` (else on) and ``pool0`` (else the program's
    default) from the configuration where it gives them."""
    from salt_tpu_torch.core.config import default_config
    c = default_config()
    m = c.model
    m.architecture = cfg["architecture"]
    m.encoder_depth = cfg["encoder_depth"]
    m.num_classes = cfg["num_classes"]
    m.use_hypercolumn = cfg.get("use_hypercolumn", True)
    m.pool0 = cfg.get("pool0", m.pool0)
    m.pallas_conv = cfg["pallas_conv"]
    m.quant_bits = traffic["quant_bits"]
    c.training.dtype = cfg["dtype"]
    c.training.batch_size_inference = traffic["batch"]
    c.execution.loader_mode = "resize_and_pad"
    c.execution.pad_method = cfg["pad_method"]
    c.postpro.use_tta = True
    c.postpro.tta_flip_lr = True
    c.postpro.tta_aggregation_method = "mean"
    c.postpro.threshold_masks = cfg["threshold"]
    return c


def rle_decode(rle: str) -> np.ndarray:
    """A submission's column-major, 1-indexed run-length mask."""
    flat = np.zeros(PIXELS, np.uint8)
    v = [int(t) for t in rle.split()]
    for start, length in zip(v[0::2], v[1::2]):
        flat[start - 1:start - 1 + length] = 1
    return flat.reshape(inputs.SIZE, inputs.SIZE).T


def read_submission(path: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["id", "rle_mask"]:
        raise ValueError(f"{path}: header {rows[0]}")
    return {r[0]: r[1] for r in rows[1:]}


def mask_error(masks: np.ndarray, ref: np.ndarray, thresh: float) -> float:
    """The mean over the pixels of the distance from the threshold of the
    reference's probability, where the served mask decides the pixel the
    other way (0 where it agrees). Quadratic in a probability's error: an
    error e flips the pixels within e of the threshold, each weighing at
    most e."""
    wrong = masks.astype(bool) != (ref > thresh)
    return float((np.abs(ref - thresh) * wrong).mean())


class Prepared:
    """One seed's inputs on disk and in memory: the images and their ids,
    the served directory, the fold checkpoints and their fp32 reference
    models (on the host). The files are made once a seed and kept in the
    checkout's input cache (:func:`inputs.cached_dir`); the arrays and
    models are made anew every run."""

    def __init__(self, r):
        cfg, traffic, dev, seed = r.config, r.traffic, r.device, r.seed
        n, folds = cfg["test_images"], cfg["folds_served"]
        t0 = time.perf_counter()
        images, _ = inputs.images_and_masks(n, seed, 1, dev)
        warm, _ = inputs.images_and_masks(traffic["warmup_images"], seed, 2,
                                          dev)
        calib, _ = inputs.images_and_masks(8, seed, 3, dev)
        self.images = images.cpu().numpy()
        self.ids = inputs.image_ids(n, seed)
        models = weights.make_folds(cfg, folds, seed, calib)
        t1 = time.perf_counter()

        def fill(d):
            inputs.write_pngs(self.images, self.ids, os.path.join(d, "images"))
            inputs.write_pngs(warm.cpu().numpy(),
                              inputs.image_ids(warm.shape[0], seed + 1),
                              os.path.join(d, "warmup"))
            weights.write_folds(models, os.path.join(d, "experiment"))
            # the warm-up serves fold 0 alone: every fold runs the same
            # kernels
            link = os.path.join(d, "warm_experiment", "checkpoints",
                                "network_fold_0")
            os.makedirs(link)
            os.link(os.path.join(d, "experiment", "checkpoints",
                                 "network_fold_0", "best.npz"),
                    os.path.join(link, "best.npz"))

        cache = os.path.join(r.cache_root, inputs.cache_key(
            r.cell["name"], seed, cfg, traffic))
        hit = inputs.cached_dir(cache, fill)
        self.img_dir = os.path.join(cache, "images")
        self.warm_dir = os.path.join(cache, "warmup")
        self.exp = os.path.join(cache, "experiment")
        self.warm_exp = os.path.join(cache, "warm_experiment")
        self.models = [m.cpu() for m in models]
        print(f"serve: set-up at {r.elapsed():.3f} s: images and weights "
              f"{t1 - t0:.3f} s, files {time.perf_counter() - t1:.3f} s "
              f"({'cached' if hit else 'written'})", file=sys.stderr)
        del warm, calib, models
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.workdir = r.workdir
        self.device = dev
        self.config = port_config(cfg, traffic)

    def call(self, out_csv: str) -> str:
        """One ``serve()`` submission of the served directory through every
        fold into ``<workdir>/<out_csv>``."""
        return self._serve(out_csv, self.exp, self.img_dir)

    def warm_up(self) -> None:
        """One ``serve()`` of the warm-up images through fold 0."""
        self._serve("warmup.csv", self.warm_exp, self.warm_dir)

    def _serve(self, out_csv, experiment, directory) -> str:
        from salt_tpu_torch.pipeline.serving import serve
        path = os.path.join(self.workdir, out_csv)
        serve(self.config, experiment, directory, out_csv=path,
              device=self.device)
        return path


def run(r) -> None:
    cfg, traffic, dev = r.config, r.traffic, r.device
    n, folds, bs = cfg["test_images"], cfg["folds_served"], traffic["batch"]
    prep = Prepared(r)
    prep.warm_up()
    sync(dev)
    print(f"serve: warm-up done at {r.elapsed():.3f} s", file=sys.stderr)

    # -- the window ---------------------------------------------------------
    r.values["setup_s"] = r.elapsed()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    csvs, ends = [], []

    def call():
        csvs.append(prep.call(f"submission_{len(csvs)}.csv"))
        ends.append(r.elapsed())

    window_s = whole_calls(call, r.seconds, lambda: sync(dev))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    served = len(csvs) * n * folds
    r.values["serve_images_per_s"] = served / window_s
    r.values["peak_mem_gib"] = peak / 2 ** 30
    r.facts.update(memory_peak_bytes=peak, window_s=window_s,
                   image_folds=served, batch=bs,
                   quant_bits=traffic["quant_bits"])
    print(f"serve: {len(csvs)} calls of {n} images x {folds} folds in "
          f"{window_s:.3f} s, ending at {[round(t, 3) for t in ends]} s",
          file=sys.stderr)

    if r.trace_on:
        r.trace = trace.traced_call(lambda: prep.call("traced.csv"),
                                    {"forwards": folds * -(-n // bs)}, dev)

    # -- correctness ----------------------------------------------------------
    r.attempted = len(csvs) * n
    err, missing = check(r, prep, csvs)
    r.failed = missing
    r.checks["mask_error"] = (err, r.limits["mask_error"])
    r.checks["answers_missing"] = (missing, r.limits["answers_missing"])


def whole_calls(call, seconds: float, sync=lambda: None) -> float:
    """Run ``call()`` while the window is shorter than ``seconds`` (once
    at least); the window's seconds, from the first call's start to the
    last one's return."""
    t_start = time.perf_counter()
    while True:
        call()
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    return time.perf_counter() - t_start


def check_sample(r) -> np.ndarray:
    """The checked images' indices, drawn from the seed."""
    n = r.config["test_images"]
    k = min(r.traffic["check_images"], n)
    rng = np.random.RandomState((r.seed % (1 << 32)) ^ 0x5EED)
    return np.sort(rng.choice(n, k, replace=False))


def check(r, prep: Prepared, csvs, quant_bits=None):
    """(the worst :func:`mask_error` of the CSVs' checked images against
    the reference, the answers missing from them); the reference in the
    traffic's arithmetic, or at ``quant_bits``."""
    sample = check_sample(r)
    ref = reference_probs(r, prep.models, prep.images[sample], quant_bits)
    thresh = r.config["threshold"]
    err, missing, runs = 0.0, 0, []
    for path in csvs:
        rows = read_submission(path)
        missing += sum(1 for i in prep.ids if i not in rows)
        runs.append(np.mean([len(v.split()) / 2 for v in rows.values()]))
        if any(prep.ids[i] not in rows for i in sample):
            err = float("inf")
            continue
        masks = np.stack([rle_decode(rows[prep.ids[i]]) for i in sample])
        err = max(err, mask_error(masks, ref, thresh))
    print(f"serve: mean runs per mask {float(np.mean(runs)):.2f}; "
          f"answers missing {missing}", file=sys.stderr)
    return err, missing


def reference_probs(r, models, images_u8: np.ndarray,
                    quant_bits=None) -> np.ndarray:
    """The reference ensemble's probabilities for ``images_u8``, after
    the window, in the configuration's arithmetic (the traffic's
    ``quant_bits`` unless given, the full-precision route of
    ``pallas_conv``), fp32 and TF32 off."""
    dev = r.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    on_dev = [m.to(dev) for m in models]
    bits = r.traffic["quant_bits"] if quant_bits is None else quant_bits
    conv = quant.conv_policy(bits, r.config["pallas_conv"])
    with weights.exact_fp32():
        p = ref_serve.fold_mean(on_dev, torch.from_numpy(images_u8).to(dev),
                                conv)
    return p.cpu().numpy()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
