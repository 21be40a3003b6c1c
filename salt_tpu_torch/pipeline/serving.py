"""Inference-only serving entry: checkpoint(s) + image directory ->
streamed batched TTA inference on the card -> submission.csv /
probability archive.

Counterpart of ``salt_tpu/pipeline/serving.py`` (``serve`` :213-395).
Point it at a ``best.npz``, an experiment dir or a CV experiment dir
(whose fold checkpoints are ensembled: fp32 sum over folds divided by
the number of models, then ``> threshold``). Images decode in chunks, so
the dataset never has to fit in RAM; each chunk is one uint8 upload, a
loop of fused TTA steps per model on the device, the fold mean and
threshold on the device, and one download of the masks.

With ``synthetic=N`` it serves N generated images (seed
``execution.seed``, no masks) held in memory instead of a directory,
and without a checkpoint one model of the runner's seeded initial
weights (``SegmentationRunner.init_state``), as the JAX package does.

A depth model is fed depth 0 for every image, as the JAX package's
serve does (:320-324): a served image carries no depth.

With ``model.quant_bits`` set (``cli serve --int8``) the infer form runs
the int8 convs, and serving from checkpoints writes the int8 provenance
next to the submission (``<out>.int8_gate.json``: the checkpoints'
hashes and the matching quality-gate artifacts,
``pipeline/quality.py::write_serve_provenance``; JAX :389-394).

Numerics: fold probabilities accumulate and threshold in fp32; the
optional probability archive is stored float16.
"""
from __future__ import annotations

import contextlib
import copy
import glob
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np
import pandas as pd
import torch
from torch import nn

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.core.experiment import read_flat_npz
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.core import tracing

logger = get_logger()


#: sections/fields rebuilt from the experiment's persisted config.json
#: so the served network matches the trained one. model.quant_bits is
#: excluded (int8 is a serving choice); postpro is excluded (tta and
#: threshold are serving choices too).
_ADOPT_FIELDS = {
    "model": None,                       # None = every field but quant_bits
    "execution": ("loader_mode", "pad_method", "resize_target_size",
                  "pad_size"),
    "image": ("h", "w", "channels"),
    "training": ("dtype",),
}


def adopt_checkpoint_config(config: Config, checkpoint: str,
                            user_set: Sequence[str] = ()) -> Config:
    """When ``checkpoint`` is an experiment dir with a persisted
    ``config.json``, rebuild the model- and preprocessing-defining fields
    from it. Explicit ``--set`` overrides (``user_set`` dotted keys) win
    per field."""
    if not os.path.isdir(checkpoint):
        return config
    path = os.path.join(checkpoint, "config.json")
    if not os.path.exists(path):
        return config
    with open(path) as f:
        raw = json.load(f)
    adopted = []
    for section, fields in _ADOPT_FIELDS.items():
        saved = raw.get(section, {})
        sub = getattr(config, section)
        names = [f for f in saved if fields is None or f in fields]
        for f in names:
            if section == "model" and f == "quant_bits":
                continue
            if f"{section}.{f}" in user_set or not hasattr(sub, f):
                continue
            old = getattr(sub, f)
            val = saved[f]
            if old != val:
                adopted.append(f"{section}.{f}={val!r}")
            setattr(sub, f, val)
    if adopted:
        logger.info("adopted trained config from %s: %s", path,
                    ", ".join(adopted))
    return config


def resolve_checkpoints(path: str) -> List[str]:
    """A .npz file, an experiment dir (checkpoints/network/best.npz), or
    a CV experiment dir (checkpoints/network_fold_*/best.npz -> fold
    ensemble)."""
    if os.path.isfile(path):
        return [path]
    folds = sorted(glob.glob(
        os.path.join(path, "checkpoints", "network_fold_*", "best.npz")))
    if folds:
        return folds
    single = os.path.join(path, "checkpoints", "network", "best.npz")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(
        f"no checkpoint under {path!r}: expected a .npz, "
        "checkpoints/network/best.npz, or checkpoints/network_fold_*/")


def list_images(images_dir: str) -> Tuple[List[str], List[str]]:
    """Sorted (ids, paths) of the directory's PNGs."""
    paths = sorted(glob.glob(os.path.join(images_dir, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no .png files in {images_dir!r}")
    ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    return ids, paths


def decode_images(paths: Sequence[str], h: int = 101, w: int = 101
                  ) -> np.ndarray:
    """PNGs -> packed [N, h, w] uint8 (native decoder, PIL otherwise;
    RGB(A) collapses to channel 0, TGS images being gray stored as RGB)."""
    from salt_tpu_torch.data.native_png import pack_pngs
    with tracing.span("serve.decode") as stage:
        images = pack_pngs(list(paths), h, w)
        stage.set(decoder="pil" if images is None else "native")
        if images is None:
            from PIL import Image

            def gray(p):
                img = np.array(Image.open(p))
                return img if img.ndim == 2 else img[..., 0]

            images = np.stack([gray(p) for p in paths]).astype(np.uint8)
    return images


class _ProbsWriter:
    """Stream the float16 probability archive to disk chunk by chunk: a
    ``np.load``-compatible npz (DEFLATE zip of ``ids.npy`` and
    ``probs.npy``, '.npz' appended when missing) that never holds the full
    [N, H, W] cube in RAM. ``abort`` deletes a partial archive; ``close``
    raises if the stream is incomplete."""

    def __init__(self, path: str, ids: Sequence[str],
                 hw: Tuple[int, int]):
        import zipfile
        from numpy.lib import format as npy_format
        if not path.endswith(".npz"):
            path += ".npz"
        self.path = path
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                                   allowZip64=True)
        with self._zf.open("ids.npy", "w") as f:
            npy_format.write_array(f, np.asarray(ids, dtype=object),
                                   allow_pickle=True)
        self._f = self._zf.open("probs.npy", "w", force_zip64=True)
        npy_format.write_array_header_2_0(
            self._f,
            {"descr": npy_format.dtype_to_descr(np.dtype(np.float16)),
             "fortran_order": False, "shape": (len(ids), *hw)})
        self._remaining = len(ids)

    def append(self, chunk: np.ndarray):
        if chunk.dtype != np.float16:
            raise TypeError(f"probs chunk must be float16, got {chunk.dtype}")
        self._remaining -= chunk.shape[0]
        self._f.write(np.ascontiguousarray(chunk).tobytes())

    def abort(self):
        try:
            self._f.close()
            self._zf.close()
        finally:
            if os.path.exists(self.path):
                os.remove(self.path)

    def close(self):
        if self._remaining != 0:
            self.abort()
            raise RuntimeError(
                f"probs archive incomplete: {self._remaining} rows short "
                f"— partial file {self.path!r} deleted")
        self._f.close()
        self._zf.close()


def _empty_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose state-dict tensors (every parameter and
    persistent buffer, which a strict ``load_state_dict`` overwrites) are
    new and uninitialised: one build serves every fold without its
    initialisation, and nothing is copied that the checkpoint replaces."""
    memo = {}
    for t in model.state_dict(keep_vars=True).values():
        empty = torch.empty_like(t)
        memo[id(t)] = (nn.Parameter(empty, t.requires_grad)
                       if isinstance(t, nn.Parameter) else empty)
    return copy.deepcopy(model, memo)


class _FoldModels:
    """The served folds' models, in fold order, each placed on the device
    the first time the fold loop asks for it (``models[k]``) and kept for
    later chunks.

    A worker thread, started here, prepares each checkpoint's host state
    in fold order: one read of the file, its SHA-256 (:attr:`hashes`, for
    the provenance) and the arrays parsed from the same bytes
    (``core/experiment.py::read_flat_npz``), then
    ``runner.restore_host`` into an :func:`_empty_copy` of one build. It
    runs at most :attr:`AHEAD` folds ahead of the folds placed, so the
    host holds at most that many unplaced folds, and while the card runs
    fold k it restores fold k + 1 or k + 2. The device half,
    ``runner.place``, runs on the caller's thread. A failed restore
    raises its own exception at ``models[k]`` of its fold; :meth:`close`
    stops the worker and waits for it."""

    AHEAD = 2

    def __init__(self, runner, ckpts: Sequence[str]):
        self._runner = runner
        self._ckpts = list(ckpts)
        self._placed: List[nn.Module] = []
        self._ready: Dict[int, object] = {}   # fold -> (model, sha) or error
        self._closed = False
        self._cond = threading.Condition()
        self.hashes: Dict[str, str] = {}
        self._worker = threading.Thread(target=self._work,
                                        name="serve-restore", daemon=True)
        self._worker.start()

    def _work(self) -> None:
        template = None
        for k, path in enumerate(self._ckpts):
            with self._cond:
                while (not self._closed
                       and k >= len(self._placed) + self.AHEAD):
                    self._cond.wait()
                if self._closed:
                    return
            try:
                arrays, sha = read_flat_npz(path)
                if template is None:
                    template = self._runner.build()
                model = self._runner.restore_host(arrays,
                                                  _empty_copy(template))
                out = (model, sha)
            except BaseException as e:    # raised again at models[k]
                out = e
            with self._cond:
                self._ready[k] = out
                self._cond.notify_all()
            if isinstance(out, BaseException):
                return

    def __len__(self) -> int:
        return len(self._ckpts)

    def __getitem__(self, k: int) -> nn.Module:
        if k < len(self._placed):
            return self._placed[k]
        with tracing.span("serve.restore", fold=k):
            with self._cond:
                ready = k in self._ready
                while k not in self._ready:
                    self._cond.wait()
                out = self._ready.pop(k)
            if isinstance(out, BaseException):
                raise out
            model, self.hashes[self._ckpts[k]] = out
            model = self._runner.place(model)
            with self._cond:
                self._placed.append(model)
                self._cond.notify_all()
        tracing.count("serve.restores_ready", int(ready))
        return model

    def __enter__(self) -> "_FoldModels":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()


def serve(config: Config, checkpoint: str, images_dir: str,
          out_csv: str = "submission.csv", probs_out: str = "",
          synthetic: int = 0, chunk_size: int = 8192,
          synthetic_difficulty: str = "easy", user_set: Sequence[str] = (),
          device: Union[str, torch.device] = "cuda") -> dict:
    """Run the inference stack and write the submission. Returns
    {"n", "images_per_sec", "submission", "seconds", "batches",
    "warmup_batches"} (+ "probs_out", + "int8_provenance" when int8 serves
    checkpoints): ``images_per_sec`` is images x
    models over the timed loop's seconds, ``batches`` the forward batches
    of the timed loop (batches x models), ``warmup_batches`` those of the
    untimed warm-up. ``synthetic`` > 0 serves that many generated images
    and ignores ``images_dir``; only then may ``checkpoint`` be empty.

    Traced (``core/tracing.py``) as the root span ``serve`` (attributes
    ``images``, ``folds``) over the stages ``serve.restore`` (a fold),
    ``serve.decode`` (a chunk; attribute ``decoder``), ``serve.upload``,
    ``serve.forward`` (a fold on a chunk), ``serve.download``,
    ``serve.submission`` and ``serve.provenance``, and ``serve.warmup``
    where a small dataset warms up; the counter ``serve.forwards`` counts
    the forward batches of ``batches``.

    Checkpoints restore in a pipeline: a worker thread, started once the
    checkpoints are known, reads, hashes and loads each fold on the host
    (:class:`_FoldModels`) while the images decode and the card runs the
    folds before it; the fold loop places fold k on the device before its
    first forward. So ``serve.restore`` (attribute ``fold``) spans the
    loop's wait for fold k's host state plus its placement, and the
    counter ``serve.restores_ready`` counts the folds whose host state
    was finished when the loop reached them. The provenance takes the
    hashes of the bytes the worker read."""
    with tracing.span("serve") as root, contextlib.ExitStack() as cleanup:
        return _serve(root, cleanup, config, checkpoint, images_dir,
                      out_csv, probs_out, synthetic, chunk_size,
                      synthetic_difficulty, user_set, device)


def _serve(root, cleanup, config, checkpoint, images_dir, out_csv,
           probs_out, synthetic, chunk_size, synthetic_difficulty, user_set,
           device) -> dict:
    from salt_tpu_torch.ops.rle import create_submission
    from salt_tpu_torch.train.steps import SegmentationRunner, pad_batch

    dev = resolve_device(device)
    if not checkpoint and not synthetic:
        raise ValueError(
            "serve on real images requires --checkpoint (a best.npz, an "
            "experiment dir, or a CV experiment dir) — refusing to write a "
            "fresh-random-weights submission")
    if checkpoint:
        config = adopt_checkpoint_config(config, checkpoint, user_set)
    ckpts = resolve_checkpoints(checkpoint) if checkpoint else []
    runner = SegmentationRunner(config, dev)
    if ckpts:
        # the worker restores on the host from here on; fold k is placed
        # on the device as the fold loop reaches it
        models = cleanup.enter_context(_FoldModels(runner, ckpts))
    else:
        # the JAX package serves its runner's seeded initial state
        models = [runner.place(runner.init_state(config.execution.seed).model)]
    if synthetic:
        from salt_tpu_torch.data.bundle import synthetic_bundle
        bundle = synthetic_bundle(synthetic, seed=config.execution.seed,
                                  with_masks=False,
                                  difficulty=synthetic_difficulty)
        ids, paths = bundle.meta["id"].tolist(), None
        mem_images = bundle.images
    else:
        ids, paths = list_images(images_dir)
        mem_images = None
    logger.info("serving %d images, %d checkpoint(s), tta=%s, device=%s",
                len(ids), len(ckpts), config.postpro.use_tta, dev)

    n_models = len(models)
    root.set(images=len(ids), folds=n_models)
    step = (runner.predict_tta_step if config.postpro.use_tta
            else runner.predict_step)
    thresh = float(config.postpro.threshold_masks)
    bs = config.training.batch_size_inference
    n = len(ids)
    h_img, w_img = 101, 101
    chunk_size = max((chunk_size // bs) * bs, bs)

    # the JAX package's serve feeds zero depths (no depth source)
    zero_depths = (torch.zeros((bs, 1), dtype=torch.float32, device=dev)
                   if runner.use_depth else None)

    def run_model(model, imgs_d: torch.Tensor) -> torch.Tensor:
        """[n_pad, h, w] uint8 -> salt-channel fp32 probabilities."""
        return torch.cat([step(model, imgs_d[lo:lo + bs], zero_depths)[:, 1]
                          for lo in range(0, imgs_d.shape[0], bs)])

    def chunks() -> Iterator[Tuple[int, np.ndarray]]:
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            if mem_images is not None:
                yield hi - lo, mem_images[lo:hi]
            else:
                yield hi - lo, decode_images(paths[lo:hi], h_img, w_img)

    def prepare(imgs: np.ndarray) -> torch.Tensor:
        """Zero images up to a batch multiple, one upload."""
        with tracing.span("serve.upload"):
            return torch.from_numpy(pad_batch(imgs, bs)).to(dev)

    counts = {"batches": 0, "warmup_batches": 0}

    def run_chunk(count: int, imgs: np.ndarray):
        imgs_d = prepare(imgs)
        acc = None
        for fold in range(n_models):
            model = models[fold]
            with tracing.span("serve.forward", fold=fold):
                p = run_model(model, imgs_d)
                acc = p if acc is None else acc + p
        forwards = n_models * imgs_d.shape[0] // bs
        counts["batches"] += forwards
        tracing.count("serve.forwards", forwards)
        with tracing.span("serve.download"):
            mean = acc[:count] / n_models                  # fp32 fold mean
            masks = (mean > thresh).to(torch.uint8).cpu().numpy()
            p16 = mean.half().cpu().numpy() if probs_out else None
        return masks, p16

    gen = chunks()
    first = None
    if n <= 4096:
        # small/benchmark datasets: warm up outside the timer on the first
        # chunk's real layout (CUDA context, cuDNN handles, the kernel
        # library, the allocator), then discard the device arrays: the
        # timed loop re-runs the upload for the first chunk so the timed
        # window covers host prep + transfer + compute for every chunk.
        with tracing.span("serve.warmup"):
            first = next(gen)
            imgs_w = prepare(first[1])
            run_model(models[0], imgs_w)[0, 0, 0].item()
            counts["warmup_batches"] = imgs_w.shape[0] // bs
            del imgs_w

    t0 = time.perf_counter()
    mask_parts = []
    prob_writer = (_ProbsWriter(probs_out, ids, (h_img, w_img))
                   if probs_out else None)
    try:
        for count, imgs in (itertools.chain([first], gen)
                            if first is not None else gen):
            masks, p16 = run_chunk(count, imgs)
            mask_parts.append(masks)
            if prob_writer is not None:
                prob_writer.append(p16)
    except BaseException:
        if prob_writer is not None:
            prob_writer.abort()
        raise
    masks = np.concatenate(mask_parts, axis=0)
    dt = time.perf_counter() - t0
    ips = n * n_models / dt

    with tracing.span("serve.submission"):
        submission = create_submission(pd.DataFrame({"id": ids}),
                                       list(masks))
        submission.to_csv(out_csv, index=None, encoding="utf-8")
    if prob_writer is not None:
        prob_writer.close()
    logger.info("served %d images at %.0f img/s -> %s", n, ips, out_csv)
    result = {"n": n, "images_per_sec": round(ips, 1),
              "submission": out_csv, "seconds": dt, **counts}
    if prob_writer is not None:
        result["probs_out"] = prob_writer.path
    if config.model.quant_bits and ckpts:
        from salt_tpu_torch.pipeline.quality import write_serve_provenance
        with tracing.span("serve.provenance"):
            result["int8_provenance"] = write_serve_provenance(
                out_csv, ckpts, config.model.quant_bits, checkpoint,
                hashes=models.hashes)
    return result
