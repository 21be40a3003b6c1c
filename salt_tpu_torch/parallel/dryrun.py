"""Multi-process dry run: one full train step over an N-rank
data-parallel process group, plus the fold-parallel layouts, on tiny
shapes, on the CPU (counterpart of ``salt_tpu/parallel/dryrun.py``
:35-124; the card's machine has one card, so a world above 1 runs here
on gloo).

    python -m salt_tpu_torch.parallel.dryrun [N]      # default 4

N processes are spawned (``parallel/mesh.run_group``), one torch thread
each, and run SaltUNet (8 filters, 2 levels, fp32):

1. one data-parallel train step of a batch of 2 max(N, 4) (``mesh.
   data_parallel_train_step``): a finite loss;
2. the TTA predict of that batch over the mesh (``mesh.
   predict_dataset``): probabilities [b, 2, 101, 101], finite;
3. at N >= 2, one fold-parallel step of 2 folds (``fold_parallel.
   FoldParallelRunner``: a fold group a rank);
4. at N >= 4, the hybrid step: 2 fold groups x N/2 data ranks
   (``parallel.fold_parallel_data_axis`` = N/2).

Rank 0 prints a line a check and the script exits 0; a failing rank
raises.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List

import numpy as np


def _config():
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    return cfg


def _fold_step(cfg, images, masks, kb):
    import torch
    from salt_tpu_torch.parallel.fold_parallel import FoldParallelRunner
    fp = FoldParallelRunner(cfg, 2, "cpu")
    states = fp.init_states(0)
    fi = np.stack([images[:kb], images[kb:2 * kb]])
    fm = np.stack([masks[:kb], masks[kb:2 * kb]])
    di, dm = fp.shard_fold_batch(fi, fm)
    draws = fp.draw(torch.Generator().manual_seed(0), kb)
    loss = fp.train_step(states, di, dm, draws, [True] * len(fp.folds))
    losses = np.asarray(fp.gather(loss.tolist()), np.float64)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite fold losses {losses}")
    return losses, fp.mesh_shape


def _body(mesh, n: int) -> List[str]:
    import torch
    from salt_tpu_torch.parallel.mesh import (data_parallel_train_step,
                                              predict_dataset)
    from salt_tpu_torch.train.steps import SegmentationRunner
    lines = []
    cfg = _config()
    runner = SegmentationRunner(cfg, "cpu")
    state = runner.init_state(0)
    b = max(n, 4) * 2
    images = (np.random.RandomState(0).rand(b, 101, 101) * 255
              ).astype(np.uint8)
    masks = (np.random.RandomState(1).rand(b, 101, 101) > 0.5
             ).astype(np.uint8)
    loss = float(data_parallel_train_step(
        runner, state, torch.from_numpy(images), torch.from_numpy(masks),
        torch.Generator().manual_seed(0), mesh))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    lines.append(f"dryrun_multichip({n}) ok: loss={loss:.4f}, "
                 f"mesh=({mesh.size} ranks, {mesh.backend})")

    model = state.model.eval()
    probs = predict_dataset(runner, model, images, mesh, batch_size=2,
                            tta=True)
    if probs.shape != (b, 2, 101, 101) or not np.isfinite(probs).all():
        raise AssertionError(f"TTA predict: {probs.shape}, finite "
                             f"{np.isfinite(probs).all()}")
    lines.append(f"dryrun predict (TTA over the mesh) ok: "
                 f"probs[{b}x2x101x101], mean={float(probs.mean()):.4f}")

    if n >= 2:
        losses, shape = _fold_step(cfg, images, masks, 4)
        lines.append(f"dryrun fold-parallel ok: losses={np.round(losses, 4)}"
                     f", fold mesh={shape}")
    if n >= 4:
        cfg2 = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, fold_parallel_data_axis=n // 2))
        losses, shape = _fold_step(cfg2, images, masks, max(n // 2, 2))
        lines.append(f"dryrun hybrid fold x data ok: "
                     f"losses={np.round(losses, 4)}, mesh={shape}")
    return lines


def dryrun(n_devices: int) -> List[str]:
    """Run the dry run on ``n_devices`` gloo processes; rank 0's lines."""
    from salt_tpu_torch.parallel.mesh import run_group
    return run_group(_body, n_devices, n_devices)


def main(n_devices: int = 4) -> int:
    for line in dryrun(n_devices):
        print(line, flush=True)
    return 0


if __name__ == "__main__":   # pragma: no cover - exercised via subprocess
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
