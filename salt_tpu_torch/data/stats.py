"""Dataset statistics, the ``data-stats`` command (counterpart of
``salt_tpu/data/stats.py``): the reference's data_exploration notebook
(depth distribution, the image mean / std behind its normalization
constants, mask characteristics) and stacking_data_exploration notebook
(the joined first-level cube) as numbers over a DataBundle. Numpy only:
it touches no device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from salt_tpu_torch.data.bundle import DataBundle


def _dist(x: np.ndarray) -> Dict:
    q = np.percentile(x, [0, 25, 50, 75, 100])
    return {"min": float(q[0]), "q25": float(q[1]), "median": float(q[2]),
            "q75": float(q[3]), "max": float(q[4]),
            "mean": float(np.mean(x)), "std": float(np.std(x))}


def bundle_stats(train: DataBundle,
                 test: Optional[DataBundle] = None) -> Dict:
    """{images, depths, masks, depth_salt_correlation} over the bundle.

    `images.mean/std` are in [0,1] — directly usable as the
    normalization constants the notebook derives (its
    `np.mean(imgs), np.std(imgs)` cell)."""
    report: Dict = {"n_train": len(train),
                    "n_test": 0 if test is None else len(test)}
    imgs = np.asarray(train.images, np.float64) / 255.0
    report["images"] = {"mean": float(imgs.mean()),
                        "std": float(imgs.std()),
                        "per_image_mean": _dist(imgs.reshape(len(imgs), -1)
                                                .mean(axis=1))}
    # raw z from the metadata (the notebook plots depths.csv z values;
    # bundle.depths is the /1000-scaled model feature)
    z = np.asarray(train.meta["z"].values, np.float64).reshape(-1)
    report["depths"] = _dist(z)
    if train.masks is not None:
        n = len(train)
        sizes = np.asarray(train.masks).reshape(n, -1).sum(axis=1)
        nonempty = sizes[sizes > 0]
        report["masks"] = {
            "empty_fraction": float((sizes == 0).mean()),
            "coverage_fraction": float(sizes.mean()
                                       / train.masks[0].size),
            "full_fraction": float((sizes >= 0.98
                                    * train.masks[0].size).mean()),
            "nonempty_size": (_dist(nonempty) if len(nonempty)
                              else None),
        }
        # does salt probability track depth? (the notebook eyeballs
        # this by browsing depth bands; the hard synthetic mode builds
        # the correlation in deliberately)
        has_salt = (sizes > 0).astype(np.float64)
        # guard the variance of the actual correlate (the binary
        # indicator) — an all-nonempty set has sizes.std() > 0 but a
        # constant indicator, and corrcoef would emit nan
        if z.std() > 0 and has_salt.std() > 0:
            report["depth_salt_correlation"] = float(
                np.corrcoef(z, has_salt)[0, 1])
    return report


def stacking_stats(ids, cube: np.ndarray,
                   train: Optional[DataBundle] = None,
                   threshold: float = 0.5) -> Dict:
    """First-level prediction-cube report — the reference's
    `stacking_data_exploration` notebook (reference:
    notebooks/stacking_data_exploration.ipynb, which browses the joined
    oof cubes of utils.py:560-581) as numbers instead of eyeballs.

    cube: [N, H, W, M] oof probabilities (one channel per first-level
    experiment, `pipeline/stacking.py::join_experiment_predictions`).
    Reports per-model probability stats, pairwise mask agreement at
    ``threshold`` (ensembling only helps where members disagree), and —
    when ground truth is supplied — each member's oof pixel accuracy."""
    cube = np.asarray(cube, np.float64)
    n, h, w, m = cube.shape
    flat = cube.reshape(-1, m)                       # [N*H*W, M]
    masks = flat > threshold
    report: Dict = {"n_images": n, "n_models": m,
                    "per_model": [{"prob_mean": float(flat[:, k].mean()),
                                   "prob_std": float(flat[:, k].std()),
                                   "positive_fraction":
                                       float(masks[:, k].mean())}
                                  for k in range(m)]}
    if m > 1:
        dis = [float((masks[:, a] != masks[:, b]).mean())
               for a in range(m) for b in range(a + 1, m)]
        report["pairwise_disagreement"] = {"mean": float(np.mean(dis)),
                                           "max": float(np.max(dis))}
    if train is not None and train.masks is not None:
        id_to_row = {i: k for k, i in enumerate(train.meta["id"])}
        rows = [id_to_row[i] for i in ids if i in id_to_row]
        if len(rows) == n:
            gt = (np.asarray(train.masks)[rows] > 0).reshape(-1, 1)
            report["per_model_pixel_accuracy"] = [
                float((masks[:, k:k + 1] == gt).mean()) for k in range(m)]
    return report


def format_stacking_stats(report: Dict) -> str:
    lines = [f"stacking cube: {report['n_images']} images x "
             f"{report['n_models']} first-level model(s)"]
    for k, pm in enumerate(report["per_model"]):
        acc = report.get("per_model_pixel_accuracy")
        lines.append(f"  model {k}: prob mean={pm['prob_mean']:.3f} "
                     f"std={pm['prob_std']:.3f} "
                     f"positive={pm['positive_fraction']:.1%}"
                     + (f" oof-pixel-acc={acc[k]:.1%}" if acc else ""))
    if "pairwise_disagreement" in report:
        pd_ = report["pairwise_disagreement"]
        lines.append(f"  pairwise mask disagreement: mean={pd_['mean']:.2%}"
                     f" max={pd_['max']:.2%} (ensembling only helps "
                     "where members disagree)")
    return "\n".join(lines)


def format_stats(report: Dict) -> str:
    lines = [f"n_train={report['n_train']}  n_test={report['n_test']}"]
    im = report["images"]
    lines.append(f"images: mean={im['mean']:.4f} std={im['std']:.4f} "
                 "(normalization constants, [0,1] scale)")
    d = report["depths"]
    lines.append(f"depths: min={d['min']:.0f} q25={d['q25']:.0f} "
                 f"median={d['median']:.0f} q75={d['q75']:.0f} "
                 f"max={d['max']:.0f}")
    if "masks" in report:
        m = report["masks"]
        lines.append(f"masks: empty={m['empty_fraction']:.1%} "
                     f"full={m['full_fraction']:.1%} "
                     f"coverage={m['coverage_fraction']:.1%}")
        if m["nonempty_size"]:
            s = m["nonempty_size"]
            lines.append(f"non-empty size px: q25={s['q25']:.0f} "
                         f"median={s['median']:.0f} q75={s['q75']:.0f} "
                         f"max={s['max']:.0f}")
    if "depth_salt_correlation" in report:
        lines.append("corr(depth, has-salt) = "
                     f"{report['depth_salt_correlation']:+.3f}")
    return "\n".join(lines)
