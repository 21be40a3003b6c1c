"""Synthetic TGS-like data for tests and benchmarks (own copy of
``salt_tpu/data/synthetic.py``: the same generators and the same numpy
random streams, so a seed gives the same arrays in both packages).

The reference's de-facto integration test is a DEV_MODE run on 100 real
images (reference: main.py:40,469-471; neptune.yaml:27). Real Kaggle data
is not redistributable, so tests and benches here run on a generated
lookalike: 101x101 grayscale "seismic" noise with smooth salt-dome blob
masks and a depths.csv. Images correlate with masks so models can
actually learn (salt regions are brighter), giving the e2e tests a real
learnability signal.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import pandas as pd


def synthetic_arrays(n: int, seed: int = 0, empty_fraction: float = 0.35,
                     size: int = 101, difficulty: str = "easy"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (images [N,size,size] uint8, masks [N,size,size] uint8 {0,1},
    depths [N] int).

    ``difficulty="easy"`` (default, used by the test suite) is the
    original bright-blob task. ``"hard"`` is a deliberately TGS-like
    task for quality-evidence runs (see :func:`_hard_arrays`): the easy
    task saturates the flagship at IOUT ~0.9, the hard one leaves the
    headroom where TTA/ensembling/gating/stacking deltas are visible.
    """
    if difficulty == "hard":
        return _hard_arrays(n, seed, empty_fraction, size)
    if difficulty == "real":
        return _real_arrays(n, seed, empty_fraction, size)
    if difficulty != "easy":
        raise ValueError(f"unknown synthetic difficulty: {difficulty!r}")
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    images = np.empty((n, size, size), dtype=np.uint8)
    masks = np.zeros((n, size, size), dtype=np.uint8)
    depths = rng.randint(50, 959, size=n)
    for i in range(n):
        base = rng.normal(128, 28, (size, size))
        # horizontal banding like seismic strata
        base += 18 * np.sin(yy / (3.0 + rng.rand() * 6) + rng.rand() * 6)
        if rng.rand() > empty_fraction:
            cx, cy = rng.randint(10, size - 10, 2)
            rx, ry = rng.randint(8, 45, 2)
            angle = rng.rand() * np.pi
            dx, dy = xx - cx, yy - cy
            u = dx * np.cos(angle) + dy * np.sin(angle)
            v = -dx * np.sin(angle) + dy * np.cos(angle)
            blob = (u / rx) ** 2 + (v / ry) ** 2 < 1.0
            masks[i] = blob.astype(np.uint8)
            base += blob * 45.0  # salt is brighter -> learnable signal
        images[i] = np.clip(base, 0, 255).astype(np.uint8)
    return images, masks, depths


def _hard_arrays(n: int, seed: int, empty_fraction: float, size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TGS-lookalike generator with the failure modes that make the real
    challenge hard (reference README.md:4; data exploration notebooks):

    - folded strata (banding with a smooth lateral phase warp), not flat;
    - salt bodies as irregular star-convex domes OR half-spaces below a
      wavy top-of-salt boundary (the dominant real-mask shapes);
    - the salt signal is mostly TEXTURE (attenuated banding + chaotic
      speckle + a bright top reflector rim), only a weak brightness lift;
    - global illumination gradient, contrast jitter and sensor noise;
    - P(salt) grows with depth z, so the depth feature (AddDepthChannels
      / depth excitation, reference utils.py:494-503) carries real
      signal instead of being decorative.
    """
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    col = np.arange(size, dtype=np.float64)
    images = np.empty((n, size, size), dtype=np.uint8)
    masks = np.zeros((n, size, size), dtype=np.uint8)
    depths = rng.randint(50, 959, size=n)
    for i in range(n):
        z = float(depths[i])
        # folded strata: lateral phase warp summed from low-freq sines
        warp = np.zeros(size)
        for _ in range(3):
            warp += rng.uniform(1.0, 7.0) * np.sin(
                2 * np.pi * col / rng.uniform(25, 80)
                + rng.uniform(0, 2 * np.pi))
        lam = rng.uniform(5.0, 16.0)
        band = 22 * np.sin(2 * np.pi * (yy + warp[None, :]) / lam
                           + rng.uniform(0, 2 * np.pi))
        band += 10 * np.sin(2 * np.pi * (yy + 0.5 * warp[None, :])
                            / (lam * 2.7) + rng.uniform(0, 2 * np.pi))
        base = 120.0 + band
        # deeper images are likelier to contain salt (mean over uniform z
        # stays ~= 1 - empty_fraction)
        p_salt = min(1.0, max(0.0, (1.0 - empty_fraction)
                              * (0.4 + 1.2 * (z - 50.0) / 909.0)))
        if rng.rand() < p_salt:
            if rng.rand() < 0.45:   # half-space below a wavy boundary
                b0 = rng.uniform(0.25, 0.8) * size
                bwarp = np.zeros(size)
                for _ in range(2):
                    bwarp += rng.uniform(2, 10) * np.sin(
                        2 * np.pi * col / rng.uniform(40, 130)
                        + rng.uniform(0, 2 * np.pi))
                blob = yy > (b0 + bwarp[None, :])
            else:                   # irregular star-convex dome
                cx, cy = rng.randint(15, size - 15, 2)
                r0 = rng.uniform(10, 38)
                ecc = rng.uniform(0.6, 1.6)
                dx, dy = (xx - cx) * ecc, yy - cy
                theta = np.arctan2(dy, dx)
                rad = r0 * np.ones_like(theta)
                for k in range(2, 6):
                    rad += r0 * (rng.uniform(0, 0.3) / k) * np.sin(
                        k * theta + rng.uniform(0, 2 * np.pi))
                blob = np.hypot(dx, dy) < rad
            if blob.any():
                # interior: chaotic texture, banding attenuated, weak lift
                interior = (0.25 * band + rng.normal(0, 9, (size, size))
                            + rng.uniform(4, 14))
                base = np.where(blob, 120.0 + interior, base)
                # bright top-of-salt reflector rim (edge-safe dilation)
                p = np.pad(blob, 1)
                dil = (p[2:, 1:-1] | p[:-2, 1:-1] | p[1:-1, 2:]
                       | p[1:-1, :-2] | blob)
                base = np.where(dil & ~blob, base + rng.uniform(25, 45),
                                base)
                masks[i] = blob.astype(np.uint8)
        gx, gy = rng.uniform(-14, 14, 2)
        base += gx * (xx / size) + gy * (yy / size)
        base = 128.0 + rng.uniform(0.75, 1.15) * (base - 128.0)
        base += rng.normal(0, 10, (size, size))
        images[i] = np.clip(base, 0, 255).astype(np.uint8)
    return images, masks, depths


# Calibrated knobs for the "real" difficulty (VERDICT r3 #1): tuned so a
# 6-fold flagship (UNetResNet34+scSE+hypercolumn) with hflip-TTA lands at
# CV IOUT 0.78-0.88 — the reference's real-data regime
# (reference README.md:35-41: solutions 7-9 score 0.829-0.853 CV).
# Calibration series (tools/calibrate_real.py, single-fold 40-epoch
# flagship+TTA probe on TPU / evidence-oracle ceiling on 2000 images):
#   jitter 2.5 decoy .25 snr_lo .15 -> probe 0.620, ORACLE 0.751 (band
#     unreachable: annotation jitter + decoys crush the ceiling itself)
#   jitter 1.0 decoy .15 snr_lo .25 -> probe 0.689, oracle 0.892
#   jitter 1.0 decoy .12 snr_lo .35 -> probe 0.731, oracle ~0.92
#   jitter 1.0 decoy .12 snr_lo .40 -> probe 0.745, oracle ~0.92
#     (round-4 6-fold CV at these knobs measured 0.7634 — ~0.017 UNDER
#      the band, so round 5 retuned:)
#   jitter 0.7 decoy .08 snr_lo .40 -> probe 0.7856, oracle 0.9373 <- SET
# Single-fold sits ~0.02-0.06 below the 6-fold fold-mean CV number, so
# these defaults land the matrix (tools/quality_matrix_real.py) at
# CV IOUT ~0.79-0.82 with ~0.15 of model-improvable headroom below the
# generator's own ceiling.
REAL_KNOBS = dict(
    snr_lo=0.4, snr_hi=1.0,     # interior texture-contrast range
    jitter_px=0.7,              # label-vs-texture annotation offset (std)
    feather_lo=0.8, feather_hi=3.0,   # boundary blend half-width (px)
    rim_p=0.45, rim_lo=10.0, rim_hi=30.0,  # top-of-salt reflector rim
    small_bias=2.2,             # beta(1.2, small_bias) skews domes small
    decoy_p=0.08, decoy_snr=0.35,      # salt-looking texture on EMPTIES
    noise=12.0,                 # sensor noise std
)


def _real_arrays(n: int, seed: int, empty_fraction: float, size: int,
                 knobs: Optional[dict] = None, oracle: Optional[list] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TGS-lookalike generator calibrated to the REFERENCE's score regime
    (VERDICT r3 #1). The ``hard`` task saturates the flagship at IOUT
    ~0.96 because every salt body has a clear texture change and a
    bright rim along its exact labelled boundary. Real TGS sits at
    0.83-0.85 because the evidence is ambiguous; this mode reproduces
    those failure modes on top of the ``hard`` strata/depth model:

    - FEATHERED boundaries: interior texture blends into the strata over
      a random 1-3 px band (signed-distance sigmoid), so the exact
      contour is uncertain;
    - ANNOTATION noise: the labelled mask is offset/warped ~2-3 px from
      the texture evidence (real masks are hand-drawn);
    - LOW-SNR subset: interior contrast scaled by U(snr_lo, 1) — at the
      low end salt is nearly invisible and the model must miss some;
    - SMALL-MASK-heavy size distribution (IOUT scores a near-miss on a
      tiny mask as 0, the dominant real-data penalty);
    - DECOY empties: salt-looking low-contrast texture patches on a
      fraction of empty images (false-positive pressure, mirroring the
      non-salt geology of the real set);
    - rim present on only ~45% of bodies, drawn on the TEXTURE boundary
      (not the label).

    ``knobs`` overlays :data:`REAL_KNOBS` (calibration only — the CLI
    always uses the defaults); ``oracle``, if a list, collects the
    per-image texture-EVIDENCE mask (what a perfect texture segmenter
    would predict: the jittered body on salt images, the decoy on decoy
    empties, zeros elsewhere) so tools/calibrate_real.py can measure
    the generator's score ceiling without training anything. Neither
    parameter touches the RNG stream: (knobs, oracle) leave the arrays
    for any fixed (n, seed, empty_fraction, size) unchanged.
    """
    from scipy.ndimage import distance_transform_edt

    k = dict(REAL_KNOBS, **(knobs or {}))
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    col = np.arange(size, dtype=np.float64)
    images = np.empty((n, size, size), dtype=np.uint8)
    masks = np.zeros((n, size, size), dtype=np.uint8)
    depths = rng.randint(50, 959, size=n)

    def strata():
        warp = np.zeros(size)
        for _ in range(3):
            warp += rng.uniform(1.0, 7.0) * np.sin(
                2 * np.pi * col / rng.uniform(25, 80)
                + rng.uniform(0, 2 * np.pi))
        lam = rng.uniform(5.0, 16.0)
        band = 22 * np.sin(2 * np.pi * (yy + warp[None, :]) / lam
                           + rng.uniform(0, 2 * np.pi))
        band += 10 * np.sin(2 * np.pi * (yy + 0.5 * warp[None, :])
                            / (lam * 2.7) + rng.uniform(0, 2 * np.pi))
        return band

    def salt_blob(jx=0.0, jy=0.0):
        """One salt body; (jx, jy) shifts it (annotation jitter)."""
        if rng.rand() < 0.4:            # half-space below a wavy boundary
            b0 = rng.uniform(0.15, 0.9) * size
            bwarp = np.zeros(size)
            for _ in range(2):
                bwarp += rng.uniform(2, 10) * np.sin(
                    2 * np.pi * col / rng.uniform(40, 130)
                    + rng.uniform(0, 2 * np.pi))
            return yy + jy > (b0 + bwarp[None, :])
        # star-convex dome, size-skewed small via beta(1.2, small_bias)
        cx, cy = rng.randint(10, size - 10, 2)
        r0 = 6.0 + 40.0 * rng.beta(1.2, k["small_bias"])
        ecc = rng.uniform(0.6, 1.6)
        dx, dy = (xx + jx - cx) * ecc, yy + jy - cy
        theta = np.arctan2(dy, dx)
        rad = r0 * np.ones_like(theta)
        for m in range(2, 6):
            rad += r0 * (rng.uniform(0, 0.3) / m) * np.sin(
                m * theta + rng.uniform(0, 2 * np.pi))
        return np.hypot(dx, dy) < rad

    def paint(base, band, tex, snr):
        """Blend interior texture into the strata with a feathered
        boundary; optional rim on the texture contour."""
        if not tex.any() or tex.all():
            alpha = tex.astype(np.float64)
        else:
            sd = (distance_transform_edt(tex)
                  - distance_transform_edt(~tex))   # >0 inside
            bw = rng.uniform(k["feather_lo"], k["feather_hi"])
            alpha = 1.0 / (1.0 + np.exp(-sd / bw))
        interior = (0.25 * band + rng.normal(0, 9, (size, size))
                    + rng.uniform(4, 14))
        base = base + alpha * snr * (interior + 120.0 - base)
        if tex.any() and not tex.all() and rng.rand() < k["rim_p"]:
            rim_band = np.exp(-0.5 * (np.abs(sd) / 1.3) ** 2)
            base = base + rim_band * snr * rng.uniform(k["rim_lo"],
                                                       k["rim_hi"])
        return base

    for i in range(n):
        z = float(depths[i])
        band = strata()
        base = 120.0 + band
        evidence = None
        p_salt = min(1.0, max(0.0, (1.0 - empty_fraction)
                              * (0.4 + 1.2 * (z - 50.0) / 909.0)))
        if rng.rand() < p_salt:
            # annotation jitter: the texture evidence is drawn from a
            # body offset ~N(0, jitter) from the labelled one
            state = rng.get_state()
            jx, jy = rng.normal(0, k["jitter_px"], 2)
            label = salt_blob(0.0, 0.0)
            rng.set_state(state)
            rng.normal(0, k["jitter_px"], 2)   # keep streams aligned
            tex = salt_blob(jx, jy)
            if label.any():
                snr = rng.uniform(k["snr_lo"], k["snr_hi"])
                base = paint(base, band, tex, snr)
                masks[i] = label.astype(np.uint8)
                evidence = tex
        elif rng.rand() < k["decoy_p"]:
            # empty image with salt-LOOKING low-contrast texture
            decoy = salt_blob(0.0, 0.0)
            if not decoy.all():
                base = paint(base, band, decoy,
                             rng.uniform(0.1, k["decoy_snr"]))
                evidence = decoy
        if oracle is not None:
            oracle.append(np.zeros((size, size), np.uint8)
                          if evidence is None else
                          evidence.astype(np.uint8))
        gx, gy = rng.uniform(-14, 14, 2)
        base += gx * (xx / size) + gy * (yy / size)
        base = 128.0 + rng.uniform(0.75, 1.15) * (base - 128.0)
        base += rng.normal(0, k["noise"], (size, size))
        images[i] = np.clip(base, 0, 255).astype(np.uint8)
    return images, masks, depths


def synthetic_metadata(images: np.ndarray, masks: np.ndarray,
                       depths: np.ndarray, is_train: Optional[np.ndarray] = None
                       ) -> pd.DataFrame:
    """Build an in-memory metadata frame matching the on-disk contract
    (columns per reference: utils.py:147-168) with virtual file paths."""
    n = len(images)
    if is_train is None:
        is_train = np.ones(n, dtype=int)
    sizes = masks.reshape(n, -1).sum(axis=1)
    return pd.DataFrame({
        "file_path_image": [f"<synthetic>/{i}.png" for i in range(n)],
        "file_path_mask": [f"<synthetic>/m{i}.png" for i in range(n)],
        "is_train": is_train,
        "id": [f"syn{i:06d}" for i in range(n)],
        "z": depths,
        "size": sizes,
        "is_not_empty": (sizes > 0).astype(int),
    })


def write_synthetic_dataset(root: str, n_train: int = 40, n_test: int = 10,
                            seed: int = 0, difficulty: str = "easy"
                            ) -> Tuple[str, str, str]:
    """Materialize a synthetic dataset in the reference's on-disk layout
    (train/{images,masks}, test/images, depths.csv) for IO-path tests."""
    from PIL import Image
    imgs, msks, depths = synthetic_arrays(n_train + n_test, seed=seed,
                                          difficulty=difficulty)
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    os.makedirs(os.path.join(train_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(train_dir, "masks"), exist_ok=True)
    os.makedirs(os.path.join(test_dir, "images"), exist_ok=True)
    ids, zs = [], []
    for i in range(n_train + n_test):
        image_id = f"syn{i:06d}"
        ids.append(image_id)
        zs.append(int(depths[i]))
        if i < n_train:
            Image.fromarray(imgs[i]).save(
                os.path.join(train_dir, "images", image_id + ".png"))
            Image.fromarray((msks[i] * 255).astype(np.uint8)).save(
                os.path.join(train_dir, "masks", image_id + ".png"))
        else:
            Image.fromarray(imgs[i]).save(
                os.path.join(test_dir, "images", image_id + ".png"))
    depths_path = os.path.join(root, "depths.csv")
    pd.DataFrame({"id": ids, "z": zs}).to_csv(depths_path, index=False)
    return train_dir, test_dir, depths_path
