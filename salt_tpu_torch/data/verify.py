"""Day-one data / experiment integrity checks, the ``verify-data``
command (counterpart of ``salt_tpu/data/verify.py``), against the port's
pack cache (``data/bundle.py``) and checkpoints. It touches no device.

The reference has no preflight at all: a broken metadata row or a
stale/incompatible checkpoint surfaces an hour into training
(reference: prepare_metadata.py, common_blocks/utils.py:135-170 build
the contract but nothing validates it). ``verify_data`` re-validates
everything the first real run depends on, in seconds:

  metadata    columns + id uniqueness + referenced files exist
  depths      z present, numeric, and joinable for every row
  images      a sample decodes to the expected raw shape; masks binary
  pack-cache  cached pack shapes/dtype agree with the metadata
  checkpoint  persisted best.npz keys/shapes agree with the configured
              architecture's fresh-init parameter tree

Returns {check: {"ok": bool, "detail": str}}; the CLI exits non-zero if
any check fails.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from salt_tpu_torch.core.config import Config

REQUIRED_COLUMNS = ["file_path_image", "file_path_mask", "is_train", "id",
                    "z", "size", "is_not_empty"]


def _check(ok: bool, detail: str = "") -> Dict[str, object]:
    return {"ok": bool(ok), "detail": detail}


def verify_metadata(meta: pd.DataFrame, sample_images: int = 8
                    ) -> Dict[str, Dict[str, object]]:
    out: Dict[str, Dict[str, object]] = {}

    missing_cols = [c for c in REQUIRED_COLUMNS if c not in meta.columns]
    if missing_cols:
        out["metadata"] = _check(False, f"missing columns: {missing_cols}")
        return out
    dup = meta["id"].duplicated().sum()
    if dup:
        out["metadata"] = _check(False, f"{dup} duplicate ids")
    else:
        out["metadata"] = _check(True, f"{len(meta)} rows")

    # depths join (reference: utils.py:147-168 joins depths.csv by id)
    z = pd.to_numeric(meta["z"], errors="coerce")
    bad_z = int(z.isna().sum())
    out["depths"] = _check(bad_z == 0,
                           f"{bad_z} rows with missing/non-numeric z"
                           if bad_z else "all rows joined")

    # referenced files exist
    missing = []
    for _, row in meta.iterrows():
        if not os.path.exists(str(row["file_path_image"])):
            missing.append(str(row["file_path_image"]))
        if row["is_train"] == 1 and not os.path.exists(
                str(row["file_path_mask"])):
            missing.append(str(row["file_path_mask"]))
        if len(missing) >= 5:
            break
    out["files"] = _check(not missing,
                          f"missing (first {len(missing)}): {missing}"
                          if missing else "all paths exist")
    if missing:
        return out

    # decode a sample: raw shape + binary masks (binarize-at-128
    # convention, reference: loaders.py:61)
    try:
        from PIL import Image
        from salt_tpu_torch.data.images import to_grayscale
        rows = meta[meta["is_train"] == 1].head(sample_images)
        if not len(rows):
            rows = meta.head(sample_images)
        bad = []
        for _, row in rows.iterrows():
            img = to_grayscale(np.array(Image.open(row["file_path_image"])))
            if img.shape != (101, 101):
                bad.append(f"{row['id']}: image shape {img.shape}")
            if row["is_train"] == 1 and isinstance(row["file_path_mask"],
                                                   str):
                m = np.array(Image.open(row["file_path_mask"]))
                vals = np.unique(to_grayscale(m))
                # binarize-at-128 convention (reference loaders.py:61):
                # anything other than pure {0, 255} levels means the mask
                # was resampled/anti-aliased and thresholding is lossy
                if not np.isin(vals, (0, 255)).all():
                    bad.append(f"{row['id']}: non-binary mask values "
                               f"{vals[:5]}")
        out["images"] = _check(not bad, "; ".join(bad) if bad
                               else f"sampled {len(rows)} rows, shapes ok")
    except Exception as e:                              # decode failure
        out["images"] = _check(False, f"decode failed: {e}")
    return out


def verify_pack_cache(config: Config, meta: pd.DataFrame
                      ) -> Dict[str, object]:
    """Cached pack (data/bundle.py) must agree with the metadata in
    length and shape; the content key already covers staleness."""
    cache = config.execution.pack_cache_dir
    if not cache:
        return _check(True, "pack cache disabled")
    from salt_tpu_torch.data.bundle import _pack_cache_key
    meta_train = meta[meta["is_train"] == 1].reset_index(drop=True)
    key = _pack_cache_key(meta_train, with_masks=True)
    img_p = os.path.join(cache, f"pack_{key}_images.npy")
    if not os.path.exists(img_p):
        return _check(True, "no cached pack for current metadata "
                            "(will decode fresh)")
    arr = np.load(img_p, mmap_mode="r")
    if arr.shape != (len(meta_train), 101, 101) or arr.dtype != np.uint8:
        return _check(False, f"cached pack shape {arr.shape} dtype "
                             f"{arr.dtype} != ({len(meta_train)}, 101, 101) "
                             "uint8")
    return _check(True, f"cached pack ok: {arr.shape}")


def verify_checkpoints(config: Config, experiment_dir: str
                       ) -> Dict[str, object]:
    """Every persisted best.npz must match the configured architecture's
    flat keys and shapes (either package's checkpoints) — a changed
    config or stale experiment dir fails here instead of mid-restore."""
    paths = sorted(glob.glob(os.path.join(
        experiment_dir, "checkpoints", "network*", "best.npz")))
    if not paths:
        return _check(True, "no checkpoints present")
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.registry import build_model
    # the configured architecture's flat keys and shapes, on the host
    want = {k: v.shape for k, v in
            to_flax_flat(build_model(config.model)).items()}
    problems = []
    for path in paths:
        data = np.load(path)
        have = {k: data[k].shape for k in data.files}
        missing = sorted(set(want) - set(have))[:3]
        extra = sorted(set(have) - set(want))[:3]
        mismatched = [k for k in want.keys() & have.keys()
                      if tuple(want[k]) != tuple(have[k])][:3]
        if missing or extra or mismatched:
            problems.append(
                f"{os.path.relpath(path, experiment_dir)}: "
                f"missing={missing} extra={extra} "
                f"shape-mismatch={[(k, have[k], want[k]) for k in mismatched]}")
    return _check(not problems, "; ".join(problems) if problems
                  else f"{len(paths)} checkpoint(s) match "
                       f"{config.model.architecture}")


def verify_data(config: Config, meta: Optional[pd.DataFrame] = None,
                check_checkpoints: bool = True
                ) -> Dict[str, Dict[str, object]]:
    """Run every check. Returns {check: {"ok":, "detail":}}."""
    results: Dict[str, Dict[str, object]] = {}
    if meta is None:
        path = config.paths.metadata_filepath
        if not os.path.exists(path):
            return {"metadata": _check(False, f"{path} does not exist — "
                                       "run prepare-metadata first")}
        meta = pd.read_csv(path)
    results.update(verify_metadata(meta))
    if results.get("files", {}).get("ok"):
        results["pack_cache"] = verify_pack_cache(config, meta)
    if check_checkpoints:
        results["checkpoint"] = verify_checkpoints(
            config, config.paths.experiment_dir)
    return results
