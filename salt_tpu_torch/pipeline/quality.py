"""The int8 quality gate's artifacts (counterpart of
``salt_tpu/pipeline/quality.py``).

Int8 inference loads the same checkpoint but is not the same arithmetic,
so whenever the CV flow runs with ``model.quant_bits`` set, each fold's
checkpoint is evaluated through the float and the int8 predict paths on
the fold's validation split, and the IOUT delta is written as
``int8_gate_<name>.json`` in the experiment dir, keyed by the
checkpoint's sha256. ``serve --int8`` then writes the provenance next to
the submission (``<out>.int8_gate.json``): the checkpoints' hashes and
the gate artifacts that match them, ``gate_status`` "measured" when any
does. File names and keys are the JAX package's, so either package reads
the other's artifacts.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np

from salt_tpu_torch.core.logging import get_logger

logger = get_logger()


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def run_fold_int8_gate(config, experiment, name: str, valid_bundle,
                       runner_fp, probs_q: np.ndarray) -> Dict:
    """Evaluate checkpoint ``name`` on ``valid_bundle`` through the float
    predict path (``runner_fp``, built with ``quant_bits`` 0) beside
    ``probs_q``, the int8 path's probabilities of the same split (the CV
    loop's own validation pass), and write the IOUT delta artifact.
    Returns the gate dict."""
    from salt_tpu_torch.pipeline import api

    probs_fp, = api._predict_bundles(runner_fp, experiment, name,
                                     valid_bundle)
    scores = {}
    for tag, probs in (("float", probs_fp), ("int8", probs_q)):
        y_pred = api._binarize(probs, config.postpro.threshold_masks)
        iou, iout = api.calculate_scores(list(valid_bundle.masks), y_pred)
        scores[tag] = {"iou": iou, "iout": iout}

    ckpt = experiment.checkpoint_path(name, "best")
    gate = {
        "checkpoint": ckpt,
        "checkpoint_sha256": file_sha256(ckpt),
        "quant_bits": int(config.model.quant_bits),
        "n_validation_images": int(len(valid_bundle)),
        "float": scores["float"],
        "int8": scores["int8"],
        "iout_delta": scores["int8"]["iout"] - scores["float"]["iout"],
    }
    experiment.save_json(f"int8_gate_{name}", gate)
    logger.info("int8 gate %s: IOUT float %.5f int8 %.5f delta %+.5f",
                name, scores["float"]["iout"], scores["int8"]["iout"],
                gate["iout_delta"])
    return gate


def load_gate_artifacts(experiment_dir: str) -> List[Dict]:
    """Every int8 gate artifact written under an experiment dir."""
    out = []
    for p in sorted(glob.glob(os.path.join(experiment_dir,
                                           "int8_gate_*.json"))):
        try:
            with open(p) as f:
                out.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def write_serve_provenance(out_csv: str, ckpt_paths: List[str],
                           quant_bits: int, checkpoint_arg: str = "",
                           hashes: Optional[Dict[str, str]] = None
                           ) -> Optional[str]:
    """Write the int8 provenance next to the submission: the checkpoints'
    hashes and the gate artifacts whose checkpoint hash matches one of
    them. Returns its path, or None when quantization is off. ``hashes``
    maps each path to its :func:`file_sha256` where the caller has them
    already (None: the files are read and hashed here)."""
    if not quant_bits:
        return None
    hashes = {p: file_sha256(p) if hashes is None else hashes[p]
              for p in ckpt_paths}
    gates: List[Dict] = []
    # the artifacts live in the experiment dir; --checkpoint may name the
    # dir itself or a best.npz inside its checkpoints/ tree: walk up
    # until artifacts appear
    probe = checkpoint_arg
    if probe and os.path.isfile(probe):
        probe = os.path.dirname(probe)
    for _ in range(4):
        if not probe:
            break
        if os.path.isdir(probe):
            gates = load_gate_artifacts(probe)
            if gates:
                break
        parent = os.path.dirname(probe.rstrip(os.sep))
        if parent == probe:
            break
        probe = parent
    matched = [g for g in gates
               if g.get("checkpoint_sha256") in hashes.values()]
    payload = {
        "quant_bits": int(quant_bits),
        "checkpoints": [{"path": p, "sha256": h} for p, h in hashes.items()],
        "gates": matched,
        "gate_status": ("measured" if matched else
                        "UNMEASURED — no int8 gate artifact matches these "
                        "checkpoints; run the CV flow with quant_bits=8 "
                        "to measure the IOUT delta before shipping"),
    }
    path = out_csv + ".int8_gate.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    if not matched:
        logger.warning("int8 serve without a matching quality gate "
                       "artifact — provenance recorded as UNMEASURED (%s)",
                       path)
    return path
