"""Command line of the port (the ``serve`` command of ``salt_tpu/cli.py``).

Usage:
    python -m salt_tpu_torch.cli serve --checkpoint EXP_DIR_OR_NPZ \
        --images-dir DIR [--out submission.csv] [--no-tta] \
        [--probs-out probs.npz] [--config cfg.yaml] [--set section.field=v] \
        [--device cuda|cpu]

It runs on the CUDA card by default and fails where there is none,
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

from salt_tpu_torch.core.config import load_config
from salt_tpu_torch.core.logging import init_logger


def _parse_overrides(items):
    overrides = {}
    for item in items:
        key, value = item.split("=", 1)
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        if value in ("true", "True"):
            value = True
        if value in ("false", "False"):
            value = False
        overrides[key] = value
    return overrides


def main(argv=None):
    parser = argparse.ArgumentParser(prog="salt_tpu_torch")
    parser.add_argument("command", choices=["serve"])
    parser.add_argument("--config", default=None,
                        help="YAML config (native nested or reference-style "
                             "'parameters:' layout); falls back to "
                             "CONFIG_PATH env var")
    parser.add_argument("--set", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE",
                        help="config overrides, e.g. "
                             "--set training.batch_size_inference=48")
    parser.add_argument("--checkpoint", default="",
                        help="best.npz file, experiment dir, or CV "
                             "experiment dir (fold checkpoints ensembled)")
    parser.add_argument("--images-dir", default="",
                        help="directory of 101x101 PNGs")
    parser.add_argument("--out", default="submission.csv",
                        help="submission CSV path")
    parser.add_argument("--probs-out", default="",
                        help="also write float16 probabilities npz")
    parser.add_argument("--no-tta", action="store_true",
                        help="plain single-pass inference")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    init_logger()
    overrides = _parse_overrides(args.set)
    cfg = load_config(args.config, overrides)
    from salt_tpu_torch.pipeline.serving import serve
    cfg.postpro.use_tta = not args.no_tta
    print(serve(cfg, args.checkpoint, args.images_dir, args.out,
                args.probs_out, user_set=tuple(overrides),
                device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
