"""Command line of the port (the ``prepare-metadata``, ``train``,
``evaluate``, ``predict``, CV and ``serve`` commands of
``salt_tpu/cli.py``).

Usage:
    python -m salt_tpu_torch.cli prepare-metadata [--config cfg.yaml] \
        [--set paths.field=v]
    python -m salt_tpu_torch.cli train [--synthetic N] \
        [--synthetic-difficulty easy|hard|real] [--epochs E] [--resume] \
        [--dev-mode] [--config cfg.yaml] [--set section.field=v] \
        [--device cuda|cpu]
    python -m salt_tpu_torch.cli evaluate | predict | train-evaluate-cv |
        train-evaluate-predict-cv | evaluate-cv | evaluate-predict-cv
        [the same options as train]
    python -m salt_tpu_torch.cli serve --checkpoint EXP_DIR_OR_NPZ \
        --images-dir DIR [--out submission.csv] [--no-tta] \
        [--probs-out probs.npz] [--int8] [--config cfg.yaml] \
        [--set section.field=v] [--device cuda|cpu]
    python -m salt_tpu_torch.cli serve --synthetic N \
        [--checkpoint EXP_DIR_OR_NPZ] [the other serve options]

``prepare-metadata`` scans ``paths.train_images_dir`` (``images/``,
``masks/``), ``paths.test_images_dir`` (``images/``) and
``paths.depths_filepath`` and writes ``paths.metadata_filepath``, the CSV
the other commands read; it touches no device. ``train`` fits the
configured network on the first fold of the data
(``paths.metadata_filepath``, or N generated images with ``--synthetic``
and a test set of max(N // 4, 8) images without masks, seed + 1) into
``paths.experiment_dir``; the CV commands train and/or evaluate every
fold there, and the ``predict`` ones write ``submission.csv``.
``serve --synthetic N`` serves N generated images (seed
``execution.seed``) in place of ``--images-dir``, from the checkpoint or,
without one, from the runner's seeded initial weights. ``serve --int8``
sets ``model.quant_bits=8`` (the int8 convs) and, from checkpoints,
writes ``<out>.int8_gate.json``; the CV commands with ``--set
model.quant_bits=8`` write each fold's ``int8_gate_<name>.json``. Every other
command runs on the CUDA card by default and fails where there is
none, unless ``--device cpu`` is given.
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
    parser.add_argument("command", choices=[
        "prepare-metadata", "train", "evaluate", "predict",
        "train-evaluate-cv", "train-evaluate-predict-cv", "evaluate-cv",
        "evaluate-predict-cv", "serve"])
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
    parser.add_argument("--int8", action="store_true",
                        help="serve: int8 convs (model.quant_bits=8)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="N generated images instead of the data "
                             "dirs (and max(N // 4, 8) test images); serve: "
                             "N generated images instead of --images-dir")
    parser.add_argument("--synthetic-difficulty", default="easy",
                        choices=["easy", "hard", "real"])
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="train: continue from the 'last' checkpoint "
                             "(optimizer state and epoch)")
    parser.add_argument("--dev-mode", action="store_true")
    args = parser.parse_args(argv)

    init_logger()
    overrides = _parse_overrides(args.set)
    cfg = load_config(args.config, overrides)
    if args.command == "prepare-metadata":
        from salt_tpu_torch.data.metadata import generate_metadata
        meta = generate_metadata(cfg.paths.train_images_dir,
                                 cfg.paths.test_images_dir,
                                 cfg.paths.depths_filepath)
        meta.to_csv(cfg.paths.metadata_filepath, index=None)
        print(f"metadata saved to {cfg.paths.metadata_filepath}")
        return 0
    if args.command != "serve":
        return _run(cfg, args)
    from salt_tpu_torch.pipeline.serving import serve
    if args.int8:
        cfg.model.quant_bits = 8
    cfg.postpro.use_tta = not args.no_tta
    print(serve(cfg, args.checkpoint, args.images_dir, args.out,
                args.probs_out, synthetic=args.synthetic,
                synthetic_difficulty=args.synthetic_difficulty,
                user_set=tuple(overrides), device=args.device))
    return 0


def _bundles(cfg, synthetic: int, difficulty: str = "easy"):
    """(train, test) bundles: ``synthetic`` generated images and a test
    set of max(synthetic // 4, 8) without masks, or the data dirs."""
    if synthetic:
        from salt_tpu_torch.data.bundle import synthetic_bundle
        train = synthetic_bundle(synthetic, seed=cfg.execution.seed,
                                 difficulty=difficulty)
        test = synthetic_bundle(max(synthetic // 4, 8),
                                seed=cfg.execution.seed + 1, with_masks=False,
                                difficulty=difficulty)
        return train, test
    from salt_tpu_torch.data.bundle import train_test_bundles
    return train_test_bundles(cfg)


def _run(cfg, args) -> int:
    from salt_tpu_torch.core.device import resolve_device
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.pipeline import api
    device = resolve_device(args.device)
    if args.dev_mode:
        cfg.execution.dev_mode = True
    if args.resume:
        cfg.execution.resume = True
    if args.epochs is not None:
        cfg.training.epochs = args.epochs
    train_b, test_b = _bundles(cfg, args.synthetic, args.synthetic_difficulty)
    experiment = Experiment(cfg.paths.experiment_dir,
                            overwrite=cfg.execution.overwrite,
                            clone_from=cfg.execution.clone_experiment_dir_from)
    command = args.command
    if command == "train":
        api.train(cfg, experiment, train_b, device=device)
    elif command == "evaluate":
        print(api.evaluate(cfg, experiment, train_b, device=device))
    elif command == "predict":
        api.predict(cfg, experiment, test_b, device=device)
    elif command == "train-evaluate-cv":
        print(api.train_evaluate_cv(cfg, experiment, train_b, device))
    elif command == "train-evaluate-predict-cv":
        print(api.train_evaluate_predict_cv(cfg, experiment, train_b, test_b,
                                            device))
    elif command == "evaluate-cv":
        print(api.evaluate_cv(cfg, experiment, train_b, device))
    else:
        print(api.evaluate_predict_cv(cfg, experiment, train_b, test_b,
                                      device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
