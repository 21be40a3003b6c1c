"""Command line of the port: every command of ``salt_tpu/cli.py``
(:42-50).

Usage:
    python -m salt_tpu_torch.cli prepare-metadata [--config cfg.yaml] \
        [--set paths.field=v]
    python -m salt_tpu_torch.cli train [--synthetic N] \
        [--synthetic-difficulty easy|hard|real] [--epochs E] [--resume] \
        [--dev-mode] [--config cfg.yaml] [--set section.field=v] \
        [--device cuda|cpu]
    python -m salt_tpu_torch.cli evaluate | predict | train-evaluate-cv |
        train-evaluate-predict-cv | evaluate-cv | evaluate-predict-cv |
        empty-train | empty-evaluate | empty-cv | empty-evaluate-cv |
        empty-evaluate-predict-cv [the same options as train]
    python -m salt_tpu_torch.cli full-solution [--workdir DIR] \
        [--no-stacking] [--stacking-epochs E] [--stacking-lr LR] \
        [the same options as train]
    python -m salt_tpu_torch.cli stacking-cv --stacking-experiments DIR...
    python -m salt_tpu_torch.cli distill --teacher CV_DIR \
        [--distill-alpha A] [--measure-throughput]
    python -m salt_tpu_torch.cli ensemble --experiments DIR... \
        [--weights W...] [--ensemble-method mean|gmean] [--out CSV]
    python -m salt_tpu_torch.cli verify-data | data-stats | analyze \
        [--stacking-experiments DIR...]
    python -m salt_tpu_torch.cli augment-preview [--preview-images N] \
        [--preview-samples S] [--out PNG]
    python -m salt_tpu_torch.cli serve --checkpoint EXP_DIR_OR_NPZ \
        --images-dir DIR [--out submission.csv] [--no-tta] \
        [--probs-out probs.npz] [--int8] [--config cfg.yaml] \
        [--set section.field=v] [--device cuda|cpu]
    python -m salt_tpu_torch.cli serve --synthetic N \
        [--checkpoint EXP_DIR_OR_NPZ] [the other serve options]
    python -m salt_tpu_torch.cli cost-analysis [the options of train]
    python -m salt_tpu_torch.cli <train or CV command> --trace-steps \
        [--profile DIR] [the options of train]

``prepare-metadata`` scans ``paths.train_images_dir`` (``images/``,
``masks/``), ``paths.test_images_dir`` (``images/``) and
``paths.depths_filepath`` and writes ``paths.metadata_filepath``, the CSV
the other commands read. ``train`` fits the configured network on the
first fold of the data (``paths.metadata_filepath``, or N generated
images with ``--synthetic`` and a test set of max(N // 4, 8) images
without masks, seed + 1) into ``paths.experiment_dir``; the CV commands
train and/or evaluate every fold there, and the ``predict`` ones write
``submission.csv``. The ``empty-*`` commands do the same for the
emptiness classifier, ``stacking-cv`` trains the stacking head on the
named experiments' out-of-fold predictions, ``full-solution`` runs
segmentation CV, emptiness CV and stacking into ``--workdir`` and gates
the final submission, and ``distill`` trains the configured student on a
CV teacher's out-of-fold probabilities. ``serve --synthetic N`` serves N
generated images (seed ``execution.seed``) in place of ``--images-dir``,
from the checkpoint or, without one, from the runner's seeded initial
weights. ``serve --int8`` sets ``model.quant_bits=8`` (the int8 convs)
and, from checkpoints, writes ``<out>.int8_gate.json``; the CV commands
with ``--set model.quant_bits=8`` write each fold's
``int8_gate_<name>.json``.

``prepare-metadata``, ``ensemble``, ``verify-data``, ``data-stats`` and
``analyze`` touch no device. Every other command runs on the CUDA card
by default and fails where there is none, unless ``--device cpu`` is
given.

``cost-analysis`` runs the train, predict and (with ``postpro.use_tta``)
TTA steps once each and writes their FLOPs, bytes, memory high-water
mark and roofline to ``<experiment_dir>/cost_analysis.json``
(``train/cost_analysis.py``). ``--trace-steps`` times the train step's
phases first and appends them to ``channels_trace.jsonl``
(``train/trace.py``); ``--profile DIR`` records the command under
``torch.profiler`` (CUDA activity on the card) and writes a Chrome trace
to ``DIR/trace.json`` (``tools/profiling.read_trace`` reads it). Both
apply to the commands that train or predict (not ``serve`` or the host
commands). ``--set parallel.fold_parallel=true`` makes the CV commands
train all folds at once (``parallel/fold_parallel.py``).
"""
from __future__ import annotations

import argparse
import sys

from salt_tpu_torch.core.config import load_config
from salt_tpu_torch.core.logging import init_logger

COMMANDS = [
    "prepare-metadata", "train", "evaluate", "predict",
    "train-evaluate-cv", "train-evaluate-predict-cv",
    "evaluate-cv", "evaluate-predict-cv",
    "empty-train", "empty-evaluate", "empty-cv",
    "empty-evaluate-cv", "empty-evaluate-predict-cv",
    "stacking-cv", "full-solution", "serve", "verify-data",
    "cost-analysis", "analyze", "ensemble", "data-stats",
    "augment-preview", "distill"]


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


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="salt_tpu_torch")
    parser.add_argument("command", choices=COMMANDS)
    parser.add_argument("--config", default=None,
                        help="YAML config (native nested or reference-style "
                             "'parameters:' layout); falls back to "
                             "CONFIG_PATH env var")
    parser.add_argument("--set", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE",
                        help="config overrides, e.g. "
                             "--set training.batch_size_inference=48")
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
    parser.add_argument("--workdir", default="output/full_solution",
                        help="full-solution: root dir of the "
                             "segmentation/emptiness/stacking stages")
    parser.add_argument("--no-stacking", action="store_true",
                        help="full-solution: skip the stacking level")
    parser.add_argument("--stacking-experiments", nargs="*", default=[],
                        metavar="DIR",
                        help="first-level experiment dirs whose oof "
                             "predictions feed the stacking level "
                             "(stacking-cv, data-stats)")
    parser.add_argument("--stacking-epochs", type=int, default=None,
                        help="epochs of the stacking level only (default: "
                             "--epochs)")
    parser.add_argument("--stacking-lr", type=float, default=None,
                        help="learning rate of the stacking level only "
                             "(default: training.lr)")
    parser.add_argument("--experiments", nargs="*", default=[],
                        metavar="DIR",
                        help="ensemble: experiment dirs whose persisted "
                             "test predictions are averaged")
    parser.add_argument("--weights", nargs="*", type=float, default=None,
                        help="ensemble: per-experiment weights "
                             "(default: uniform)")
    parser.add_argument("--ensemble-method", default="mean",
                        choices=["mean", "gmean"])
    parser.add_argument("--teacher", default="",
                        help="distill: CV experiment dir whose persisted "
                             "out-of-fold probabilities are the soft "
                             "targets (the student is the configured model)")
    parser.add_argument("--distill-alpha", type=float, default=None,
                        help="distill: weight of the soft-target BCE "
                             "against the hard-mask training.loss")
    parser.add_argument("--measure-throughput", action="store_true",
                        help="distill: also measure the student's TTA "
                             "images/s and record it in distill_report.json")
    parser.add_argument("--checkpoint", default="",
                        help="serve: best.npz file, experiment dir, or CV "
                             "experiment dir (fold checkpoints ensembled)")
    parser.add_argument("--images-dir", default="",
                        help="serve: directory of 101x101 PNGs")
    parser.add_argument("--out", default=None,
                        help="output path (serve / ensemble: submission "
                             "CSV, default submission.csv; augment-preview: "
                             "PNG, default <experiment_dir>/"
                             "augment_preview.png)")
    parser.add_argument("--probs-out", default="",
                        help="serve: also write float16 probabilities npz")
    parser.add_argument("--no-tta", action="store_true",
                        help="serve: plain single-pass inference")
    parser.add_argument("--int8", action="store_true",
                        help="serve: int8 convs (model.quant_bits=8)")
    parser.add_argument("--preview-images", type=int, default=6,
                        help="augment-preview: number of source images")
    parser.add_argument("--preview-samples", type=int, default=6,
                        help="augment-preview: policy draws per image")
    parser.add_argument("--profile", default="", metavar="DIR",
                        help="record the run under torch.profiler and "
                             "write a Chrome trace to DIR/trace.json")
    parser.add_argument("--trace-steps", action="store_true",
                        help="time the train step's phases (h2d, aug, "
                             "fwd_loss, full, bwd_opt) on one batch first "
                             "and append them to channels_trace.jsonl")
    return parser


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)

    init_logger()
    overrides = _parse_overrides(args.set)
    cfg = load_config(args.config, overrides)
    if args.dev_mode:
        cfg.execution.dev_mode = True
    if args.resume:
        cfg.execution.resume = True
    if args.epochs is not None:
        cfg.training.epochs = args.epochs
    if args.stacking_epochs is not None:
        cfg.training.stacking_epochs = args.stacking_epochs
    if args.stacking_lr is not None:
        cfg.training.stacking_lr = args.stacking_lr
    if args.distill_alpha is not None:
        cfg.training.distill_alpha = args.distill_alpha

    if args.command == "prepare-metadata":
        from salt_tpu_torch.data.metadata import generate_metadata
        meta = generate_metadata(cfg.paths.train_images_dir,
                                 cfg.paths.test_images_dir,
                                 cfg.paths.depths_filepath)
        meta.to_csv(cfg.paths.metadata_filepath, index=None)
        print(f"metadata saved to {cfg.paths.metadata_filepath}")
        return 0
    if args.command == "serve":
        from salt_tpu_torch.pipeline.serving import serve
        if args.int8:
            cfg.model.quant_bits = 8
        cfg.postpro.use_tta = not args.no_tta
        print(serve(cfg, args.checkpoint, args.images_dir,
                    args.out or "submission.csv", args.probs_out,
                    synthetic=args.synthetic,
                    synthetic_difficulty=args.synthetic_difficulty,
                    user_set=tuple(overrides), device=args.device))
        return 0
    if args.command in _HOST_COMMANDS:
        return _HOST_COMMANDS[args.command](cfg, args, parser)
    return _run(cfg, args)


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


def _ensemble(cfg, args, parser) -> int:
    """The prediction_average notebook: average the experiments'
    persisted test probabilities into one submission, and score the
    members and the ensemble out of fold where ground truth is
    reachable."""
    from salt_tpu_torch.pipeline.ensemble import ensemble_experiments
    if not args.experiments:
        parser.error("ensemble requires --experiments DIR [DIR ...]")
    train_b = None
    try:
        train_b, _ = _bundles(cfg, args.synthetic, args.synthetic_difficulty)
    except Exception as e:   # scoring is optional; the submission is not
        print(f"oof scoring skipped (no ground truth reachable: {e})")
    print(ensemble_experiments(
        args.experiments, args.out or "submission.csv", train_b,
        weights=args.weights, method=args.ensemble_method,
        threshold=cfg.postpro.threshold_masks))
    return 0


def _verify_data(cfg, args, parser) -> int:
    from salt_tpu_torch.data.verify import verify_data
    results = verify_data(cfg)
    for name, r in results.items():
        print(f"[{'ok' if r['ok'] else 'FAIL'}] {name}: {r['detail']}")
    return 0 if all(r["ok"] for r in results.values()) else 1


def _data_stats(cfg, args, parser) -> int:
    from salt_tpu_torch.data.stats import bundle_stats, format_stats
    train_b, test_b = _bundles(cfg, args.synthetic, args.synthetic_difficulty)
    print(format_stats(bundle_stats(train_b, test_b)))
    if args.stacking_experiments:
        from salt_tpu_torch.data.stats import (format_stacking_stats,
                                               stacking_stats)
        from salt_tpu_torch.pipeline.stacking import \
            join_experiment_predictions
        ids, cube = join_experiment_predictions(args.stacking_experiments,
                                                "train")
        print(format_stacking_stats(stacking_stats(
            ids, cube, train_b, cfg.postpro.threshold_masks)))
    return 0


def _analyze(cfg, args, parser) -> int:
    """Read-only: the experiment dir is opened without
    ``execution.overwrite``, which would delete what it analyzes."""
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.pipeline.analysis import (analyze_experiment,
                                                  format_report)
    experiment = Experiment(cfg.paths.experiment_dir)
    train_b, _ = _bundles(cfg, args.synthetic, args.synthetic_difficulty)
    print(format_report(analyze_experiment(experiment, train_b,
                                           cfg.postpro.threshold_masks)))
    return 0


_HOST_COMMANDS = {"ensemble": _ensemble, "verify-data": _verify_data,
                  "data-stats": _data_stats, "analyze": _analyze}


def _run(cfg, args) -> int:
    from salt_tpu_torch.core.device import resolve_device
    from salt_tpu_torch.core.experiment import Experiment
    device = resolve_device(args.device)
    command = args.command
    if command == "cost-analysis":
        return _cost_analysis(cfg, device)
    train_b, test_b = _bundles(cfg, args.synthetic, args.synthetic_difficulty)
    if command == "augment-preview":
        from salt_tpu_torch.pipeline.preview import augment_preview
        out = args.out or cfg.paths.experiment_dir + "/augment_preview.png"
        path = augment_preview(train_b, out, n_images=args.preview_images,
                               n_samples=args.preview_samples,
                               seed=cfg.execution.seed, device=device)
        print(f"augmentation preview saved to {path}")
        return 0
    experiment = Experiment(cfg.paths.experiment_dir,
                            overwrite=cfg.execution.overwrite,
                            clone_from=cfg.execution.clone_experiment_dir_from)
    if args.trace_steps:
        _trace_steps(cfg, experiment, train_b, device)
    profiler = _start_profiler(args.profile, device)
    try:
        _command(cfg, args, experiment, train_b, test_b, device)
    finally:
        if profiler is not None:
            _stop_profiler(profiler, args.profile)
    return 0


def _cost_analysis(cfg, device) -> int:
    """What the step programs compute and move on ``device``
    (``train/cost_analysis.py``), printed and written to
    ``<experiment_dir>/cost_analysis.json``."""
    import json
    import os
    from salt_tpu_torch.train.cost_analysis import analyze_runner, report
    from salt_tpu_torch.train.steps import SegmentationRunner
    analyses = analyze_runner(SegmentationRunner(cfg, device))
    print(report(analyses))
    os.makedirs(cfg.paths.experiment_dir, exist_ok=True)
    out_path = os.path.join(cfg.paths.experiment_dir, "cost_analysis.json")
    with open(out_path, "w") as f:
        json.dump(analyses, f, indent=1)
    print(f"saved to {out_path}")
    return 0


def _trace_steps(cfg, experiment, train_b, device) -> None:
    """The train step's phase times on one batch of the train bundle
    (tiled up where the bundle holds fewer images than a batch)."""
    import numpy as np
    from salt_tpu_torch.train.steps import SegmentationRunner
    from salt_tpu_torch.train.trace import trace_steps
    runner = SegmentationRunner(cfg, device)
    bs = cfg.training.batch_size_train

    def take(a):
        return a[:bs] if len(a) >= bs else np.resize(a, (bs,) + a.shape[1:])
    timings = trace_steps(
        runner, take(train_b.images), take(train_b.masks),
        take(train_b.depths) if runner.use_depth else None,
        out_path=experiment.directory + "/channels_trace.jsonl")
    print("trace-steps (ms/step):",
          {k: round(v, 2) for k, v in timings.items()})


def _start_profiler(directory: str, device):
    if not directory:
        return None
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, directory: str) -> None:
    import os
    profiler.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"profiler trace saved to {path}")


def _command(cfg, args, experiment, train_b, test_b, device) -> None:
    from salt_tpu_torch.pipeline import api
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
    elif command == "evaluate-predict-cv":
        print(api.evaluate_predict_cv(cfg, experiment, train_b, test_b,
                                      device))
    elif command.startswith("empty-"):
        from salt_tpu_torch.pipeline import emptiness
        if command == "empty-train":
            emptiness.train(cfg, experiment, train_b, device)
        elif command == "empty-evaluate":
            print(emptiness.evaluate(cfg, experiment, train_b, device))
        elif command == "empty-cv":
            print(emptiness.train_evaluate_predict_cv(cfg, experiment,
                                                      train_b, test_b, device))
        elif command == "empty-evaluate-cv":
            print(emptiness.evaluate_cv(cfg, experiment, train_b, device))
        else:
            print(emptiness.evaluate_predict_cv(cfg, experiment, train_b,
                                                test_b, device))
    elif command == "full-solution":
        from salt_tpu_torch.pipeline.full_solution import run_full_solution
        results = run_full_solution(cfg, args.workdir, train_b, test_b,
                                    use_stacking=not args.no_stacking,
                                    device=device)
        print({k: results[k] for k in
               ("segmentation", "emptiness", "stacking", "gating")})
        print(f"final gated submission -> {results['submission_path']}")
    elif command == "distill":
        from salt_tpu_torch.pipeline.distill import distill
        if not args.teacher:
            raise SystemExit("distill requires --teacher <cv-experiment-dir>")
        print(distill(cfg, experiment, train_b, args.teacher,
                      measure_throughput=args.measure_throughput,
                      device=device))
    else:
        _stacking_cv(cfg, args, experiment, train_b, test_b, device)


def _stacking_cv(cfg, args, experiment, train_b, test_b, device) -> None:
    from salt_tpu_torch.pipeline import stacking
    dirs = args.stacking_experiments
    if not dirs:
        raise SystemExit("stacking-cv requires --stacking-experiments")
    ids, cube = stacking.join_experiment_predictions(dirs, "train")
    bundle, cube = stacking.stacking_bundle(train_b, ids, cube)
    test_cube = test_aligned = None
    try:
        t_ids, t_cube = stacking.join_experiment_predictions(dirs, "test")
        if test_b is not None:
            test_aligned, test_cube = stacking.stacking_bundle(test_b, t_ids,
                                                               t_cube)
    except (FileNotFoundError, ValueError):
        pass
    print(stacking.train_evaluate_stacking(cfg, experiment, bundle, cube,
                                           test_cube, test_aligned, device))


if __name__ == "__main__":
    sys.exit(main())
