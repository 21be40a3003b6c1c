"""The port's step tooling on the CPU: ``train/trace.py`` (the phases
of ``tests/test_verify_trace.py:129-150``), ``train/cost_analysis.py``
(the report of ``tests/test_cost_analysis.py:20-51``, its FLOPs held to
a hand count of each conv's 2 B H W Cin Cout kh kw / groups), the
CLI's ``cost-analysis``, ``train --trace-steps`` and ``train --profile``
with ``--device cpu``, and a fold-parallel
``train-evaluate-predict-cv`` through the CLI. SaltUNet, 8 filters,
fp32, small batches."""
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

SMALL = ["--set", "model.architecture=SaltUNet", "--set", "model.n_filters=8",
         "--set", "model.repeat_blocks=3",
         "--set", "training.batch_size_train=4",
         "--set", "training.batch_size_inference=4",
         "--set", "training.dtype=float32", "--set", "execution.n_cv_splits=2",
         "--device", "cpu"]


@pytest.fixture
def runner():
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 3
    cfg.training.dtype = "float32"
    cfg.training.batch_size_train = 4
    cfg.training.batch_size_inference = 4
    cfg.postpro.use_tta = True
    return SegmentationRunner(cfg, "cpu")


def test_trace_steps_phases(tmp_path, runner):
    from salt_tpu_torch.train.trace import PHASES, trace_steps
    b = synthetic_bundle(8, seed=3)
    out = str(tmp_path / "channels_trace.jsonl")
    timings = trace_steps(runner, b.images[:4], b.masks[:4], iters=2,
                          out_path=out)
    assert set(timings) == set(PHASES) == {"h2d", "aug", "fwd_loss", "full",
                                           "bwd_opt"}
    assert all(v >= 0 for v in timings.values())
    assert timings["full"] > 0
    assert timings["bwd_opt"] == pytest.approx(
        max(timings["full"] - timings["fwd_loss"], 0.0))
    lines = [json.loads(line) for line in open(out)]
    assert {line["phase"] for line in lines} == set(timings)
    assert all(line["kind"] == "trace" and line["batch_size"] == 4
               for line in lines)


class _HandCount(TorchDispatchMode):
    """2 B Ho Wo Cout (Cin / groups) kh kw of every convolution run, and
    2 M N K of every matrix product (the dense layers)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        if func is aten.convolution.default:
            x, w, groups = args[0], args[1], args[8]
            assert not args[6]                   # not transposed
            b, cout, ho, wo = out.shape
            self.flops += (2 * b * ho * wo * cout * (x.shape[1] // groups)
                           * w.shape[2] * w.shape[3])
        elif func in (aten.mm.default, aten.addmm.default):
            a, b = args[-2:] if func is aten.mm.default else args[1:3]
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return out


def test_analyze_runner_reports_all_steps(runner):
    from salt_tpu_torch.train.cost_analysis import analyze_runner, report
    analyses = analyze_runner(runner, batch_train=4, batch_infer=4)
    assert set(analyses) == {"train_step", "predict_step",
                             "predict_tta_step"}
    for name, a in analyses.items():
        assert a["flops"] > 0, name
        assert a["bytes_accessed"] > 0, name
        assert a["bound"] in ("flop", "bandwidth")
        assert a["ideal_ms_flop_bound"] >= 0
        assert a["temp_bytes"] is None            # the CPU: not measured
        assert a["argument_bytes"] > 0 and a["output_bytes"] > 0
    assert analyses["train_step"]["flops"] > analyses["predict_step"]["flops"]
    assert analyses["predict_tta_step"]["flops"] == pytest.approx(
        2 * analyses["predict_step"]["flops"])
    txt = report(analyses, measured_ms={"train_step": 100.0})
    assert "train_step" in txt and "MFU" in txt and "upper estimate" in txt
    json.dumps(analyses)

    # the predict step's FLOPs are its convs' and dense layers' (counted
    # by hand)
    model = runner.init_model(0)
    with _HandCount() as count:
        runner.predict_step(model, torch.zeros((4, 101, 101),
                                               dtype=torch.uint8))
    assert count.flops > 0
    assert analyses["predict_step"]["flops"] == count.flops


def test_recorded_kernel_costs_and_their_bound():
    """``ops/costs.py``: a launch is kept only inside a recording, with
    its shape; the bound of launches together is their bytes at the
    memory rate or their operations each at its own rate, the larger."""
    from salt_tpu_torch.ops import costs
    costs.record("sort", 10, 10, costs.FP32_FLOPS, (1, 2))   # not kept
    with costs.recording() as outer:
        costs.record("preprocess", 6 * 128 * 128, 101 * 101 + 3 * 128 * 128
                     * 2, costs.FP32_FLOPS, (1, 101, 101))
        with costs.recording() as inner:
            costs.record("conv", 2 * 10 ** 12, 10 ** 6,
                         costs.BF16_DENSE_FLOPS, (48, 64, 64, 64))
    assert [c.kernel for c in outer] == ["preprocess", "conv"]
    assert [c.shape for c in inner] == [(48, 64, 64, 64)]
    ms, by = costs.launches_bound_ms(outer[:1])
    assert by == "bytes"
    assert ms == pytest.approx(outer[0].nbytes / costs.HBM_BYTES_PER_S * 1e3)
    ms, by = costs.launches_bound_ms(outer)
    assert by == "operations"
    assert ms == pytest.approx((6 * 128 * 128 / costs.FP32_FLOPS
                                + 2e12 / costs.BF16_DENSE_FLOPS) * 1e3)
    assert costs.bound_ms(3.35e9, 0, 1.0) == pytest.approx((1.0, "bytes"))
    with pytest.raises(ValueError):
        costs.launches_bound_ms([])


def test_busy_time_is_the_union_of_event_intervals():
    """``tools/profiling.busy_us``: overlapping kernels (two streams)
    count once, gaps not at all, in any order."""
    from types import SimpleNamespace

    from salt_tpu_torch.tools.profiling import busy_us

    def event(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start,
                                                          end=end))
    spans = [(30, 35), (0, 10), (5, 12), (12, 20), (6, 8), (40, 41)]
    assert busy_us([event(*s) for s in spans]) == 20 + 5 + 1
    assert sum(e - s for s, e in spans) > 26
    assert busy_us([]) == 0.0


def test_one_conv_layer_train_flops_equal_the_hand_count():
    """A 3x3 conv's forward is 2 B H W Cin Cout 9 FLOPs, and a train
    step of it (the input and the weight taking gradients) three times
    that."""
    from salt_tpu_torch.train.cost_analysis import analyze_program
    b, cin, cout, h, w = 2, 8, 16, 12, 10
    x = torch.randn(b, cin, h, w, requires_grad=True)
    weight = torch.randn(cout, cin, 3, 3, requires_grad=True)
    hand = 2 * b * h * w * cin * cout * 9
    fwd = analyze_program(lambda: F.conv2d(x, weight, padding=1), "cpu",
                          [x, weight])
    assert fwd["flops"] == hand

    def step():
        F.conv2d(x, weight, padding=1).square().sum().backward()
    assert analyze_program(step, "cpu", [x, weight])["flops"] == 3 * hand


def test_cli_cost_analysis(tmp_path):
    from salt_tpu_torch import cli
    exp = tmp_path / "exp"
    rc = cli.main(["cost-analysis", "--synthetic", "8",
                   "--set", f"paths.experiment_dir={exp}", *SMALL])
    assert rc == 0
    data = json.loads((exp / "cost_analysis.json").read_text())
    assert data["train_step"]["flops"] > 0
    assert set(data) >= {"train_step", "predict_step"}


def test_cli_train_trace_steps_and_profile(tmp_path):
    from salt_tpu_torch import cli
    from salt_tpu_torch.tools.profiling import read_trace
    exp, prof = tmp_path / "exp", tmp_path / "prof"
    rc = cli.main(["train", "--synthetic", "8", "--epochs", "1",
                   "--trace-steps", "--profile", str(prof),
                   "--set", f"paths.experiment_dir={exp}", *SMALL])
    assert rc == 0
    phases = [json.loads(line)["phase"]
              for line in open(exp / "channels_trace.jsonl")]
    assert sorted(phases) == sorted(["h2d", "aug", "fwd_loss", "full",
                                     "bwd_opt"])
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    assert read_trace(str(prof / "trace.json")) == {}   # no device kernels
    assert os.path.exists(exp / "checkpoints" / "network" / "best.npz")


def test_cli_fold_parallel_cv(tmp_path):
    """``train-evaluate-predict-cv --set parallel.fold_parallel=true``:
    one fold-parallel fit, then the sequential loop's evaluation half
    reads each fold's ``best.npz``."""
    from salt_tpu_torch import cli
    exp = tmp_path / "exp"
    rc = cli.main(["train-evaluate-predict-cv", "--synthetic", "16",
                   "--epochs", "1", "--set", "parallel.fold_parallel=true",
                   "--set", f"paths.experiment_dir={exp}", *SMALL])
    assert rc == 0
    for i in range(2):
        fold = exp / "checkpoints" / f"network_fold_{i}"
        assert (fold / "best.npz").exists()
        assert (exp / f"channels_network_fold_{i}.jsonl").exists()
    scores = json.loads((exp / "cv_scores.json").read_text())
    assert len(scores["fold_iout"]) == 2
    assert (exp / "submission.csv").exists()
    assert json.loads((exp / "config.json").read_text())["parallel"][
        "fold_parallel"] is True
