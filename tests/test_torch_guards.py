"""The port stands alone and never falls back to the CPU silently.

(g) importing every ``salt_tpu_torch`` module loads no ``jax``, ``flax``,
``optax``, ``aqt`` or ``salt_tpu``; (h) every entry point called without
``device`` raises where CUDA is absent (the CLI's ``cost-analysis``,
``--profile``, ``--trace-steps`` and fold-parallel CV too); (i) the kernels' wrappers refuse what their kernel
cannot take before any launch."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_flax_or_salt_tpu():
    code = r"""
import importlib, pkgutil, sys
import salt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(salt_tpu_torch.__path__,
                                               "salt_tpu_torch.")]
for needed in ("pipeline.serving", "ops.preprocess_kernel", "ops.sort_kernel",
               "ops.bitonic", "ops.augment", "losses.lovasz", "train.loop",
               "train.callbacks", "train.state", "pipeline.api",
               "data.bundle", "metrics.iout", "ops.probe_conv",
               "ops.conv64p_kernel", "ops.conv128_kernel",
               "ops.matmul_kernel", "tools.conv_probe", "tools.conv_probe2",
               "tools.ab_conv", "tools.preprocess_ab", "data.metadata",
               "models.salt_unet", "losses.dice", "losses.focal",
               "train.throughput", "tools.bench", "tools.profiling",
               "models.models_with_depth", "models.torch_import",
               "models.large_kernel_matters", "models.pspnet",
               "models.stacking", "models.emptiness", "models.quant",
               "ops.int8_conv", "pipeline.quality", "metrics.auc",
               "ops.coco_rle", "data.auxiliary", "data.stats", "data.verify",
               "train.classifier", "train.stacking", "train.distill",
               "pipeline.emptiness", "pipeline.stacking",
               "pipeline.full_solution", "pipeline.ensemble",
               "pipeline.analysis", "pipeline.preview", "pipeline.distill",
               "parallel.mesh", "parallel.dryrun", "parallel.fold_parallel",
               "train.trace", "train.cost_analysis", "utils", "ops.costs",
               "tools.distill_curve"):
    assert "salt_tpu_torch." + needed in names, names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "salt_tpu", "aqt")
             or m.startswith(("jax.", "flax.", "optax.", "salt_tpu.",
                              "aqt.")))
assert not bad, bad
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 58


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_runner_defaults_to_cuda_and_raises(no_cuda):
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.train.steps import SegmentationRunner
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentationRunner(default_config())
    assert SegmentationRunner(default_config(), device="cpu").device.type == "cpu"


def test_serve_defaults_to_cuda_and_raises(no_cuda, tmp_path):
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.pipeline.serving import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(default_config(), str(tmp_path / "ckpt.npz"), str(tmp_path),
              str(tmp_path / "s.csv"))


def test_cli_defaults_to_cuda_and_raises(no_cuda, tmp_path):
    from salt_tpu_torch import cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["serve", "--checkpoint", str(tmp_path / "ckpt.npz"),
                  "--images-dir", str(tmp_path),
                  "--out", str(tmp_path / "s.csv")])


@pytest.mark.parametrize("command", ["empty-cv", "empty-train",
                                     "full-solution", "stacking-cv",
                                     "distill", "augment-preview"])
def test_cli_new_commands_default_to_cuda_and_raise(no_cuda, tmp_path,
                                                    command):
    from salt_tpu_torch import cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([command, "--synthetic", "8", "--epochs", "1",
                  "--workdir", str(tmp_path / "w"),
                  "--set", f"paths.experiment_dir={tmp_path / 'e'}"])
    assert not (tmp_path / "e").exists() and not (tmp_path / "w").exists()


@pytest.mark.parametrize("argv", [
    ["cost-analysis"], ["train", "--profile", "trace"],
    ["train", "--trace-steps"],
    ["train-evaluate-predict-cv", "--set", "parallel.fold_parallel=true"]])
def test_cli_tooling_defaults_to_cuda_and_raises(no_cuda, tmp_path, argv):
    """``cost-analysis``, ``--profile``, ``--trace-steps`` and the
    fold-parallel CV run on the card unless ``--device cpu`` is given,
    and write nothing where there is none."""
    from salt_tpu_torch import cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([*argv, "--synthetic", "8", "--epochs", "1",
                  "--set", f"paths.experiment_dir={tmp_path / 'e'}"])
    assert not (tmp_path / "e").exists() and not (tmp_path / "trace").exists()


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    """Inputs the CUDA kernel does not take raise before any launch; on a
    CPU tensor the wrapper is its plain version."""
    from salt_tpu_torch.ops.preprocess_kernel import \
        preprocess_inference_kernel
    x = torch.zeros(2, 101, 101, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        preprocess_inference_kernel(x)
    out = preprocess_inference_kernel(torch.zeros(0, 101, 101, dtype=torch.uint8))
    assert out.shape == (0, 128, 128, 3)
    assert np.isfinite(preprocess_inference_kernel(
        torch.full((1, 101, 101), 255, dtype=torch.uint8)).float().numpy()).all()


def test_cli_train_defaults_to_cuda_and_raises(no_cuda, tmp_path):
    from salt_tpu_torch import cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", "--synthetic", "8", "--epochs", "1",
                  "--set", f"paths.experiment_dir={tmp_path / 'e'}"])
    assert not (tmp_path / "e").exists()


def test_pipeline_train_defaults_to_cuda_and_raises(no_cuda, tmp_path):
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.pipeline import api
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.train(default_config(), Experiment(str(tmp_path / "e")),
                  synthetic_bundle(8))


def test_sort_wrapper_refuses_what_it_cannot_launch():
    from salt_tpu_torch.ops import sort_kernel
    before = sort_kernel.launches
    payload = torch.zeros(2, 32768, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        sort_kernel.sort_desc(torch.zeros(2, 32768, device="meta"), payload)
    with pytest.raises(ValueError, match="power of two"):
        sort_kernel.sort_desc(torch.zeros(1, 65536),
                              torch.zeros(1, 65536, dtype=torch.int32))
    with pytest.raises(TypeError, match="fp32"):
        sort_kernel.sort_desc(torch.zeros(2, 1024, dtype=torch.int32),
                              torch.zeros(2, 1024, dtype=torch.int32))
    assert sort_kernel.launches == before


def test_int8_wrappers_refuse_what_they_cannot_launch():
    """The int8 quantize and conv wrappers raise before any launch on a
    device that is neither the CPU nor CUDA, and on operands they do not
    take; the registry refuses widths other than 8."""
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.models.registry import build_model
    from salt_tpu_torch.ops import int8_conv as ic
    before = (ic.quantize_launches, ic.conv_launches)
    with pytest.raises(ValueError, match="device"):
        ic.quantize_rows(torch.zeros(2, 8, device="meta"))
    with pytest.raises(TypeError):
        ic.quantize_rows(torch.zeros(2, 8, dtype=torch.float16))
    xq = torch.zeros(1, 4, 8, 8, dtype=torch.int8, device="meta")
    wq = torch.zeros(4, 4, 3, 3, dtype=torch.int8, device="meta")
    s1, s4 = torch.ones(1, device="meta"), torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="device"):
        ic.int8_conv2d(xq, s1, wq, s4, 1, 1)
    with pytest.raises(ValueError, match="gather"):
        ic.conv_geometry((1, 3, 8, 8), (4, 3, 19, 19), 1, 9, 1)
    assert (ic.quantize_launches, ic.conv_launches) == before
    cfg = default_config()
    cfg.model.quant_bits = 4
    with pytest.raises(ValueError, match="quant_bits"):
        build_model(cfg.model)
