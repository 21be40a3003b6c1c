"""The scratch U-Nets of the port (``models/salt_unet.py``) against the
flax models of the JAX package: SaltUNet and SaltLinkNet logits from one
numpy-seeded checkpoint carried through ``models/convert.py``, fp32 on
the CPU, eval and train mode (dropout 0), at rtol=atol=2e-3 (the
whole-model tolerance of tests/test_flagship_golden.py); the BatchNorm
statistics a train-mode forward moves, at the same tolerance; even and
odd conv kernels and no BatchNorm; and the nets through the port's
commands. Small nets (4 filters, 2 levels) at 64x64, batch 2."""
import numpy as np
import pytest
import torch

from torch_parity import numpy_jax_variables, port_config

from salt_tpu.core.config import default_config as jax_default_config
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model

TOL = dict(rtol=2e-3, atol=2e-3)


def scratch_config(arch, n_filters=4, repeat_blocks=2, conv_kernel=3):
    cfg = jax_default_config()
    cfg.model.architecture = arch
    cfg.model.n_filters = n_filters
    cfg.model.repeat_blocks = repeat_blocks
    cfg.model.conv_kernel = conv_kernel
    cfg.training.dtype = "float32"
    return cfg


def _inputs(seed, size=64):
    return np.random.RandomState(seed).randn(2, size, size, 3).astype(
        np.float32)


def _compare(jax_model, model, flat, variables, x, train):
    """Logits (and, in train mode, the moved BatchNorm statistics) of the
    flax model and the port's on NHWC ``x``."""
    import jax
    load_flax_flat(model, flat)
    if train:
        want, moved = jax_model.apply(variables, x, train=True,
                                      mutable=["batch_stats"])
        model.train()
    else:
        want = jax_model.apply(variables, x, train=False)
        model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)
    if train:
        from torch_parity import flatten
        want_stats = (flatten({"batch_stats": jax.device_get(
            moved["batch_stats"])}) if "batch_stats" in moved else {})
        got_stats = {k: v for k, v in to_flax_flat(model).items()
                     if k.startswith("batch_stats/")}
        assert set(got_stats) == set(want_stats)
        for k, v in want_stats.items():
            np.testing.assert_allclose(got_stats[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", ["SaltUNet", "SaltLinkNet"])
def test_logits_match_flax_through_the_bridge(arch, train):
    cfg = scratch_config(arch)
    jax_model = jax_build_model(cfg.model, "float32")
    variables, flat = numpy_jax_variables(jax_model, seed=3)
    model = build_model(port_config(cfg).model)
    # the bridge maps every flax key, and back
    assert set(to_flax_flat(model)) == set(flat)
    _compare(jax_model, model, flat, variables, _inputs(4), train)


@pytest.mark.parametrize("conv_kernel", [5, 4], ids=["k5", "k4_even"])
def test_salt_unet_conv_kernel_pads_as_flax_same(conv_kernel):
    """An even kernel pads one more row and column after than before,
    as flax's SAME does."""
    cfg = scratch_config("SaltUNet", conv_kernel=conv_kernel)
    jax_model = jax_build_model(cfg.model, "float32")
    variables, flat = numpy_jax_variables(jax_model, seed=5)
    model = build_model(port_config(cfg).model)
    _compare(jax_model, model, flat, variables, _inputs(6), train=False)


@pytest.mark.parametrize("arch", ["SaltUNet", "SaltLinkNet"])
def test_without_batch_norm_convs_carry_a_bias(arch):
    """``use_batch_norm=False`` (the modules' knob; the registries do not
    set it): no BatchNorm in the nets' own ConvBnRelu, a bias on their
    convs instead, as flax's ConvBnRelu (the decoder blocks keep theirs)."""
    from salt_tpu.models import salt_unet as jax_nets
    from salt_tpu_torch.models import salt_unet as nets
    jax_model = getattr(jax_nets, arch)(n_filters=4, repeat_blocks=2,
                                        use_batch_norm=False)
    model = getattr(nets, arch)(n_filters=4, repeat_blocks=2,
                                use_batch_norm=False)
    variables, flat = numpy_jax_variables(jax_model, seed=7)
    assert "params/ConvBnRelu_0/Conv_0/bias" in flat
    assert "params/ConvBnRelu_0/BatchNorm_0/scale" not in flat
    _compare(jax_model, model, flat, variables, _inputs(8), train=True)


def test_widths_cap_at_eight_times_n_filters():
    from salt_tpu_torch.models.salt_unet import SaltUNet, level_widths
    assert level_widths(4, 5) == [4, 8, 16, 32, 32, 32]
    model = SaltUNet(n_filters=4, repeat_blocks=5)
    assert model.ConvBnRelu_11.Conv_0.weight.shape[0] == 32
    assert model.Conv_0.weight.shape == (2, 4, 1, 1)


def test_infer_form_is_the_train_form_and_bf16_keeps_an_fp32_head():
    cfg = scratch_config("SaltUNet")
    model = build_model(port_config(cfg).model)
    torch.manual_seed(0)
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        assert torch.equal(model(x), model(x, infer=True))
        model.set_compute_dtype(torch.bfloat16)
        assert model.Conv_0.weight.dtype == torch.float32
        assert model.ConvBnRelu_0.Conv_0.weight.dtype == torch.bfloat16
        assert model(x).dtype == torch.float32
    model.set_training_precision(torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.autocast_dtype == torch.bfloat16


def test_bottom_dropout_draws_whole_channels_from_the_generator():
    from salt_tpu_torch.models.salt_unet import SaltUNet
    model = SaltUNet(n_filters=4, repeat_blocks=2, dropout_2d=0.5)
    x = torch.ones(2, 16, 8, 8)
    model.train()
    a = model._channel_dropout(x, torch.Generator().manual_seed(1))
    b = model._channel_dropout(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    per_channel = a.flatten(2)
    assert ((per_channel == 0).all(-1) | (per_channel == 2).all(-1)).all()
    assert (per_channel == 0).any() and (per_channel == 2).any()
    model.eval()
    assert torch.equal(model._channel_dropout(x, None), x)


@pytest.mark.parametrize("arch", ["SaltUNet", "SaltLinkNet"])
def test_commands_train_resume_evaluate_predict_serve(arch, tmp_path,
                                                      capsys):
    """Each scratch net through the port's CLI on the CPU: train 1 epoch,
    resume for a second, evaluate, predict, and serve the experiment."""
    from salt_tpu_torch import cli
    exp = str(tmp_path / "exp")
    flags = ["--synthetic", "16", "--device", "cpu",
             "--set", f"paths.experiment_dir={exp}",
             "--set", f"model.architecture={arch}",
             "--set", "model.n_filters=4", "--set", "model.repeat_blocks=2",
             "--set", "training.dtype=float32",
             "--set", "training.batch_size_train=4",
             "--set", "training.batch_size_inference=4",
             "--set", "execution.n_cv_splits=4"]
    assert cli.main(["train", *flags, "--epochs", "1"]) == 0
    assert cli.main(["train", *flags, "--epochs", "2", "--resume"]) == 0
    import json
    with open(f"{exp}/checkpoints/network/last.json") as f:
        assert json.load(f)["epoch"] == 1
    assert cli.main(["evaluate", *flags]) == 0
    assert "'iout'" in capsys.readouterr().out
    assert cli.main(["predict", *flags]) == 0
    assert (tmp_path / "exp" / "submission.csv").exists()
    out = str(tmp_path / "serve.csv")
    assert cli.main(["serve", "--checkpoint", exp, "--synthetic", "8",
                     "--out", out, "--device", "cpu"]) == 0
    import pandas as pd
    assert len(pd.read_csv(out)) == 8
