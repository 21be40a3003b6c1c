"""The port's probe harnesses (``salt_tpu_torch.tools``) on the CPU at a
tiny size, the kernel A/B harnesses' source variants (text edits, or
``-D`` switches for the preprocess kernel), and the conv
dispatch's A/B scope (``ops.conv_pair.make_conv_fn(scope)``) against the
JAX dispatch's ``SALT_TPU_PALLAS_CONV_SCOPE``."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import flagship_config, port_config

from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops import pallas_conv as jax_pallas_conv
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.ops import build, conv_kernel
from salt_tpu_torch.ops.conv_pair import SCOPE_ENV, make_conv_fn
from salt_tpu_torch.tools import (ab_conv, conv_probe, conv_probe2,
                                  conv_valid_ab, matmul_ab, preprocess_ab)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def test_conv_probe_on_the_cpu(capsys):
    conv_probe.main(["--device", "cpu", "--batch", "1", "--size", "32",
                     "--iters", "1", "--windows", "1"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    for line in ("correctness conv64p vs plain conv", "correctness conv128 "
                 "vs plain conv"):
        err = float(out.split(line + ": rel-err ")[1].split()[0])
        assert err < 2e-2
    for name in ("cuDNN conv c64->64 (carried)", "conv64p th16 (useful)",
                 "conv64p th32 (useful)", "cuDNN conv c128->128 (carried)",
                 "conv128 th16", "conv128 th32",
                 "matmul conv64p GEMM 512x768x128", "matmul c64 GEMM "
                 "1024x576x64", "torch.matmul c64 GEMM"):
        assert name in out and "TF/s" in out.split(name)[1].splitlines()[0]
    assert "JAX probe: PALLAS conv64p th16 (useful)" in out


def test_conv_probe2_on_the_cpu(capsys):
    conv_probe2.main(["--device", "cpu", "--batch", "1", "--size", "64",
                      "--iters", "1", "--windows", "1"])
    out = capsys.readouterr().out
    for name, _, _, int8, jax_names in conv_probe2.VARIANTS:
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(name + ": rel-err"))
        assert line.split("[")[1].startswith("OK"), line
        assert all(j in line for j in jax_names)
    assert "INT8" in out and "WRONG" not in out


@pytest.fixture
def routed(monkeypatch):
    """The calls the dispatch sends to the conv kernel's wrapper, as
    (NHWC input shape, halo)."""
    seen = []
    real = conv_kernel.conv3x3_pair_kernel

    def spy(x, w, halo=False):
        b, c, hx, wx = x.shape
        seen.append(((b, hx, wx, c), halo))
        return real(x, w, halo)

    monkeypatch.setattr(conv_kernel, "conv3x3_pair_kernel", spy)
    return seen


def test_ab_conv_on_the_cpu(capsys, routed):
    """UNetResNet18, batch 2: "on" routes the 12 eligible convs of an infer
    forward, "on+res64" the 7 at 64x64 (4 encoder, 3 decoder), "on+res128"
    the 5 head branches at 128x128, "off" none; the probabilities stay
    within 2e-2 of "off" (a few convs rounded to bf16 in another order)."""
    results = ab_conv.main(["--device", "cpu", "--batches", "2", "--iters",
                            "1", "--windows", "1", "--encoder-depth", "18"])
    out = capsys.readouterr().out
    # two steps of each variant: the compared one and the timed one
    assert len(routed) == 2 * (12 + 7 + 5)
    for name in ab_conv.VARIANTS:
        assert f"bs2 {name:<10} max|dprob| vs off:" in out
        assert f"bs2    {name:<10}" in out and "img/s" in out
        assert results[2][name]["dprob"] < 2e-2
        assert results[2][name]["launches"] == 0        # no card here
    by_res = [len([r for r in routed if r[0][1] == res]) for res in (64, 128)]
    assert by_res == [2 * (7 + 7), 2 * (5 + 5)]


def _jax_routes(cfg):
    seen = []

    def spy(x, w, *, halo=False, interpret=False):
        seen.append((tuple(x.shape), halo))
        b, hx, wx, _ = x.shape
        return jnp.zeros((b, hx - 2 * halo, wx - 2 * halo, 64), x.dtype)

    jax_model = jax_build_model(cfg.model, "bfloat16")
    variables = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    real = jax_pallas_conv.conv3x3_pair
    jax_pallas_conv.conv3x3_pair = spy
    try:
        jax.eval_shape(lambda v, xx: jax_model.apply(v, xx, train=False),
                       variables,
                       jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.float32))
    finally:
        jax_pallas_conv.conv3x3_pair = real
    return seen


@pytest.mark.parametrize("pad_mode", ["same", "reference"])
@pytest.mark.parametrize("scope", ["all", "res64", "res128"])
def test_scope_routes_the_jax_dispatchs_convs(scope, pad_mode, routed,
                                              monkeypatch):
    """bf16, model.pallas_conv="on", depth 18: with the scope in the
    environment the JAX dispatch (traced at that time) and the port's
    ``make_conv_fn(scope)`` send the same convs in the same order."""
    upsample = "align_corners" if pad_mode == "reference" else "half_pixel"
    cfg = flagship_config(18, pad_mode, upsample, "bfloat16")
    cfg.model.pallas_conv = "on"
    monkeypatch.setenv(SCOPE_ENV, scope)
    want = _jax_routes(cfg)
    assert len(want) == {"all": 12, "res64": 7, "res128": 5}[scope]
    model = build_model(port_config(cfg).model)
    model.set_compute_dtype(torch.bfloat16)
    model = model.to(memory_format=torch.channels_last)
    model.infer_conv = make_conv_fn(scope)
    with torch.no_grad():
        model(torch.zeros(1, 3, 128, 128), infer=True)
    assert routed == want


def test_default_scope_leaves_routing_unchanged(routed, monkeypatch):
    """Unset, the scope is "all"; None reads the variable once, when the
    callable is built; an unknown scope raises."""
    monkeypatch.delenv(SCOPE_ENV, raising=False)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 32, 32)
                         .astype(np.float32)).bfloat16()
    w = torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16)
    xs = torch.zeros(1, 64, 128, 128, dtype=torch.bfloat16)
    default = make_conv_fn()
    monkeypatch.setenv(SCOPE_ENV, "res128")
    for conv in (default, make_conv_fn("all")):
        conv(x, w, None, 1, 1)
        conv(xs, w, None, 1, 1)
    assert [r[0][1] for r in routed] == [32, 128, 32, 128]
    routed.clear()
    env = make_conv_fn()
    env(x, w, None, 1, 1)
    env(xs, w, None, 1, 1)
    assert [r[0][1] for r in routed] == [128]
    with pytest.raises(ValueError, match="scope"):
        make_conv_fn("res32")


@pytest.mark.parametrize("tool", [conv_probe, conv_probe2, ab_conv])
def test_tools_default_to_cuda_and_raise(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--iters", "1"])



_AB = ((conv_valid_ab, "conv_valid.cu"), (matmul_ab, "matmul_wgmma.cu"))


@pytest.mark.parametrize("tool,source,variant", [
    (tool, source, v) for tool, source in _AB for v in tool.VARIANTS],
    ids=lambda p: getattr(p, "__name__", p).split(".")[-1])
def test_ab_variants_apply_to_the_checked_in_source(tool, source, variant,
                                                    monkeypatch):
    """Every A/B variant's text edits apply, each exactly once, to the
    kernel source in the checkout and change it (``kernel`` is the source
    as it is); the harness exits without a card."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        original = f.read()
    assert (tool.variant_source(variant) == original) == (variant == "kernel")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        tool.main(["--variants", variant])


@pytest.mark.parametrize("variant", list(preprocess_ab.VARIANTS))
def test_preprocess_ab_switches_are_declared_by_the_source(variant,
                                                           monkeypatch):
    """Every preprocess A/B variant's ``-D`` switches are ones that
    ``csrc/preprocess.cu`` declares with a default (``kernel`` sets none);
    the harness exits without a card."""
    with open(os.path.join(build.CSRC_DIR, "preprocess.cu")) as f:
        src = f.read()
    switches = preprocess_ab.VARIANTS[variant][0]
    flags = preprocess_ab.variant_flags(variant)
    assert flags == [f"-D{k}={v}" for k, v in switches.items()]
    assert bool(flags) == (variant != "kernel")
    for macro in switches:
        assert f"#ifndef {macro}\n#define {macro} " in src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        preprocess_ab.main(["--variants", variant])


def test_preprocess_ab_refuses_an_undeclared_switch(monkeypatch):
    monkeypatch.setitem(preprocess_ab.VARIANTS, "gone",
                        ({"SALT_PRE_GONE": 1}, True))
    with pytest.raises(RuntimeError, match="SALT_PRE_GONE"):
        preprocess_ab.variant_flags("gone")
