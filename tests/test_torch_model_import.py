"""The port's whole-model converters (``salt_tpu_torch/models/
torch_import.py``) against the JAX package's, on the CPU, from the
seeded reference state_dicts of the JAX goldens
(tests/test_flagship_golden.py, tests/test_arch_goldens.py; the PSPNet,
depth, emptiness and stacking state_dicts those tests build inline are
rebuilt here the same way). ResNet-18 trunks, batch 2, fp32.

- Each converter's (params, batch_stats) trees equal the JAX function's
  leaf for leaf (the SE-ResNet-50, SE-ResNeXt-50 and DenseNet-121 U-Nets
  too, whose forwards the JAX suite marks slow: trees only).
- ``graft_model`` into the port's model (reference pad and
  align-corners modes) gives the logits of the JAX model grafted by the
  JAX ``graft_model`` at rtol = atol = 2e-3, the goldens' tolerance
  (tests/test_arch_goldens.py:189); the flagship in train mode too, with
  the BatchNorm statistics after the forward (the conv biases fold into
  the running means); the flagship and LKM also match the goldens'
  direct torch forward of the state_dict.
- ``graft_model`` raises ``KeyError`` for a leaf the model lacks and
  ``ValueError`` on a shape mismatch where the JAX one does, keeps the
  leaves the checkpoint lacks, and casts to the model's dtype."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_arch_goldens import (SE50_WIDTHS, _fake_lkm_sd, _rand, _t_cbr_k,
                               add_unet_top, fake_se_encoder_sd)
from test_flagship_golden import (_add_bn, _add_cbr, _conv_init, _t, _tbn,
                                  _t_resnet18_features,
                                  fake_unet_resnet18_sd,
                                  torch_unet_resnet18_logits)
from test_pretrained import fake_densenet121_sd
from torch_parity import arch_configs, flatten

from salt_tpu.models import torch_import as jti
from salt_tpu_torch.models import torch_import as ti
from salt_tpu_torch.models.convert import to_flax_flat
from salt_tpu_torch.models.registry import build_model

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)
PARITY = dict(conv_pad_mode="reference", upsample_mode="align_corners")
JAX_PARITY = dict(pad_mode="reference", upsample_mode="align_corners")
LKM_K, LKM_IC = 9, 21
PSP_FEATURES = 256
STACK_MODELS, STACK_FILTERS = 4, 8


# -- the inline state_dicts of tests/test_arch_goldens.py ---------------------

def pspnet_sd():
    """tests/test_arch_goldens.py:324-342."""
    f = PSP_FEATURES
    base = fake_unet_resnet18_sd(11)
    sd = {k: v for k, v in base.items() if k.startswith("encoders.")}
    rng = np.random.RandomState(12)
    for i in range(4):
        sd[f"psp.stages.{i}.1.weight"] = _conv_init(rng, 512, 512, 1)
    sd["psp.bottleneck.weight"] = _conv_init(rng, f, 512 * 5, 1)
    sd["psp.bottleneck.bias"] = _rand(rng, f)
    c = f
    for up in ("up4", "up3", "up2", "up1"):
        sd[f"{up}.conv.0.weight"] = _conv_init(rng, c // 2, c, 3)
        sd[f"{up}.conv.0.bias"] = _rand(rng, c // 2)
        _add_bn(sd, rng, f"{up}.conv.1", c // 2)
        sd[f"{up}.conv.2.weight"] = np.full((1,), 0.2, np.float32)
        c //= 2
    _add_cbr(sd, rng, "final.0", f // 16 * 15, 64)
    sd["final.1.weight"] = _conv_init(rng, 2, 64, 1)
    sd["final.1.bias"] = _rand(rng, 2)
    return sd


def depth_sd():
    """tests/test_arch_goldens.py:388-393."""
    sd = fake_unet_resnet18_sd(14)
    rng = np.random.RandomState(15)
    c = 5 * 512 // 8
    sd["depth_channel_excitation.fc.0.weight"] = (
        rng.randn(c, 1).astype(np.float32))
    sd["depth_channel_excitation.fc.0.bias"] = _rand(rng, c)
    return sd


def emptiness_sd():
    """tests/test_arch_goldens.py:427-434, with torchvision's ImageNet
    ``encoder.fc`` the converters skip."""
    base = fake_unet_resnet18_sd(17)
    pre = "encoders.encoder."
    sd = {"encoder." + k[len(pre):]: v for k, v in base.items()
          if k.startswith(pre)}
    rng = np.random.RandomState(18)
    sd["classifier.1.weight"] = _conv_init(rng, 2, 512, 1)
    sd["classifier.1.bias"] = _rand(rng, 2)
    sd["encoder.fc.weight"] = _rand(rng, 1000, 512)
    sd["encoder.fc.bias"] = _rand(rng, 1000)
    return sd


def stacking_sd(with_depth):
    """tests/test_arch_goldens.py:459-467."""
    rng = np.random.RandomState(20)
    sd = {}
    _add_cbr(sd, rng, "conv.0", STACK_MODELS, STACK_FILTERS)
    if with_depth:
        sd["depth_channel_excitation.fc.0.weight"] = (
            rng.randn(STACK_FILTERS, 1).astype(np.float32))
        sd["depth_channel_excitation.fc.0.bias"] = _rand(rng, STACK_FILTERS)
    sd["final.0.weight"] = _conv_init(rng, 2, STACK_FILTERS, 1)
    sd["final.0.bias"] = _rand(rng, 2)
    return sd


def se_unet_sd(groups, base_width, seed):
    rng = np.random.RandomState(seed)
    enc = fake_se_encoder_sd(rng, groups=groups, base_width=base_width)
    sd = {f"encoders.encoder.{k}": v for k, v in enc.items()}
    add_unet_top(sd, rng, SE50_WIDTHS[:3], 2048)
    return sd


def densenet_unet_sd():
    enc = fake_densenet121_sd(seed=6)
    sd = {f"encoders.encoder.{k}": v for k, v in enc.items()}
    add_unet_top(sd, np.random.RandomState(7), (256, 512, 1024), 1024,
                 center_out=1024)
    return sd


# -- the models of each case, in both packages --------------------------------

def _jax_models():
    from salt_tpu.models.emptiness import EmptinessClassifier
    from salt_tpu.models.large_kernel_matters import LargeKernelMatters
    from salt_tpu.models.models_with_depth import UNetResNetWithDepth
    from salt_tpu.models.pspnet import PSPNet
    from salt_tpu.models.stacking import StackingFCN, StackingFCNWithDepth
    from salt_tpu.models.unet import UNetResNet
    f32 = dict(dtype=jnp.float32)
    return {
        "unet_resnet": lambda: UNetResNet(encoder_depth=18, **JAX_PARITY,
                                          **f32),
        "unet_resnet_with_depth": lambda: UNetResNetWithDepth(
            encoder_depth=18, **JAX_PARITY, **f32),
        "lkm": lambda: LargeKernelMatters(
            encoder_depth=18, kernel_size=LKM_K, internal_channels=LKM_IC,
            use_relu=True, pad_mode="reference", **f32),
        "pspnet": lambda: PSPNet(encoder_depth=18,
                                 deep_features_size=PSP_FEATURES,
                                 **JAX_PARITY, **f32),
        "emptiness": lambda: EmptinessClassifier(encoder_depth=18, **f32),
        "stacking_fcn": lambda: StackingFCN(
            input_model_nr=STACK_MODELS, filter_nr=STACK_FILTERS,
            pad_mode="reference", **f32),
        "stacking_fcn_depth": lambda: StackingFCNWithDepth(
            input_model_nr=STACK_MODELS, filter_nr=STACK_FILTERS,
            pad_mode="reference", **f32),
    }


def _port_model(case):
    from salt_tpu_torch.models.emptiness import EmptinessClassifier
    from salt_tpu_torch.models.pspnet import PSPNet
    from salt_tpu_torch.models.stacking import (StackingFCN,
                                                StackingFCNWithDepth)
    registry = {"unet_resnet": "UNetResNet",
                "unet_resnet_with_depth": "UNetResNetWithDepth",
                "lkm": "LargeKernelMatters"}
    if case in registry:
        _, pcfg = arch_configs(registry[case], 18, kernel_size=LKM_K,
                               **PARITY)
        return build_model(pcfg.model)
    if case == "pspnet":
        return PSPNet(encoder_depth=18, deep_features_size=PSP_FEATURES,
                      pad_mode="reference", upsample_mode="align_corners")
    if case == "emptiness":
        return EmptinessClassifier(encoder_depth=18)
    cls = StackingFCNWithDepth if case.endswith("depth") else StackingFCN
    return cls(input_model_nr=STACK_MODELS, filter_nr=STACK_FILTERS,
               pad_mode="reference")


#: case -> (its state_dict, the converter's name, the input's H = W and
#: channels, takes depth)
CASES = {
    "unet_resnet": (lambda: fake_unet_resnet18_sd(), "convert_unet_resnet",
                    64, 3, False),
    "unet_resnet_with_depth": (depth_sd, "convert_unet_resnet_with_depth",
                               64, 3, True),
    "lkm": (lambda: _fake_lkm_sd(k=LKM_K, ic=LKM_IC), "convert_lkm", 64, 3,
            False),
    "pspnet": (pspnet_sd, "convert_pspnet", 64, 3, False),
    "emptiness": (emptiness_sd, "convert_emptiness", 128, 3, False),
    "stacking_fcn": (lambda: stacking_sd(False), "convert_stacking_fcn", 32,
                     STACK_MODELS, False),
    "stacking_fcn_depth": (lambda: stacking_sd(True), "convert_stacking_fcn",
                           32, STACK_MODELS, True),
}
TREE_ONLY = {
    "unet_se_resnet": lambda: se_unet_sd(1, 64, 3),
    "unet_se_resnext": lambda: se_unet_sd(32, 4, 4),
    "unet_densenet": densenet_unet_sd,
}


def _inputs(size, channels, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, size, size, channels).astype(np.float32)
    d = np.asarray([[0.25], [0.8]], np.float32)
    return x, d


def _jax_grafted(case, sd):
    """The JAX model of ``case`` and its variables after the JAX
    ``graft_model`` of the JAX converter's trees (initial variables from
    shapes: zeros, the graft replaces every leaf)."""
    _, name, size, channels, depth = CASES[case]
    model = _jax_models()[case]()
    x, d = _inputs(size, channels)
    extra = (jnp.asarray(d),) if depth else ()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), *extra, train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = jti.graft_model(
        {"params": zeros["params"],
         "batch_stats": zeros.get("batch_stats", {})},
        *getattr(jti, name)(sd))
    return model, variables


def _port_grafted(case, sd):
    name = CASES[case][1]
    model = _port_model(case)
    n = ti.graft_model(model, *getattr(ti, name)(sd))
    return model.eval(), n


def _port_logits(model, x, d, depth):
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    depth=torch.from_numpy(d) if depth else None)
    return out.permute(0, 2, 3, 1).numpy() if out.ndim == 4 else out.numpy()


def _assert_trees_equal(got, want):
    got, want = flatten(got), flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("case", list(CASES) + list(TREE_ONLY))
def test_trees_equal_jax_leaf_for_leaf(case):
    if case in CASES:
        sd, name = CASES[case][0](), CASES[case][1]
    else:
        sd, name = TREE_ONLY[case](), "convert_unet_resnet"
    got = getattr(ti, name)(sd)
    want = getattr(jti, name)(sd)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_grafted_model_matches_jax(case):
    sd_fn, _, size, channels, depth = CASES[case]
    sd = sd_fn()
    model, n = _port_grafted(case, sd)
    flat = to_flax_flat(model)
    assert n == len(flat)         # every leaf of the model came from sd
    jax_model, variables = _jax_grafted(case, sd)
    for key, value in flatten(variables).items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)
    x, d = _inputs(size, channels)
    extra = (jnp.asarray(d),) if depth else ()
    want = jax.jit(lambda v, a, *e: jax_model.apply(v, a, *e, train=False))(
        variables, jnp.asarray(x), *extra)
    got = _port_logits(model, x, d, depth)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flagship_train_mode_matches_jax():
    """In train mode BatchNorm normalizes by the batch, where the folded
    conv bias cancels: logits and the new running statistics equal the
    JAX model's after the same forward."""
    sd = fake_unet_resnet18_sd()
    model, _ = _port_grafted("unet_resnet", sd)
    jax_model, variables = _jax_grafted("unet_resnet", sd)
    x, _ = _inputs(64, 3, seed=2)
    want, mutated = jax.jit(lambda v, a: jax_model.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    model.train()
    got = _port_logits(model, x, None, False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    have = to_flax_flat(model)
    for key, value in flatten({"batch_stats":
                               mutated["batch_stats"]}).items():
        np.testing.assert_allclose(have[key], value, **TOL, err_msg=key)


def torch_lkm_logits(sd, x):
    """The reference LargeKernelMatters forward as
    tests/test_arch_goldens.py:263-291 evaluates it (eval mode)."""
    k = LKM_K

    def gcn(xin, pre):
        a = _t_cbr_k(sd, xin, pre + ".conv1.0", k, 1)
        a = _t_cbr_k(sd, a, pre + ".conv1.1", 1, k)
        b = _t_cbr_k(sd, xin, pre + ".conv2.0", 1, k)
        b = _t_cbr_k(sd, b, pre + ".conv2.1", k, 1)
        return a + b

    def br(xin, pre):
        y = _t_cbr_k(sd, xin, pre + ".conv.0", 3, 3, relu=True)
        y = _t_cbr_k(sd, y, pre + ".conv.1", 3, 3, relu=False)
        return xin + y

    def deconv(xin, pre):
        y = F.conv_transpose2d(xin, _t(sd, pre + ".deconv.weight"),
                               _t(sd, pre + ".deconv.bias"), stride=2,
                               padding=1, output_padding=1)
        return F.relu(_tbn(sd, y, pre + ".batch_norm"))

    e2, e3, e4, e5 = _t_resnet18_features(sd, x)
    g2 = br(gcn(e2, "gcn2"), "enc_br2")
    g3 = br(gcn(e3, "gcn3"), "enc_br3")
    g4 = br(gcn(e4, "gcn4"), "enc_br4")
    g5 = br(gcn(e5, "gcn5"), "enc_br5")
    d5 = deconv(g5, "deconv5")
    d4 = deconv(br(d5 + g4, "dec_br4"), "deconv4")
    d3 = deconv(br(d4 + g3, "dec_br3"), "deconv3")
    d2 = br(deconv(br(d3 + g2, "dec_br2"), "deconv2"), "dec_br1")
    return F.conv2d(d2, _t(sd, "final.weight"), _t(sd, "final.bias"))


@pytest.mark.parametrize("case", ["unet_resnet", "lkm"])
def test_grafted_model_matches_direct_torch_forward(case):
    """The reference's architecture in ``F.conv2d`` on the state_dict
    itself: the flagship's and LKM's (its transposed convs: the
    converter's flip and the block's flip both stay)."""
    sd = CASES[case][0]()
    model, _ = _port_grafted(case, sd)
    x, _ = _inputs(64, 3, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = (torch_unet_resnet18_logits(sd, xt) if case == "unet_resnet"
                else torch_lkm_logits(sd, xt))
        got = model(xt)
    torch.testing.assert_close(got, want, **TOL)


def _stacking_jax_variables(with_depth):
    case = "stacking_fcn_depth" if with_depth else "stacking_fcn"
    _, jax_variables = _jax_grafted(case, stacking_sd(with_depth))
    return {c: jax.tree.map(np.asarray, v) for c, v in jax_variables.items()}


def test_graft_model_raises_where_jax_raises():
    variables = _stacking_jax_variables(False)
    model = _port_model("stacking_fcn")
    params, stats = ti.convert_stacking_fcn(stacking_sd(False))
    extra = {**params, "not_in_model": {"kernel": np.zeros((1, 1, 4, 8),
                                                           np.float32)}}
    with pytest.raises(KeyError, match="not in model"):
        jti.graft_model(variables, extra, stats)
    with pytest.raises(KeyError, match="not in model"):
        ti.graft_model(model, extra, stats)
    # a depth gate into the head without one: a leaf the model lacks
    gated, _ = ti.convert_stacking_fcn(stacking_sd(True))
    with pytest.raises(KeyError):
        jti.graft_model(variables, gated, stats)
    with pytest.raises(KeyError):
        ti.graft_model(model, gated, stats)
    bad = stacking_sd(False)
    bad["final.0.weight"] = _conv_init(np.random.RandomState(0), 3,
                                       STACK_FILTERS, 1)
    bad["final.0.bias"] = _rand(np.random.RandomState(1), 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        jti.graft_model(variables, *jti.convert_stacking_fcn(bad))
    before = to_flax_flat(model)
    with pytest.raises(ValueError, match="shape mismatch"):
        ti.graft_model(model, *ti.convert_stacking_fcn(bad))
    after = to_flax_flat(model)
    for key, value in before.items():      # checked before any write
        np.testing.assert_array_equal(after[key], value, err_msg=key)


def test_graft_model_keeps_missing_leaves_and_casts_to_the_model_dtype():
    """A StackingFCN checkpoint into StackingFCNWithDepth: the depth gate
    keeps its values, as the JAX ``_merge`` keeps them; a bf16 model
    takes the leaves in bf16."""
    params, stats = ti.convert_stacking_fcn(stacking_sd(False))
    variables = _stacking_jax_variables(True)
    merged = flatten(jti.graft_model(variables, params, stats))
    model = _port_model("stacking_fcn_depth")
    before = to_flax_flat(model)
    assert ti.graft_model(model, params, stats) == len(flatten(
        {"params": params, "batch_stats": stats}))
    after = to_flax_flat(model)
    for key, value in after.items():
        if "/depth_gate/" in key:
            np.testing.assert_array_equal(value, before[key], err_msg=key)
        else:
            np.testing.assert_array_equal(value, merged[key], err_msg=key)
    half = _port_model("stacking_fcn").to(torch.bfloat16)
    ti.graft_model(half, params, stats)
    weight = half.conv.Conv_0.weight
    assert weight.dtype == torch.bfloat16
    want = torch.from_numpy(params["conv"]["Conv_0"]["kernel"]).permute(
        3, 2, 0, 1).to(torch.bfloat16)
    assert torch.equal(weight, want)
