"""``model.pretrained``: the port's ``init_state`` grafts a local encoder
checkpoint as the JAX package's does. Seeded state_dicts in three
layouts: torchvision resnet-34 and densenet-121
(tests/test_pretrained.py's builders) here, and pretrainedmodels
se_resnet-50 (tests/test_arch_goldens.py's) in
tests/test_torch_pretrained_se.py, each written as ``.npz`` and as
``.pth``.

- After ``init_state`` the port's encoder equals the JAX package's
  ``convert_encoder`` -> ``graft_encoder`` leaf for leaf (exact: both
  only transpose), and (UNetResNet-34) every other leaf keeps its
  initial value;
- the grafted encoder's features match the flax encoder's on the
  grafted weights (fp32, 32x32, rtol = atol = 2e-3), and the whole
  grafted UNetResNet-34 matches the flax model on its weights;
- ``init_state`` raises without a path (``ValueError``), on a shape
  mismatch (``ValueError``) and for the depth model, which has no
  ``encoder`` scope (``KeyError``), where JAX raises the same."""
import jax
import numpy as np
import pytest
import torch

from test_arch_goldens import fake_se_encoder_sd
from test_pretrained import fake_densenet121_sd, fake_resnet34_sd
from torch_parity import (arch_configs, flatten, numpy_jax_variables,
                          unflatten_like)

from salt_tpu.models.encoders import make_encoder as jax_make_encoder
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.models.torch_import import convert_encoder as jax_convert
from salt_tpu.models.torch_import import graft_encoder as jax_graft
from salt_tpu.models.torch_import import load_state_dict as jax_load
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.models.convert import to_flax_flat
from salt_tpu_torch.models.registry import build_model, init_flax_like
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

#: checkpoint layout -> (its builder, the architecture it grafts into,
#: the encoder kind and depth)
LAYOUTS = {
    "resnet34": (lambda: fake_resnet34_sd(seed=1), "UNetResNet",
                 ("resnet", 34)),
    "densenet121": (lambda: fake_densenet121_sd(seed=2), "UNetDenseNet",
                    ("densenet", 121)),
    "se_resnet50": (lambda: fake_se_encoder_sd(np.random.RandomState(3)),
                    "UNetSeResNet", ("se_resnet", 50)),
}
TOL = dict(rtol=2e-3, atol=2e-3)


def _write(sd, path):
    if path.endswith(".npz"):
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def _encoder_leaves(flat):
    return {k: v for k, v in flat.items() if k.split("/")[1] == "encoder"}


def graft_case(layout, root):
    """The port's grafted state from the .npz and the .pth of
    ``layout``, and JAX's graft of the same checkpoint into a flax
    encoder's variables."""
    build_sd, arch, (kind, depth) = LAYOUTS[layout]
    sd = build_sd()
    states = {}
    for fmt in ("npz", "pth"):
        _, pcfg = arch_configs(arch, depth, pretrained=True,
                               pretrained_weights_path=_write(
                                   sd, str(root / f"{layout}.{fmt}")))
        states[fmt] = SegmentationRunner(pcfg, "cpu").init_state(0)
    jax_enc = jax_make_encoder(kind, depth)
    enc_vars, _ = numpy_jax_variables(jax_enc, seed=0)
    params, stats = jax_convert(jax_load(str(root / f"{layout}.npz")))
    got = jax_graft({"params": {"encoder": enc_vars["params"]},
                     "batch_stats": {"encoder": enc_vars["batch_stats"]}},
                    params, stats)
    return dict(layout=layout, arch=arch, kind=kind, depth=depth,
                states=states, jax_enc=jax_enc, jax_flat=flatten(got),
                jax_vars=got)


@pytest.fixture(scope="module", params=["resnet34", "densenet121"])
def grafted(request, tmp_path_factory):
    return graft_case(request.param, tmp_path_factory.mktemp(request.param))


def check_encoder_equals_jax_graft(case, fmt):
    model = case["states"][fmt].model
    full = to_flax_flat(model)
    got = _encoder_leaves(full)
    want = case["jax_flat"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case["layout"] != "resnet34":
        return
    # the rest of the model keeps its initial draw
    _, pcfg = arch_configs(case["arch"], case["depth"])
    fresh = to_flax_flat(init_flax_like(build_model(pcfg.model), 0))
    rest = [k for k in fresh if k.split("/")[1] != "encoder"]
    assert rest
    for k in rest:
        np.testing.assert_array_equal(full[k], fresh[k], err_msg=k)


def check_grafted_forward(case):
    enc = case["states"]["npz"].model.encoder.eval()
    x = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    variables = {c: case["jax_vars"][c]["encoder"]
                 for c in ("params", "batch_stats")}
    want = jax.jit(lambda v, x: case["jax_enc"].apply(v, x, train=False))(
        variables, x)
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **TOL)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_encoder_equals_jax_graft(grafted, fmt):
    check_encoder_equals_jax_graft(grafted, fmt)


def test_grafted_forward_matches_jax(grafted):
    check_grafted_forward(grafted)
    if grafted["layout"] != "resnet34":
        return
    # the whole grafted UNetResNet-34, in both packages, on its weights
    model = grafted["states"]["pth"].model.eval()
    cfg, _ = arch_configs("UNetResNet", 34)
    jax_model = jax_build_model(cfg.model, "float32")
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32),
        train=False))
    jvars = unflatten_like(to_flax_flat(model), shapes)
    x = np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(jvars, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_init_state_raises_where_jax_raises(tmp_path):
    cfg, pcfg = arch_configs("UNetResNet", 18, pretrained=True)
    with pytest.raises(ValueError, match="pretrained_weights_path"):
        JaxRunner(cfg)._graft_pretrained(None)
    with pytest.raises(ValueError, match="pretrained_weights_path"):
        SegmentationRunner(pcfg, "cpu").init_state(0)

    sd = fake_resnet34_sd(seed=1)
    sd["conv1.weight"] = np.zeros((64, 3, 5, 5), np.float32)   # wrong k
    path = _write(sd, str(tmp_path / "bad.npz"))
    enc_vars, _ = numpy_jax_variables(jax_make_encoder("resnet", 34))
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_graft({"params": {"encoder": enc_vars["params"]},
                   "batch_stats": {"encoder": enc_vars["batch_stats"]}},
                  *jax_convert(jax_load(path)))
    _, pcfg = arch_configs("UNetResNet", 34, pretrained=True,
                           pretrained_weights_path=path)
    with pytest.raises(ValueError, match="shape mismatch"):
        SegmentationRunner(pcfg, "cpu").init_state(0)

    good = _write(fake_resnet34_sd(seed=1), str(tmp_path / "good.npz"))
    cfg, pcfg = arch_configs("UNetResNetWithDepth", 34, pretrained=True,
                             pretrained_weights_path=good)
    depth_vars, _ = numpy_jax_variables(jax_build_model(cfg.model, "float32"),
                                        depth=True)
    with pytest.raises(KeyError, match="no 'encoder' scope"):
        jax_graft(depth_vars, *jax_convert(jax_load(good)))
    with pytest.raises(KeyError, match="no 'encoder' scope"):
        SegmentationRunner(pcfg, "cpu").init_state(0)
