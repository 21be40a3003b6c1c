"""The infer form of the port's U-Net against the JAX package's predict
model: the sliced-concat ("sum") decoder and hypercolumn head, the
checkpoint keys both forms share, and the set of convs that
``model.pallas_conv`` routes to the conv kernel.

UNetResNet18 on 128x128 inputs, weights drawn from numpy seeds
(tests/torch_parity.py). The whole-model tolerance is
tests/test_torch_model.py's, rtol=atol=2e-3 (fp32 on the CPU; the
packages sum convolutions in different orders)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (flagship_config, numpy_jax_variables, port_config,
                          seeded_images)

from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops import pallas_conv as jax_pallas_conv
from salt_tpu.ops.preprocess import preprocess_inference as jax_preprocess
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.ops import conv_kernel

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

MODES = [("same", "half_pixel"), ("reference", "align_corners")]


def _impls(cfg, impl):
    cfg.model.hypercolumn_impl = impl
    cfg.model.decoder_impl = impl
    return cfg


@pytest.fixture(scope="module")
def inputs():
    return np.asarray(jax_preprocess(seeded_images(2, seed=1)))


@pytest.mark.parametrize("pad_mode,upsample_mode", MODES,
                         ids=["default", "reference"])
def test_infer_form_matches_jax_sum_forms(inputs, pad_mode, upsample_mode):
    cfg = flagship_config(18, pad_mode, upsample_mode)
    assert (cfg.model.hypercolumn_impl, cfg.model.decoder_impl) == ("sum",
                                                                    "sum")
    jax_model = jax_build_model(cfg.model, "float32")
    variables, flat = numpy_jax_variables(jax_model, seed=0)
    want = np.asarray(jax_model.apply(variables, inputs, train=False))
    model = load_flax_flat(build_model(port_config(cfg).model), flat)
    with torch.no_grad():
        got = model(torch.tensor(inputs).permute(0, 3, 1, 2), infer=True)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-3, atol=2e-3)


def test_one_checkpoint_serves_both_forms(inputs):
    """The sum and concat forms of both packages have one parameter tree:
    a flax checkpoint loads into the port's module, which writes the same
    keys back, and its two forms (reading the same tensors) agree in
    fp32; with the "concat" impls the infer form IS the train form."""
    cfg = flagship_config(18)
    jax_keys = []
    for impl in ("sum", "concat"):
        jm = jax_build_model(_impls(flagship_config(18), impl).model,
                             "float32")
        shapes = jax.eval_shape(lambda m=jm: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
        jax_keys.append(sorted(
            "/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]))
    assert jax_keys[0] == jax_keys[1]
    _, flat = numpy_jax_variables(jax_build_model(cfg.model, "float32"),
                                   seed=2)
    assert sorted(flat) == jax_keys[0]
    model = load_flax_flat(build_model(port_config(cfg).model), flat)
    assert sorted(to_flax_flat(model)) == sorted(flat)
    x = torch.tensor(inputs).permute(0, 3, 1, 2)
    with torch.no_grad():
        infer, train = model(x, infer=True), model(x)
    torch.testing.assert_close(infer, train, rtol=1e-4, atol=1e-4)

    concat = load_flax_flat(build_model(
        port_config(_impls(flagship_config(18), "concat")).model), flat)
    with torch.no_grad():
        assert torch.equal(concat(x, infer=True), concat(x))


def _expected_routes(pad_mode, impl):
    """The convs the dispatch takes at depth 18, 128x128, batch 1, as NHWC
    input shapes and halo flags: the 4 encoder layer1 convs (explicit
    (1, 1) padding in both modes), dec2's convs and the head's branches."""
    ref = pad_mode == "reference"
    enc = [((1, 64, 64, 64), False)] * 4
    dec = ((1, 66, 66, 64), True) if ref else ((1, 64, 64, 64), False)
    head = ((1, 130, 130, 64), True) if ref else ((1, 128, 128, 64), False)
    if impl == "sum":
        return enc + [dec] * 3 + [head] * 5
    return enc + [dec]


@pytest.mark.parametrize("pad_mode,impl", [("same", "sum"),
                                           ("same", "concat"),
                                           ("reference", "sum")])
def test_routed_convs_equal_jax(pad_mode, impl, monkeypatch):
    """bf16 with model.pallas_conv="on": the JAX package's dispatch (traced
    with jax.eval_shape around a spy on its kernel) and the port's (run
    with a spy on its kernel wrapper) send the same convs, in the same
    order: 12 at depth 18 in the sum forms, 5 in the concat forms."""
    upsample = "align_corners" if pad_mode == "reference" else "half_pixel"
    cfg = _impls(flagship_config(18, pad_mode, upsample, "bfloat16"), impl)
    cfg.model.pallas_conv = "on"
    want = _expected_routes(pad_mode, impl)
    assert len(want) == (12 if impl == "sum" else 5)

    jax_seen = []

    def jax_spy(x, w, *, halo=False, interpret=False):
        jax_seen.append((tuple(x.shape), halo))
        b, hx, wx, _ = x.shape
        return jnp.zeros((b, hx - 2 * halo, wx - 2 * halo, 64), x.dtype)

    monkeypatch.setattr(jax_pallas_conv, "conv3x3_pair", jax_spy)
    jax_model = jax_build_model(cfg.model, "bfloat16")
    x = jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.float32)
    variables = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    jax_seen.clear()                              # the init traced them too
    jax.eval_shape(lambda v, xx: jax_model.apply(v, xx, train=False),
                   variables, x)
    assert jax_seen == want

    port_seen = []

    def port_spy(x, w, halo=False):
        assert x.dtype == w.dtype == torch.bfloat16
        assert x.is_contiguous(memory_format=torch.channels_last)
        b, c, hx, wx = x.shape
        port_seen.append(((b, hx, wx, c), halo))
        return torch.zeros((b, 64, hx - 2 * halo, wx - 2 * halo),
                           dtype=x.dtype)

    monkeypatch.setattr(conv_kernel, "conv3x3_pair_kernel", port_spy)
    model = build_model(port_config(cfg).model)
    model.set_compute_dtype(torch.bfloat16)
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 128, 128), infer=True)
        assert port_seen == want
        port_seen.clear()
        model(torch.zeros(1, 3, 128, 128))         # the train form: none
    assert out.shape == (1, 2, 128, 128) and port_seen == []
