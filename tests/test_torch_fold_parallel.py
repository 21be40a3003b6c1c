"""The port's fold-parallel step (``salt_tpu_torch/parallel/
fold_parallel.py``) against the JAX package's
(``salt_tpu/parallel/fold_parallel.py``), on the CPU: SaltUNet (8
filters, 2 levels), 2 folds of 2 images, fp32.

One ``FoldParallelRunner.train_step`` on both sides from the same
stacked weights (JAX's per-fold init carried across by
``models/convert.py``), each fold's augmentation drawn from that fold's
key as JAX draws it (``torch_train_parity.jax_augment_params``), no
dropout (``dropout_2d`` 0, the default: flax's dropout bits cannot be
replayed). Each fold's loss and BatchNorm statistics are held at the
tolerances of ``tests/test_torch_train_step.py`` (1e-5). Gradients,
Adam moments and updated parameters are held in float64, as there: the
port's vmapped half of the step (``FoldParallelRunner.grads``) and
:func:`stacked_adam` on the float64 network against JAX's float64
gradient and ``tx.update`` of each fold on its own network inputs
(``torch_train_parity.assert_step_matches``).

Also: the ``vmap`` rule of the sort's autograd function equals K
separate calls, forward and backward (the plain version on the CPU), and
:func:`stacked_adam` equals ``torch.optim.Adam`` on one fold, bit for
bit, over steps with a frozen fold left untouched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import port_config, seeded_images
from torch_train_parity import (assert_step_matches, flatten_prefixed,
                                jax_augment_params, jax_float64_step)

from salt_tpu.core.config import default_config
from salt_tpu.parallel.fold_parallel import FoldParallelRunner as JaxFP
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.parallel.fold_parallel import (FoldParallelRunner,
                                                   _cat_params, stacked_adam)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K, B = 2, 2


def _config():
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.batch_size_train = B
    cfg.training.lr = 1e-3
    return cfg


def _fold_flat(states, k):
    """Fold k's params and batch_stats of a stacked JAX state, flat."""
    params = jax.tree.map(lambda x: np.asarray(x)[k], states.params)
    stats = jax.tree.map(lambda x: np.asarray(x)[k], states.batch_stats)
    return (params, stats, {**flatten_prefixed(params, "params"),
                            **flatten_prefixed(stats, "batch_stats")})


@pytest.fixture(scope="module")
def step():
    cfg = _config()
    jfp = JaxFP(cfg, K)
    states = jfp.init_states(0)
    folds = [_fold_flat(states, k) for k in range(K)]
    images = seeded_images(K * B, seed=4).reshape(K, B, 101, 101)
    masks = (images > 140).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(9), K)
    jr = jfp.runner
    # each fold's network inputs as JAX's step makes them (aug key first)
    jxy = [jr._train_inputs(jnp.asarray(images[k]), jnp.asarray(masks[k]),
                            jax.random.split(keys[k])[0]) for k in range(K)]
    di, dm, dd = jfp.shard_fold_batch(images, masks,
                                      np.zeros((K, B, 1), np.float32))
    new_states, jloss = jfp.train_step(states, di, dm, dd, keys,
                                       np.ones(K, bool))

    pcfg = port_config(cfg)
    fp = FoldParallelRunner(pcfg, K, "cpu")

    def port_models(dtype):
        models = []
        for _, _, flat in folds:
            m = build_model(pcfg.model)
            load_flax_flat(m, {k: v.astype(np.float32)
                               for k, v in flat.items()})
            if dtype == torch.float64:
                m = m.double()
                m.compute_dtype = torch.float64
            else:
                m = fp.runner.train_state(m).model
            models.append(m)
        return models

    pstates = fp.stack(port_models(torch.float32))
    params = _cat_params([jax_augment_params(jax.random.split(keys[k])[0],
                                             B, 101, 101)
                          for k in range(K)])
    ploss = fp.train_step(pstates, torch.from_numpy(images),
                          torch.from_numpy(masks), (params, []), [True] * K)

    # float64: the vmapped half on JAX's network inputs, then stacked Adam
    x = torch.stack([torch.from_numpy(np.array(jx)).permute(0, 3, 1, 2)
                     for jx, _ in jxy]).double()
    y = torch.stack([torch.from_numpy(np.array(jy)) for _, jy in jxy])
    s64 = fp.stack(port_models(torch.float64))
    old = s64.params.clone()
    _, grads, _ = fp.grads(s64, x, y)
    s64.steps += 1
    with torch.no_grad():
        stacked_adam(s64.params, grads, s64.exp_avg, s64.exp_avg_sq,
                     s64.lrs, s64.steps, [True] * K, s64.weight_decay)

    def per_fold(flat_tensor, k):
        views = s64._views(flat_tensor, s64.param_layout, k)
        m = build_model(pcfg.model).double()
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(views[name])
        return {key: v.astype(np.float64) for key, v in
                to_flax_flat(m).items() if key.startswith("params/")}

    out = dict(cfg=pcfg, jloss=np.asarray(jloss), ploss=ploss.numpy(),
               jstats=[flatten_prefixed(jax.tree.map(
                   lambda a: np.asarray(a)[k], new_states.batch_stats),
                   "batch_stats") for k in range(K)],
               pstats=[{key: v for key, v in
                        to_flax_flat(pstates.fold(k).model).items()
                        if key.startswith("batch_stats/")}
                       for k in range(K)],
               folds=[])
    from salt_tpu.models.salt_unet import SaltUNet as JaxSaltUNet
    model64 = JaxSaltUNet(num_classes=2, n_filters=8, repeat_blocks=2,
                          dtype=jnp.float64)
    for k in range(K):
        p, st, _ = folds[k]

        def loss(o, jy=jxy[k][1]):
            return jr.loss_fn(o, jnp.asarray(jy))
        jg, jp, jold = jax_float64_step(model64, jr.tx, p, st,
                                        np.asarray(jxy[k][0]), loss)
        out["folds"].append(dict(
            jgrads=jg, jparams=jp, old=jold,
            pgrads=per_fold(grads, k), pparams=per_fold(s64.params, k),
            pold=per_fold(old, k), pmu=per_fold(s64.exp_avg, k),
            pnu=per_fold(s64.exp_avg_sq, k)))
    return out


def test_each_fold_loss_matches_jax(step):
    np.testing.assert_allclose(step["ploss"], step["jloss"], rtol=0,
                               atol=1e-5)
    assert step["ploss"][0] != step["ploss"][1]


def test_each_fold_batch_stats_match_jax(step):
    for k in range(K):
        assert set(step["pstats"][k]) == set(step["jstats"][k])
        for key, want in step["jstats"][k].items():
            np.testing.assert_allclose(step["pstats"][k][key], want,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"fold {k} {key}")


def test_each_fold_gradients_and_update_match_jax_in_float64(step):
    cfg = step["cfg"]
    for f in step["folds"]:
        for key, v in f["old"].items():
            np.testing.assert_allclose(f["pold"][key], v, rtol=0, atol=1e-7)
        assert_step_matches(f["jgrads"], f["jparams"], f["old"],
                            f["pgrads"], f["pparams"], cfg.training.lr,
                            cfg.training.l2_reg_conv, max_free=0.02)


def test_each_fold_adam_moments_match_jax_in_float64(step):
    """After one step optax's moments are (1 - b1) g and (1 - b2) g^2 of
    g = the gradient + l2 p (JAX's float64 gradient); the rule of
    tests/test_torch_train_step.py's moment test."""
    l2 = step["cfg"].training.l2_reg_conv
    for f in step["folds"]:
        for key, jg in f["jgrads"].items():
            g = jg + l2 * f["old"][key]
            tol = 1e-4 * float(np.abs(jg).max()) + 1e-12
            np.testing.assert_allclose(f["pmu"][key], 0.1 * g,
                                       atol=0.1 * 2 * tol, rtol=1e-4,
                                       err_msg=key)
            np.testing.assert_allclose(
                f["pnu"][key], 1e-3 * g * g,
                atol=1e-3 * 4 * tol * float(np.abs(jg).max()), rtol=1e-3,
                err_msg=key)


@pytest.mark.parametrize("size_weighted", [False, True])
def test_sort_vmap_rule_equals_separate_calls(size_weighted):
    """vmap over the fold axis of the per-image Lovász hinge (through
    ``SortDescWithLabels``' vmap rule, one sort of [K * B, P]) equals
    each fold's own call, value and gradient, ties included."""
    from salt_tpu_torch.ops.sort_kernel import lovasz_hinge_flat_kernel
    gen = torch.Generator().manual_seed(0)
    logits = torch.round(torch.randn(3, 2, 1024, generator=gen) * 4) / 4
    labels = (torch.rand(3, 2, 1024, generator=gen) > 0.6).float()

    def f(x, lab):
        return lovasz_hinge_flat_kernel(x, lab, size_weighted).sum()

    grads, values = torch.func.vmap(torch.func.grad_and_value(f))(logits,
                                                                 labels)
    for k in range(3):
        x = logits[k].clone().requires_grad_(True)
        v = f(x, labels[k])
        v.backward()
        assert torch.equal(values[k], v.detach())
        assert torch.equal(grads[k], x.grad)


def test_sort_vmap_rule_launches_one_sort(monkeypatch):
    from salt_tpu_torch.ops import sort_kernel
    calls = []
    real = sort_kernel.sort_desc

    def counting(keys, payload):
        calls.append(tuple(keys.shape))
        return real(keys, payload)
    monkeypatch.setattr(sort_kernel, "sort_desc", counting)
    e = torch.randn(4, 3, 256)
    lab = (torch.rand(4, 3, 256) > 0.5).float()
    torch.func.vmap(lambda a, b: sort_kernel.SortDescWithLabels.apply(a, b)[0]
                    )(e, lab)
    assert calls == [(12, 256)]


def test_stacked_adam_equals_torch_adam_on_one_fold():
    """Fold 0 through ``torch.optim.Adam`` (weight decay, lr 3e-3) and
    the stacked update, three steps: bit for bit; fold 1 frozen on the
    second step keeps every value and its step count."""
    gen = torch.Generator().manual_seed(1)
    p0 = torch.randn(50, generator=gen)
    ref = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([ref], lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=1e-4, foreach=False)
    params = torch.stack([p0, torch.randn(50, generator=gen)])
    m, v = torch.zeros_like(params), torch.zeros_like(params)
    steps = np.zeros(2, np.int64)
    for i, active in enumerate(([True, True], [True, False],
                                [True, True])):
        g = torch.randn(2, 50, generator=gen)
        ref.grad = g[0].clone()
        opt.step()
        before = (params[1].clone(), m[1].clone(), v[1].clone())
        steps += np.asarray(active, np.int64)
        stacked_adam(params, g, m, v, [3e-3, 1e-3], steps, active, 1e-4)
        assert torch.equal(params[0], ref.detach()), i
        assert torch.equal(m[0], opt.state[ref]["exp_avg"]), i
        assert torch.equal(v[0], opt.state[ref]["exp_avg_sq"]), i
        if not active[1]:
            for a, b in zip(before, (params[1], m[1], v[1])):
                assert torch.equal(a, b)
    assert steps.tolist() == [3, 2]
