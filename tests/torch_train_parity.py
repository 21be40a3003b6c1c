"""Shared helpers of the port's training parity tests: the augmentation
draws the JAX package makes from a key, re-derived here with the same
``jax.random`` split tree and calls as ``salt_tpu/ops/augment.py``
(:132-184 geometry, :211-216 filters, :228-241 intensity), and handed to
the port's ``apply_augment`` as an ``AugmentParams``. Nothing in
``salt_tpu`` changes for it."""
import jax
import numpy as np
import torch

from salt_tpu_torch.ops.augment import AugmentParams

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def jax_augment_params(key, b, h, w):
    """The port's parameters for the draws ``augment_batch(key, ...)``
    makes on a [b, h, w] batch."""
    kg, kf, ki = jax.random.split(key, 3)
    kfl, ka1, ka2, ka3, kp1, kp2, ke1, ke2 = jax.random.split(kg, 8)
    ks, ke = jax.random.split(kf)
    k_inv, k_cn, k_cna, k_pick, k_add, k_mul, k_noise = jax.random.split(ki, 7)
    r = jax.random
    draws = dict(
        do_flip=r.bernoulli(kfl, 0.375, (b, 1, 1)),
        do_aff=r.bernoulli(ka1, 0.375, (b, 1, 1)),
        theta=r.uniform(ka2, (b, 1, 1), minval=-10.0, maxval=10.0),
        tx=r.uniform(ka3, (b, 1, 1), minval=-0.05, maxval=0.05),
        do_persp=r.bernoulli(kp1, 0.3, (b, 1, 1)),
        scale=r.uniform(kp2, (b, 1, 1), minval=0.05, maxval=0.10),
        jitter=r.normal(r.fold_in(kp2, 1), (b, 4, 2)),
        do_pw=r.bernoulli(ke1, 0.3, (b, 1, 1)),
        e_scale=r.uniform(r.fold_in(ke1, 1), (b, 1, 1, 1), minval=0.04,
                          maxval=0.08),
        coarse=r.normal(ke2, (b, 2, 5, 5)),
        gate_s=r.bernoulli(ks, 0.375, (b, 1, 1)),
        gate_e=r.bernoulli(ke, 0.375, (b, 1, 1)),
        inv_gate=r.bernoulli(k_inv, 0.3, (b, 1, 1)),
        alpha=r.uniform(k_cna, (b, 1, 1), minval=0.5, maxval=1.5),
        cn_gate=r.bernoulli(k_cn, 0.3, (b, 1, 1)),
        branch=r.randint(k_pick, (b, 1, 1), 0, 8),
        add_v=r.uniform(k_add, (b, 1, 1), minval=-10 / 255, maxval=10 / 255),
        mul_v=r.uniform(k_mul, (b, 1, 1), minval=0.95, maxval=1.05),
        noise=r.uniform(k_noise, (b, h, w), minval=-1.0, maxval=1.0),
    )
    out = {}
    for name, value in draws.items():
        v = np.array(value)
        if name not in ("jitter", "coarse", "noise"):
            v = v.reshape(b)
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    out["branch"] = out["branch"].to(torch.int64)
    return AugmentParams(**out)


def flatten_prefixed(tree, prefix):
    """A JAX pytree as float64 numpy arrays under flat ``prefix/...``
    keys."""
    from salt_tpu.core.experiment import _path_str
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + "/" + "/".join(_path_str(p) for p in path):
            np.asarray(leaf, np.float64) for path, leaf in flat}


def flat_like(model, tensors):
    """Per-parameter tensors (grads, moments) of ``model`` under its flat
    flax ``params/...`` keys."""
    import copy

    from salt_tpu_torch.models.convert import to_flax_flat
    clone = copy.deepcopy(model).float()
    with torch.no_grad():
        for pc, t in zip(clone.parameters(), tensors):
            pc.copy_(t)
    return {k: v for k, v in to_flax_flat(clone).items()
            if k.startswith("params/")}


def jax_float64_step(model64, tx, params, stats, x, loss):
    """JAX's gradients and one ``tx.update`` of ``model64`` (a flax model
    built with dtype float64) at ``params`` / ``stats`` on the input
    ``x``; ``loss(out)`` is the loss of its train-mode output. Returns
    (grads, new params, old params) as flat float64 dicts."""
    with jax.enable_x64(True):
        import jax.numpy as jnp
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats)

        def f(p):
            out, _ = model64.apply({"params": p, "batch_stats": s64},
                                   jnp.asarray(x, jnp.float64), train=True,
                                   mutable=["batch_stats"])
            return loss(out)

        grads = jax.jit(jax.grad(f))(p64)
        updates, _ = tx.update(grads, tx.init(p64), p64)
        new = jax.tree.map(lambda p, u: p + u, p64, updates)
        return (flatten_prefixed(grads, "params"),
                flatten_prefixed(new, "params"),
                flatten_prefixed(p64, "params"))


def port_float64_step(runner, flat, x, y, lr):
    """The port's ``runner.update`` with its model (weights ``flat``) in
    float64 on ``x``; returns (grads, new params) as flat dicts."""
    from salt_tpu_torch.models.convert import load_flax_flat
    from salt_tpu_torch.models.registry import build_model
    from salt_tpu_torch.train.state import TrainState, make_optimizer
    m64 = build_model(runner.config.model)
    load_flax_flat(m64, flat)
    m64 = m64.double()
    m64.compute_dtype = torch.float64
    state = TrainState(m64, make_optimizer(
        m64, lr, runner.config.training.l2_reg_conv))
    runner.update(state, x.double(), y)
    return (flat_like(m64, [p.grad for p in m64.parameters()]),
            flat_like(m64, list(m64.parameters())))


def assert_step_matches(jgrads, jparams, old, pgrads, pparams, lr, l2,
                        max_free=0.01):
    """tests/test_torch_train_step.py's rules in float64: gradients to
    1e-4 of each leaf's max; Adam's first step ~ -lr sign(g + l2 p), so
    where |g + l2 p| is within 10x the gradients' tolerance of 0 the
    step is held to |delta| <= 2 lr, elsewhere to 1e-3 lr (under
    ``max_free`` of the elements free)."""
    assert set(jgrads) == set(pgrads)
    n_free = 0
    for k, g in jgrads.items():
        tol = 1e-4 * float(np.abs(g).max()) + 1e-12
        np.testing.assert_allclose(pgrads[k], g, rtol=1e-4, atol=tol,
                                   err_msg=k)
        free = np.abs(g + l2 * old[k]) <= 10 * tol
        n_free += int(free.sum())
        d_got = pparams[k] - old[k]
        d_want = jparams[k] - old[k]
        assert np.all(np.abs(d_got[free]) <= 2 * lr * (1 + 1e-3)), k
        np.testing.assert_allclose(d_got[~free], d_want[~free], rtol=0,
                                   atol=1e-3 * lr, err_msg=k)
    total = sum(v.size for v in jparams.values())
    assert n_free < max_free * total, (n_free, total)


def fold_config():
    """The fold-parallel tests' port config: SaltUNet (8 filters, 2
    levels), fp32, batch 8, 2 folds."""
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.batch_size_train = 8
    cfg.training.batch_size_inference = 8
    cfg.execution.n_cv_splits = 2
    return cfg


def fold_splits(bundle, n=2):
    """Per-fold (images, masks, None) train and validation tuples of the
    depth-stratified ``n``-fold split."""
    from salt_tpu_torch.data.kfold import KFoldBySortedValue
    cv = KFoldBySortedValue(n_splits=n)
    fold_train, fold_valid = [], []
    for tr, va in cv.split(bundle.meta["z"].values):
        t, v = bundle.take(tr), bundle.take(va)
        fold_train.append((t.images, t.masks, None))
        fold_valid.append((v.images, v.masks, None))
    return fold_train, fold_valid

