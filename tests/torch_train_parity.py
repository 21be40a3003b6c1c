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
