"""The port's bitonic sort (the plain version of the CUDA kernel, and what
``sort_kernel.sort_desc`` runs on a CPU tensor) against the JAX package's
network ``ops.bitonic.bitonic_sort_desc`` and its Pallas kernel in
interpret mode, as tests/test_pallas_sort.py runs it: keys and payload
bit for bit, ties included (equal keys never swap, so the permutation is
the network's). Then the differentiable sort against JAX's custom VJP:
the same forward and the same gradient, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.ops.bitonic import bitonic_sort_desc as jax_bitonic
from salt_tpu.ops.pallas_sort import sort_desc_pallas, sort_desc_with_labels
from salt_tpu_torch.ops import sort_kernel
from salt_tpu_torch.ops.bitonic import bitonic_sort_desc

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _inputs(b, p, ties, seed=0):
    rng = np.random.RandomState(seed)
    keys = rng.randn(b, p).astype(np.float32)
    if ties:
        keys = np.round(keys * 4) / 4
    labels = rng.randint(0, 2, (b, p))
    payload = ((labels << 20) | np.arange(p)).astype(np.int32)
    return keys, payload


def _port(keys, payload):
    ks, ps = sort_kernel.sort_desc(torch.from_numpy(keys),
                                   torch.from_numpy(payload))
    return ks.numpy(), ps.numpy()


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("shape", [(2, 256), (3, 1024)])
def test_matches_jax_network_and_pallas_interpret(shape, ties):
    keys, payload = _inputs(*shape, ties)
    ks, ps = _port(keys, payload)
    jk, jp = jax.vmap(jax_bitonic)(jnp.asarray(keys), jnp.asarray(payload))
    pk, pp = sort_desc_pallas(jnp.asarray(keys), jnp.asarray(payload),
                              interpret=True)
    for want_k, want_p in ((jk, jp), (pk, pp)):
        np.testing.assert_array_equal(_bits(ks), _bits(np.asarray(want_k)))
        np.testing.assert_array_equal(ps, np.asarray(want_p))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_production_width_matches_jax_network(ties):
    """(2, 32768), the training shape's row length (the interpreted Pallas
    kernel is too slow at this width)."""
    keys, payload = _inputs(2, 32768, ties, seed=1)
    ks, ps = _port(keys, payload)
    jk, jp = jax.jit(jax.vmap(jax_bitonic))(jnp.asarray(keys),
                                            jnp.asarray(payload))
    np.testing.assert_array_equal(_bits(ks), _bits(np.asarray(jk)))
    np.testing.assert_array_equal(ps, np.asarray(jp))
    # a descending permutation of the input
    assert np.all(np.diff(ks, axis=1) <= 0)
    idx = ps & ((1 << 20) - 1)
    for r in range(2):
        assert np.array_equal(np.sort(idx[r]), np.arange(32768))
        np.testing.assert_array_equal(keys[r][idx[r]], ks[r])


def test_equal_keys_keep_the_network_order():
    """All keys equal: nothing swaps, the payload stays in place."""
    keys = np.zeros((1, 1024), np.float32)
    payload = np.arange(1024, dtype=np.int32)[None]
    ks, ps = _port(keys, payload)
    np.testing.assert_array_equal(ps, payload)
    bitonic_ks, _ = bitonic_sort_desc(torch.from_numpy(keys),
                                      torch.from_numpy(payload))
    np.testing.assert_array_equal(ks, bitonic_ks.numpy())


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_differentiable_sort_matches_jax_custom_vjp(ties, monkeypatch):
    """JAX's custom VJP around its Pallas kernel, which runs on the CPU in
    interpret mode (SALT_TPU_PALLAS_INTERPRET, as
    tests/test_pallas_sort.py sets it)."""
    monkeypatch.setenv("SALT_TPU_PALLAS_INTERPRET", "1")
    b, p = 3, 1024
    keys, payload = _inputs(b, p, ties, seed=2)
    labels = (payload >> 20).astype(np.float32)
    g = np.random.RandomState(3).randn(b, p).astype(np.float32)

    def jax_fn(e):
        es, ls = sort_desc_with_labels(e, jnp.asarray(labels))
        return jnp.sum(es * jnp.asarray(g)), (es, ls)

    (_, (jes, jls)), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(keys))
    e = torch.from_numpy(keys).requires_grad_(True)
    es, ls, _ = sort_kernel.SortDescWithLabels.apply(
        e, torch.from_numpy(labels))
    (es * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(es.detach().numpy(), np.asarray(jes))
    np.testing.assert_array_equal(ls.numpy(), np.asarray(jls))
    np.testing.assert_array_equal(e.grad.numpy(), np.asarray(jgrad))
    assert not ls.requires_grad


def test_sort_refuses_what_the_kernel_cannot_take():
    """The same domain on every device: fp32 keys, int32 payload, [B, P]
    with P a power of two in [128, 32768]."""
    k = torch.zeros(2, 256)
    p = torch.zeros(2, 256, dtype=torch.int32)
    with pytest.raises(TypeError):
        sort_kernel.sort_desc(k.double(), p)
    with pytest.raises(TypeError):
        sort_kernel.sort_desc(k, p.long())
    for bad in (64, 384, 65536):
        with pytest.raises(ValueError):
            sort_kernel.sort_desc(torch.zeros(1, bad),
                                  torch.zeros(1, bad, dtype=torch.int32))
    with pytest.raises(ValueError):
        sort_kernel.sort_desc(k[0], p[0])
    assert sort_kernel.kernel_length_ok(32768)
    assert not sort_kernel.kernel_length_ok(2 * 101 * 101)
