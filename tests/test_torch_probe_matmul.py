"""The port's matmul probe kernel (``ops.matmul_kernel``; its plain version
``ops.probe_conv.matmul_plain``) against ``tools/pallas_conv.py::
make_matmul_kernel``, run on the CPU in Pallas interpret mode. fp32 within
2e-4 (tests/test_pallas_conv.py:28); bf16 within one bf16 ulp plus
2 K 2^-24 sum|a||b| (``torch_parity.bf16_ulp_rule``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from torch_parity import bf16_ulp_rule, load_tool

from salt_tpu_torch.ops import matmul_kernel
from salt_tpu_torch.ops.probe_conv import matmul_plain

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

pallas_conv = load_tool("pallas_conv")


def _jax_mm(M, K, N, tile_m, a, b):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_conv.make_matmul_kernel(M, K, N, tile_m)(
            jnp.asarray(a), jnp.asarray(b)), np.float32)


def _operands(M, K, N, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            (rng.randn(K, N) / np.sqrt(K)).astype(np.float32))


@pytest.mark.parametrize("M,K,N,tile_m", [(256, 128, 64, 128),
                                          (384, 192, 128, 128),
                                          (64, 768, 128, 64)])
def test_matmul_matches_jax_fp32(M, K, N, tile_m):
    a, b = _operands(M, K, N, seed=M + K)
    want = _jax_mm(M, K, N, tile_m, a, b)
    got = matmul_kernel.make_matmul_kernel(M, K, N, tile_m)(
        torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("M,K,N,tile_m", [(256, 576, 64, 128),
                                          (128, 768, 128, 128)])
def test_matmul_matches_jax_bf16(M, K, N, tile_m):
    a, b = _operands(M, K, N, seed=K)
    ab, bb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    want = _jax_mm(M, K, N, tile_m, jnp.asarray(ab.float().numpy(),
                                                jnp.bfloat16),
                   jnp.asarray(bb.float().numpy(), jnp.bfloat16))
    got = matmul_kernel.make_matmul_kernel(M, K, N, tile_m)(ab, bb)
    assert got.dtype == torch.bfloat16
    terms = matmul_plain(ab.float().abs(), bb.float().abs()).numpy()
    assert bf16_ulp_rule(got.float().numpy(), want, terms, K) <= 1.0


def test_matmul_refuses_what_it_cannot_compute():
    """M % tile_m would leave the Pallas probe's tail rows undefined: the
    port raises; CPU calls launch nothing."""
    before = matmul_kernel.launches
    with pytest.raises(ValueError, match="tile_m"):
        matmul_kernel.make_matmul_kernel(3000, 64, 64)
    with pytest.raises(ValueError, match="tile_m"):
        matmul_kernel.make_matmul_kernel(256, 64, 64, tile_m=96)
    mm = matmul_kernel.make_matmul_kernel(256, 64, 64, tile_m=128)
    a, b = (torch.from_numpy(t) for t in _operands(256, 64, 64, seed=0))
    with pytest.raises(ValueError, match="expected"):
        mm(a[:128], b)
    with pytest.raises(TypeError):
        mm(a.double(), b.double())
    with pytest.raises(ValueError, match="device"):
        mm(a.to("meta"), b.to("meta"))
    assert torch.equal(mm(a, b), matmul_plain(a, b))
    assert matmul_kernel.launches == before
