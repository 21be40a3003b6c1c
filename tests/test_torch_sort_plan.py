"""The sort kernel's plan (``ops/sort_kernel.py::sort_plan``) on the CPU:
``ops/bitonic.py::run_plan`` executes each planned launch with plain
tensor code, each launch seeing only the chunk of a row its block holds
or the elements at the chunk's stride its thread holds, with the
directions taken from the position in the row. The executor must give
the network's keys and payload bit for bit (ties, NaN, +0.0 and -0.0
included), the plan must visit every stage of the network once, in order,
in at most ``MAX_LAUNCHES`` launches, and at (2, 1024) the executor must
match the JAX package's network too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.ops.bitonic import bitonic_sort_desc as jax_bitonic
from salt_tpu.ops.pallas_sort import _stage_table
from salt_tpu_torch.ops import sort_kernel
from salt_tpu_torch.ops.bitonic import (DST_OUTPUT, OP_CHUNK, SRC_INPUT,
                                        bitonic_sort_desc, launch_stages,
                                        run_plan)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

LENGTHS = (128, 1024, 4096, 8192, 32768)
#: (P, chunk): every plan the wrapper may take (the chunks differ only
#: where P is longer than the smaller one)
PLANS = ([(p, sort_kernel.CHUNK) for p in LENGTHS]
         + [(p, sort_kernel.MAX_CHUNK) for p in LENGTHS
            if p > sort_kernel.CHUNK])
_jax_network = jax.jit(jax.vmap(jax_bitonic))


def _inputs(b, p, keys_kind, seed=0):
    """Keys "distinct", "ties" (rounded to quarters) or "nan_zeros" (ties,
    with NaNs, +0.0 and -0.0 mixed in); a Lovász-style payload."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(b, p).astype(np.float32)
    if keys_kind != "distinct":
        keys = np.round(keys * 4) / 4
    if keys_kind == "nan_zeros":
        keys[rng.rand(b, p) < 0.05] = np.nan
        keys[rng.rand(b, p) < 0.1] = 0.0
        keys[rng.rand(b, p) < 0.1] = -0.0
    payload = ((rng.randint(0, 2, (b, p)) << 20)
               | np.arange(p)).astype(np.int32)
    return keys, payload


@functools.lru_cache(maxsize=None)
def _network(b, p, keys_kind):
    keys, payload = _inputs(b, p, keys_kind, seed=b)
    k, pl = bitonic_sort_desc(torch.from_numpy(keys),
                              torch.from_numpy(payload))
    return keys, payload, k.numpy().view(np.int32), pl.numpy()


@pytest.mark.parametrize("keys_kind", ["distinct", "ties", "nan_zeros"])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("p, chunk", PLANS)
def test_plan_executor_matches_the_network(p, chunk, rows, keys_kind):
    keys, payload, want_k, want_p = _network(rows, p, keys_kind)
    got_k, got_p = run_plan(torch.from_numpy(keys), torch.from_numpy(payload),
                            sort_kernel.sort_plan(p, chunk))
    np.testing.assert_array_equal(got_k.numpy().view(np.int32), want_k)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("keys_kind", ["distinct", "ties", "nan_zeros"])
def test_plan_executor_matches_jax_network(keys_kind):
    keys, payload = _inputs(2, 1024, keys_kind, seed=7)
    got_k, got_p = run_plan(torch.from_numpy(keys), torch.from_numpy(payload),
                            sort_kernel.sort_plan(1024, sort_kernel.CHUNK))
    jk, jp = _jax_network(jnp.asarray(keys), jnp.asarray(payload))
    np.testing.assert_array_equal(got_k.numpy().view(np.int32),
                                  np.asarray(jk).view(np.int32))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("chunk", [sort_kernel.CHUNK, sort_kernel.MAX_CHUNK])
@pytest.mark.parametrize("p", LENGTHS + (256, 512, 2048, 16384))
def test_plan_visits_every_stage_once_in_order(p, chunk):
    plan = sort_kernel.sort_plan(p, chunk)
    stages = [s for launch in plan for s in launch_stages(launch)]
    assert stages == [tuple(s) for s in _stage_table(p).tolist()]
    assert 1 <= len(plan) <= sort_kernel.MAX_LAUNCHES
    assert plan[0].src == SRC_INPUT and plan[0].op == OP_CHUNK
    assert [launch.dst == DST_OUTPUT for launch in plan] == \
        [False] * (len(plan) - 1) + [True]
    n, c = p.bit_length() - 1, min(p, chunk)
    assert len(plan) == 1 + 2 * (n - (c.bit_length() - 1))
    assert sort_kernel._plan_arg(p, chunk) is sort_kernel._plan_arg(p, chunk)


@pytest.mark.parametrize("rows, p, sms, chunk", [
    (8, 32768, 132, 4096), (16, 32768, 132, 4096), (17, 32768, 132, 8192),
    (24, 32768, 132, 8192), (24, 32768, 192, 4096), (132, 4096, 132, 4096),
    (133, 4096, 132, 8192), (200, 128, 132, 8192)])
def test_chunk_for_takes_the_smaller_chunk_while_blocks_fit_the_sms(
        rows, p, sms, chunk):
    """4,096 while rows x P / 4,096 blocks fit one to an SM, else 8,192
    (at P <= 4,096 both chunks give the same one-launch plan)."""
    assert sort_kernel.chunk_for(rows, p, sms) == chunk
    if p <= sort_kernel.CHUNK:
        assert sort_kernel.sort_plan(p, chunk) == \
            sort_kernel.sort_plan(p, sort_kernel.CHUNK)


def test_executor_refuses_a_plan_that_crosses_its_blocks():
    """A chunk launch asked for a stride past its chunk, or a strided
    launch for one inside it, is refused, not run across the chunks."""
    plan = sort_kernel.sort_plan(8192, sort_kernel.CHUNK)
    keys, payload = (torch.from_numpy(a) for a in _inputs(1, 8192, "ties"))
    whole = plan[0]._replace(k_hi=13, j_hi=12)
    with pytest.raises(ValueError, match="outside a chunk"):
        run_plan(keys, payload, (whole,) + plan[1:])
    inside = plan[1]._replace(j_lo=11)
    with pytest.raises(ValueError, match="between a thread's elements"):
        run_plan(keys, payload, (plan[0], inside) + plan[2:])
    with pytest.raises(ValueError, match="no launch writes"):
        run_plan(keys, payload, plan[:-1])


def test_plan_refuses_what_the_kernel_cannot_take():
    for bad in (64, 384, 65536):
        with pytest.raises(ValueError, match="power of two"):
            sort_kernel.sort_plan(bad, sort_kernel.CHUNK)
    for bad in (64, 2048, 3072, 16384):
        with pytest.raises(ValueError, match="chunk"):
            sort_kernel.sort_plan(32768, bad)


def test_sort_probe_runs_each_chunk_plan_on_cpu(capsys):
    """``tools/sort_probe.py`` at a small size on the CPU: each chunk's
    plan through the executor, bit-identical to the network, one JSON
    line per (rows, chunk)."""
    import json
    from salt_tpu_torch.tools import sort_probe
    sort_probe.main(["--device", "cpu", "--rows", "3", "--length", "16384",
                     "--chunks", f"{sort_kernel.CHUNK},{sort_kernel.MAX_CHUNK}",
                     "--iters", "1", "--windows", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [(r["chunk"], r["launches"], r["bit_identical"]) for r in lines] \
        == [(sort_kernel.CHUNK, 5, True), (sort_kernel.MAX_CHUNK, 3, True)]
