"""Conv and matmul probe: can hand kernels match the library's convs at
the flagship's dominant conv shape? The port of ``tools/pallas_conv.py``'s
``main``.

    python -m salt_tpu_torch.tools.conv_probe [--batch 64] [--size 128] \
        [--iters 20] [--windows 3] [--device cuda|cpu]

1. Correctness: the pair-packed conv (``ops.conv64p_kernel``, tile_h 16,
   C 64 -> 64) and the im2col conv (``ops.conv128_kernel``, tile_h 16,
   C = F = 128) against the plain fp32 conv of the same bf16 operands,
   asserting a relative error (max |diff| / max |plain|) below 2e-2.
2. Rates, in TF/s of useful conv flops (2 B H W 9 C F): a cuDNN conv chain
   whose every conv reads the previous one's output ("carried", in place
   of the JAX probe's XLA chain), and the kernels at tile_h 16 and 32, each
   over weights that change every launch.
3. The matmul kernel (``ops.matmul_kernel``), which the JAX probe never
   launches: row-major [M, K] x [K, N] at the pair-packed conv's GEMM (M =
   B H W / 2, K 768, N 128) and the unpacked c64 GEMM (M = B H W, K 576,
   N 64), beside ``torch.matmul``.

Every probe runs ``--iters`` launches per timed window; the windows
interleave the probes and the best window counts (``tools.timing``).
Runs on the card and fails without CUDA unless ``--device cpu`` is given
(small ``--batch`` / ``--size`` for a quick check there).
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.ops.conv128_kernel import make_conv128_kernel
from salt_tpu_torch.ops.conv64p_kernel import make_conv64p_kernel
from salt_tpu_torch.ops.matmul_kernel import make_matmul_kernel
from salt_tpu_torch.ops.probe_conv import (WPAD, WPAD2, conv128_plain,
                                           pack_pair_weights, pack_pairs)
from salt_tpu_torch.tools.timing import best_ms, print_rate

NCHAIN = 20        # weight sets a chain cycles through


def parse_args(argv=None, batch=64, size=128, iters=20, windows=3):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--size", type=int, default=size,
                    help="H = W, a multiple of 32 (64 for conv_probe2)")
    ap.add_argument("--iters", type=int, default=iters,
                    help="launches per timed window")
    ap.add_argument("--windows", type=int, default=windows)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.size < 32 or args.size % 32:
        ap.error(f"--size {args.size}: a multiple of 32")
    return args


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-6)


def c64_inputs(rng, b, h, w, c=64, f=64):
    """The probes' pair-packed conv inputs: fp32 x [B, H+2, W+16, C] with
    the valid W+2 columns uniform in [0, 1) and the rest zero, w [3, 3, C,
    F] ~ 0.05 N(0, 1)."""
    x = np.zeros((b, h + 2, w + WPAD2, c), np.float32)
    x[:, :, :w + 2, :] = rng.rand(b, h + 2, w + 2, c)
    wt = (rng.randn(3, 3, c, f) * 0.05).astype(np.float32)
    return x, wt


def _bf16(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.bfloat16)


def _chain(weights, fn):
    """A probe that launches ``fn(w)`` for the i-th weight set on call i."""
    return lambda i: fn(weights[i % len(weights)])


def carried_chain(y0, weights):
    """A probe whose every conv reads the previous conv's output."""
    state = {"y": y0}

    def step(i):
        state["y"] = F.conv2d(state["y"], weights[i % len(weights)],
                              padding=1)
        return state["y"]
    return step


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    B, H, W, C, Fo = args.batch, args.size, args.size, 64, 64
    rng = np.random.RandomState(0)
    useful = 2 * B * H * W * 9 * C * Fo

    # ---------- conv64p: the model's c64 -> 64, pair-packed -------------
    x64, w = c64_inputs(rng, B, H, W, C, Fo)
    xp = _bf16(pack_pairs(x64), dev)
    wp = _bf16(pack_pair_weights(w), dev)
    conv64p = make_conv64p_kernel(16, H, W, C)
    with torch.no_grad():
        got = conv64p(xp, wp).reshape(B, H, W, Fo)
        want = conv128_plain(_bf16(x64, dev), _bf16(w.reshape(9 * C, Fo), dev),
                             H, W)
    err = rel_err(got, want)
    print(f"correctness conv64p vs plain conv: rel-err {err:.2e}", flush=True)
    assert err < 2e-2, err

    # ---------- conv128: the ideal-width im2col kernel ------------------
    C2 = 128
    x128 = _bf16(rng.rand(B, H + 2, W + WPAD, C2), dev)
    w128 = rng.randn(3, 3, C2, C2) * 0.05
    w128f = _bf16(w128.reshape(9 * C2, C2), dev)
    conv128 = make_conv128_kernel(16, H, W, C2, C2)
    with torch.no_grad():
        err2 = rel_err(conv128(x128, w128f),
                       conv128_plain(x128, w128f, H, W))
    print(f"correctness conv128 vs plain conv: rel-err {err2:.2e}",
          flush=True)
    assert err2 < 2e-2, err2
    flops128 = 2 * B * H * W * 9 * C2 * C2

    # ---------- rates ---------------------------------------------------
    scale = [1 + 0.01 * i for i in range(NCHAIN)]
    wp_stack = [_bf16(pack_pair_weights(w) * s, dev) for s in scale]
    w128f_stack = [_bf16(w128.reshape(9 * C2, C2) * s, dev) for s in scale]
    oihw = lambda a: np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
    w64s = [_bf16(oihw(w * s), dev) for s in scale]
    w128s = [_bf16(oihw(w128 * s), dev) for s in scale]
    cl = torch.channels_last
    y64 = _bf16(rng.rand(B, C, H, W), dev).contiguous(memory_format=cl)
    y128 = _bf16(rng.rand(B, C2, H, W), dev).contiguous(memory_format=cl)
    conv64p_32 = make_conv64p_kernel(32, H, W, C)
    conv128_32 = make_conv128_kernel(32, H, W, C2, C2)
    probes = [
        # (port name, probe, flops per launch, JAX probe name)
        ("cuDNN conv c64->64 (carried)", carried_chain(y64, w64s), useful,
         "XLA conv c64->64 (carried)"),
        ("conv64p th16 (useful)", _chain(wp_stack, lambda k: conv64p(xp, k)),
         useful, "PALLAS conv64p th16 (useful)"),
        ("conv64p th32 (useful)",
         _chain(wp_stack, lambda k: conv64p_32(xp, k)), useful,
         "PALLAS conv64p th32 (useful)"),
        ("cuDNN conv c128->128 (carried)", carried_chain(y128, w128s),
         flops128, "XLA conv c128->128 (carried)"),
        ("conv128 th16", _chain(w128f_stack, lambda k: conv128(x128, k)),
         flops128, "PALLAS conv128 th16"),
        ("conv128 th32", _chain(w128f_stack, lambda k: conv128_32(x128, k)),
         flops128, "PALLAS conv128 th32"),
    ]
    for (mm_name, M, K, N) in (("conv64p GEMM", B * H * W // 2, 768, 128),
                               ("c64 GEMM", B * H * W, 576, 64)):
        a = torch.rand(M, K, generator=torch.Generator(dev).manual_seed(M),
                       device=dev).to(torch.bfloat16)
        bs = [_bf16(rng.randn(K, N) * 0.05 * s, dev) for s in scale]
        mm = make_matmul_kernel(M, K, N, tile_m=math.gcd(M, 2048))
        flops = 2 * M * K * N
        probes += [
            (f"matmul {mm_name} {M}x{K}x{N}",
             _chain(bs, lambda k, mm=mm, a=a: mm(a, k)), flops,
             "PALLAS matmul (make_matmul_kernel, not run by its main)"),
            (f"torch.matmul {mm_name}",
             _chain(bs, lambda k, a=a: torch.matmul(a, k)), flops,
             "none (cuBLAS yardstick)")]
    print(f"--- best of {args.windows} windows of {args.iters} launches ---",
          flush=True)
    best = best_ms(dev, [(n, fn) for n, fn, _, _ in probes], args.iters,
                   args.windows)
    for n, _, flops, jax_name in probes:
        print_rate(n, flops, best[n], jax_name)
    return best


if __name__ == "__main__":
    main()
