"""Pair-packed conv variant sweep: the port of ``tools/pallas_conv2.py``'s
``main`` (c64 -> 64 at the flagship's 128x128 shape).

    python -m salt_tpu_torch.tools.conv_probe2 [--batch 64] [--size 128] \
        [--iters 20] [--windows 2] [--device cuda|cpu]

Each variant of ``ops.conv64p_kernel.make_conv64p_v2`` (tile_h and
``db``, which the card's kernel takes as the TPU kernel's contract: its
TMA input ring always double-buffers; ``int8``: s8 x s8 -> s32 operands)
is held against the plain fp32 conv of the bf16 operands: the
relative error (max |diff| / max |plain|) must be below 2e-2 in bf16 and
5e-2 in int8, whose operands are the JAX probe's symmetric per-tensor
quantization (x and the packed weights each scaled so their largest |v|
is 127, rounded, clipped to +-127; the result is scaled back). Each line
is marked OK or WRONG; any WRONG fails the run after the sweep.

The Pallas sweep also varies ``shift`` (roll, hoist, slice) and ``dots``
(concat, split): Mosaic's data movement, with no counterpart on the card.
Each port variant prints the JAX variants it stands for. Then the rates,
in TF/s of useful conv flops, best of ``--windows`` interleaved windows
of ``--iters`` launches (``tools.timing``). Runs on the card and fails
without CUDA unless ``--device cpu`` is given (``--size`` a multiple of
64 there too).
"""
from __future__ import annotations

import numpy as np
import torch

from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.ops.conv64p_kernel import make_conv64p_v2
from salt_tpu_torch.ops.probe_conv import (conv128_plain, pack_pair_weights,
                                           pack_pairs)
from salt_tpu_torch.tools.conv_probe import (_bf16, c64_inputs, parse_args,
                                             rel_err)
from salt_tpu_torch.tools.timing import best_ms, print_rate

#: (port variant, tile_h, db, int8, the JAX variants it stands for)
VARIANTS = (
    ("conv64p_v2 th32", 32, False, False,
     ("v1-ish roll/concat th32", "v2 hoist/split th32",
      "v2 hoist/concat th32", "v2 slice/split th32")),
    ("conv64p_v2 th32 +db", 32, True, False, ("v2 hoist/split th32 +db",)),
    ("conv64p_v2 th64 +db", 64, True, False, ("v2 hoist/split th64 +db",)),
    ("conv64p_v2 th32 +db INT8", 32, True, True,
     ("v2 hoist/split th32 +db INT8", "v2 hoist/concat th32 +db INT8")),
    ("conv64p_v2 th64 +db INT8", 64, True, True,
     ("v2 hoist/concat th64 +db INT8",)),
)


def quantize(a: np.ndarray):
    """Symmetric per-tensor int8: (int8 values, scale)."""
    scale = float(np.abs(a).max()) / 127.0
    return np.clip(np.round(a / scale), -127, 127).astype(np.int8), scale


def main(argv=None):
    args = parse_args(argv, windows=2)
    if args.size % 64:
        raise SystemExit(f"--size {args.size}: a multiple of 64 (tile_h 64)")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    B, H, W, C, Fo = args.batch, args.size, args.size, 64, 64
    rng = np.random.RandomState(0)
    useful = 2 * B * H * W * 9 * C * Fo

    x64, w = c64_inputs(rng, B, H, W, C, Fo)
    wp_np = pack_pair_weights(w)
    xp, wp = _bf16(pack_pairs(x64), dev), _bf16(wp_np, dev)
    with torch.no_grad():
        want = conv128_plain(_bf16(x64, dev), _bf16(w.reshape(9 * C, Fo), dev),
                             H, W)
    xq, xs = quantize(pack_pairs(x64))
    wq, ws = quantize(wp_np)
    xp_i8 = torch.from_numpy(xq).to(dev)
    wp_i8 = torch.from_numpy(wq).to(dev)

    probes, wrong = [], []
    for port_name, th, db, int8, jax_names in VARIANTS:
        fn = make_conv64p_v2(th, H, W, C, db=db, int8=int8)
        xa, wa = (xp_i8, wp_i8) if int8 else (xp, wp)
        with torch.no_grad():
            got = fn(xa, wa).float().reshape(B, H, W, Fo)
        if int8:
            got = got * (xs * ws)
        err = rel_err(got, want)
        status = "OK" if err < (5e-2 if int8 else 2e-2) else "WRONG"
        print(f"{port_name}: rel-err {err:.2e} [{status}]  (JAX: "
              f"{'; '.join(jax_names)})", flush=True)
        if status == "WRONG":
            wrong.append(port_name)
        probes.append((port_name, lambda i, fn=fn, xa=xa, wa=wa: fn(xa, wa),
                       " / ".join(jax_names)))
    print(f"--- best of {args.windows} windows of {args.iters} launches ---",
          flush=True)
    best = best_ms(dev, [(n, fn) for n, fn, _ in probes], args.iters,
                   args.windows)
    for n, _, jax_name in probes:
        print_rate(n, useful, best[n], jax_name)
    if wrong:
        raise AssertionError(f"variants outside the tolerance: {wrong}")
    return best


if __name__ == "__main__":
    main()
