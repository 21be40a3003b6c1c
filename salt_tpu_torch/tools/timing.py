"""Interleaved timing windows for the probe harnesses.

Each window runs every probe ``iters`` times back to back; a probe's
time is the best of its windows. On the card a window is timed with CUDA
events around its launches; on the CPU with the host clock (such a time
is the CPU's, never the card's)."""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_ms(device: torch.device, fn: Callable[[int], object],
              iters: int) -> float:
    """Milliseconds per call of ``fn(i)``, i = 0 .. iters-1, in one
    window."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / iters


def best_ms(device: torch.device,
            probes: Sequence[Tuple[str, Callable[[int], object]]],
            iters: int, windows: int) -> Dict[str, float]:
    """name -> best ms per call over ``windows`` windows, the probes
    interleaved within each window; one warm-up call each first."""
    with torch.no_grad():
        for _, fn in probes:
            fn(0)
        sync(device)
        best = {name: float("inf") for name, _ in probes}
        for _ in range(windows):
            for name, fn in probes:
                best[name] = min(best[name], window_ms(device, fn, iters))
    return best


def print_rate(name: str, flops: float, ms: float, jax_name: str) -> None:
    print(f"{name:<40} {flops / ms / 1e9:8.2f} TF/s  {ms:9.4f} ms"
          f"  (JAX probe: {jax_name})", flush=True)
