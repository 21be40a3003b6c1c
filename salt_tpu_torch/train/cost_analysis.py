"""Cost analysis of the step programs (counterpart of
``salt_tpu/train/cost_analysis.py`` :44-141: ``analyze_program``,
``analyze_runner``, ``report``).

Where the JAX package reads XLA's cost model of a compiled program, the
port runs each step once on its device and counts what ran:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
  matrix products, forward and backward), plus the hand kernels' own
  operation counts, which it cannot see inside a ctypes launch
  (``ops/costs.py``: the counts of ``chip_smoke.py``'s bounds). On the
  CPU the kernels' plain versions run as torch ops and are counted as
  such.
- Bytes: the sum of every op's input and output bytes under a
  ``TorchDispatchMode`` (view ops skipped), plus the hand kernels'. An
  upper estimate: a fused kernel reads its inputs once, and the cache
  serves repeats.
- Memory: ``temp_bytes`` is the device's allocation high-water mark
  during the step above what was allocated before it
  (``torch.cuda.max_memory_allocated``); None on the CPU.

From those: the arithmetic intensity, the time at the FLOP peak and at
the memory rate, which of the two bounds the step, and, given measured
times, the MFU. The peaks are the H100 SXM's (bf16 dense, HBM3) of
``ops/costs.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from salt_tpu_torch.ops import costs
from salt_tpu_torch.ops.costs import BF16_DENSE_FLOPS, HBM_BYTES_PER_S


class _ByteCounter(TorchDispatchMode):
    """The bytes of every op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def _tensor_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(trees)[0]
               if isinstance(t, torch.Tensor))


def analyze_program(fn: Callable[[], Any], device: torch.device,
                    arguments=()) -> Dict[str, Any]:
    """Run ``fn()`` once on ``device`` under the counters; ``arguments``
    (tensors, or trees of them) are what it reads as its arguments."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    with costs.recording() as launches, \
            FlopCounterMode(display=False) as flop_counter, \
            _ByteCounter() as byte_counter:
        out = fn()
    temp = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        temp = int(torch.cuda.max_memory_allocated(dev) - before)
    kernels: Dict[str, Dict[str, int]] = {}
    for c in launches:
        k = kernels.setdefault(c.kernel, {"launches": 0, "operations": 0,
                                          "bytes": 0})
        k["launches"] += 1
        k["operations"] += c.operations
        k["bytes"] += c.nbytes
    flops = float(flop_counter.get_total_flops()
                  + sum(k["operations"] for k in kernels.values()))
    bytes_accessed = float(byte_counter.bytes
                           + sum(k["bytes"] for k in kernels.values()))
    intensity = flops / bytes_accessed if bytes_accessed else float("inf")
    t_flop = flops / BF16_DENSE_FLOPS
    t_bw = bytes_accessed / HBM_BYTES_PER_S
    return {
        "flops": flops,
        "gflops": round(flops / 1e9, 2),
        "bytes_accessed": bytes_accessed,
        "bytes_note": "upper estimate: every op's inputs and outputs",
        "arithmetic_intensity": round(intensity, 1),
        "ideal_ms_flop_bound": round(t_flop * 1e3, 3),
        "ideal_ms_bw_bound": round(t_bw * 1e3, 3),
        "bound": "flop" if t_flop >= t_bw else "bandwidth",
        "argument_bytes": _tensor_bytes(arguments),
        "output_bytes": _tensor_bytes(out),
        "temp_bytes": temp,
        "hand_kernels": kernels,
    }


def analyze_runner(runner, batch_train: int = 0, batch_infer: int = 0
                   ) -> Dict[str, Dict[str, Any]]:
    """Cost-analyze a ``SegmentationRunner``'s step programs on its
    device: ``train_step`` (from ``init_state(seed)``),
    ``predict_step`` and, with ``postpro.use_tta``, ``predict_tta_step``
    (the serving model, ``init_model(seed)``), each once on seeded uint8
    images. Returns {step name: analysis}."""
    cfg = runner.config
    bt = batch_train or cfg.training.batch_size_train
    bi = batch_infer or cfg.training.batch_size_inference
    seed = cfg.execution.seed
    state = runner.init_state(seed)
    h, w = runner._img_hw
    rng = np.random.RandomState(0)
    images, masks = runner.device_batch(
        (rng.rand(bt, h, w) * 255).astype(np.uint8),
        (rng.rand(bt, h, w) > 0.5).astype(np.uint8))
    depths = (runner.device_batch(np.zeros((bt, 1), np.float32))[0]
              if runner.use_depth else None)
    generator = torch.Generator(device=runner.device).manual_seed(seed)
    train_args = [list(state.model.parameters()),
                  list(state.model.buffers()),
                  [list(s.values()) for s in state.optimizer.state.values()],
                  images, masks]

    out: Dict[str, Dict[str, Any]] = {}
    out["train_step"] = analyze_program(
        lambda: runner.train_step(state, images, masks, generator, depths),
        runner.device, train_args)
    model = runner.init_model(seed)
    infer, = runner.device_batch((rng.rand(bi, h, w) * 255).astype(np.uint8))
    d_inf = (runner.device_batch(np.zeros((bi, 1), np.float32))[0]
             if runner.use_depth else None)
    weights = [list(model.parameters()), list(model.buffers()), infer]
    out["predict_step"] = analyze_program(
        lambda: runner.predict_step(model, infer, d_inf), runner.device,
        weights)
    if cfg.postpro.use_tta:
        out["predict_tta_step"] = analyze_program(
            lambda: runner.predict_tta_step(model, infer, d_inf),
            runner.device, weights)
    return out


def report(analyses: Dict[str, Dict[str, Any]],
           measured_ms: Optional[Dict[str, float]] = None) -> str:
    """The roofline table; ``measured_ms`` (e.g. from ``trace_steps``)
    adds the measured time and the MFU."""
    lines = []
    hdr = (f"{'step':<18} {'GFLOP':>9} {'GB moved':>9} {'FLOP/B':>7} "
           f"{'ideal ms':>9} {'bound':>10}")
    if measured_ms:
        hdr += f" {'meas ms':>8} {'MFU %':>6}"
    lines.append(hdr)
    for name, a in analyses.items():
        ideal = max(a["ideal_ms_flop_bound"], a["ideal_ms_bw_bound"])
        row = (f"{name:<18} {a['gflops']:>9.1f} "
               f"{a['bytes_accessed']/1e9:>9.2f} "
               f"{a['arithmetic_intensity']:>7.1f} {ideal:>9.3f} "
               f"{a['bound']:>10}")
        if measured_ms and name in measured_ms:
            ms = measured_ms[name]
            mfu = a["flops"] / (ms / 1e3) / BF16_DENSE_FLOPS * 100
            row += f" {ms:>8.2f} {mfu:>6.1f}"
        lines.append(row)
        temp = ("not measured (CPU)" if a["temp_bytes"] is None
                else f"{a['temp_bytes']/1e6:.0f} MB")
        lines.append(
            f"{'':<18} temp {temp}, "
            f"args {a['argument_bytes']/1e6:.0f} MB, "
            f"out {a['output_bytes']/1e6:.0f} MB; hand kernels "
            + (", ".join(f"{k} x{v['launches']}"
                         for k, v in a["hand_kernels"].items()) or "none"))
    lines.append("GB moved: an upper estimate (every op's inputs and "
                 "outputs); peaks: H100 SXM bf16 dense "
                 f"{BF16_DENSE_FLOPS/1e12:.0f} TFLOP/s, "
                 f"{HBM_BYTES_PER_S/1e12:.2f} TB/s")
    return "\n".join(lines)
