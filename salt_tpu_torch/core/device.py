"""Device selection for the port's entry points.

Every entry point defaults to ``device="cuda"`` and refuses to run when
CUDA is absent: nothing switches to the CPU unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI).
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda or cpu")
    return dev
