"""Model FLOPs of a configuration: ``torch.utils.flop_counter`` over one
forward of the configuration's reference model at 128x128, on the meta
device (a multiply-add counts 2). Each configuration file keeps its
count as ``forward_flops_per_image``; ``benchmark/tests`` holds every
file's count to a fresh one.

    python -m benchmark.flops benchmark/configs/<config>.json
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import reference


def forward_flops_per_image(cfg: dict) -> int:
    with torch.device("meta"):
        model = reference.for_config(cfg).build(cfg)
        x = torch.empty(1, 3, 128, 128)
    with FlopCounterMode(display=False) as counter:
        model(x)
    return int(counter.get_total_flops())


if __name__ == "__main__":
    for path in sys.argv[1:]:
        with open(path) as f:
            print(path, forward_flops_per_image(json.load(f)))
