"""The Lovász sort kernel's plan at each chunk: bit-identity, time per
call and per launch.

    python -m salt_tpu_torch.tools.sort_probe [--rows 24,8] \
        [--chunks 4096,8192] [--length 32768] [--iters 20] [--windows 3] \
        [--device cuda|cpu]

For each row count (24: every call of the flagship's train and CV
paths, whose validation pads its last batch to 24; 8: a batch of 8) and
each chunk, keys rounded to quarters (ties) and a Lovász-style payload
go through
``ops.sort_kernel.launch_plan`` at that chunk, and keys and payload must
equal the plain network's (``ops.bitonic``) bit for bit; any that do not
fail the run after the sweep. Then, on the card:

- ``ms``: device time per call summed over the plan's launches
  (``torch.profiler``), best of ``--windows`` windows of ``--iters``
  calls, the chunks interleaved within each window;
- ``launch_us``: each launch's device time, by its place in the plan,
  from that best window;
- ``events_ms``: CUDA-event time per call, the gaps between launches
  included (``tools.timing``);
- ``library_ms``: ``torch.sort`` (stable, descending) with the payload
  gathered along, the same function in one library call.

One JSON line per (rows, chunk). With ``--device cpu`` the plan runs
through its CPU executor (``ops.bitonic.run_plan``): a check of the plan
and the harness, timed on the host clock, never the card's.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.ops import sort_kernel as sk
from salt_tpu_torch.ops.bitonic import OP_CHUNK, bitonic_sort_desc, run_plan
from salt_tpu_torch.tools.timing import best_ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="24,8")
    ap.add_argument("--chunks", default=f"{sk.CHUNK},{sk.MAX_CHUNK}")
    ap.add_argument("--length", type=int, default=sk.MAX_LENGTH)
    ap.add_argument("--iters", type=int, default=20,
                    help="calls per timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.rows = [int(v) for v in args.rows.split(",")]
    args.chunks = [int(v) for v in args.chunks.split(",")]
    if not sk.kernel_length_ok(args.length):
        ap.error(f"--length {args.length}: a power of two in [128, "
                 f"{sk.MAX_LENGTH}]")
    return args


def tied_inputs(b, p, seed):
    """Keys rounded to quarters; payload ``label << 20 | index``."""
    rng = np.random.RandomState(seed)
    keys = np.round(rng.randn(b, p).astype(np.float32) * 4) / 4
    payload = ((rng.randint(0, 2, (b, p)) << 20)
               | np.arange(p)).astype(np.int32)
    return torch.from_numpy(keys), torch.from_numpy(payload)


def _profiled_window(fn, prefix, n_launches, iters):
    """(ms per call summed over the launches, each launch's us) over one
    window of ``iters`` calls from ``torch.profiler``; None where the
    trace holds another number of the plan's kernels than it launched."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and prefix in e.name]
    if len(events) != iters * n_launches:
        return None
    each = [sum(e.time_range.elapsed_us() for e in events[i::n_launches])
            / iters for i in range(n_launches)]
    return sum(each) / 1e3, each


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}",
          flush=True)
    p, wrong = args.length, []
    for b in args.rows:
        keys, payload = (t.to(dev) for t in tied_inputs(b, p, seed=b))
        want_k, want_p = bitonic_sort_desc(keys, payload)
        sorts = {}
        for chunk in args.chunks:
            plan = sk.sort_plan(p, chunk)
            if on_card:
                def sort(chunk=chunk):
                    return sk.launch_plan(keys, payload, chunk)
            else:
                def sort(plan=plan):
                    return run_plan(keys, payload, plan)
            got_k, got_p = sort()
            if not (torch.equal(got_k.view(torch.int32),
                                want_k.view(torch.int32))
                    and torch.equal(got_p, want_p)):
                wrong.append((b, chunk))
            sorts[chunk] = (plan, sort)

        def library():
            values, idx = torch.sort(keys, dim=1, descending=True,
                                     stable=True)
            return values, payload.gather(1, idx)

        events = best_ms(dev, [(str(c), lambda _, f=f: f())
                               for c, (_, f) in sorts.items()]
                         + [("library", lambda _: library())],
                         args.iters, args.windows)
        profiled = {}
        if on_card:
            for _ in range(args.windows):
                for chunk, (plan, sort) in sorts.items():
                    got = _profiled_window(sort, sk.KERNEL_PREFIX, len(plan),
                                           args.iters)
                    if got and (chunk not in profiled
                                or got[0] < profiled[chunk][0]):
                        profiled[chunk] = got
        for chunk, (plan, _) in sorts.items():
            ms, each = profiled.get(chunk, (None, None))
            print(json.dumps({
                "rows": b, "length": p, "chunk": chunk,
                "launches": len(plan), "device": "cuda" if on_card else "cpu",
                "bit_identical": (b, chunk) not in wrong,
                "ms": ms, "events_ms": events[str(chunk)],
                "library_ms": events["library"],
                "launch_us": None if each is None else {
                    f"{i}:{'chunk' if l.op == OP_CHUNK else 'strided'}"
                    f"{l.k_lo}-{l.k_hi}": us
                    for i, (l, us) in enumerate(zip(plan, each))}}),
                flush=True)
    if wrong:
        raise SystemExit(f"not bit-identical to the network at (rows, "
                         f"chunk) {wrong}")


if __name__ == "__main__":
    main()
