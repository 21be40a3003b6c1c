"""A/B of the preprocess kernel (``csrc/preprocess.cu``, row 1) against
variants of its own source and two copies of the output's size.

    python -m salt_tpu_torch.tools.preprocess_ab [--variants a,b] \
        [--batches 24,48,96,384] [--dtypes bf16,fp32] [--iters 50] \
        [--windows 7]

Each variant is the checked-in source compiled with a few ``-D`` switches
(``VARIANTS``; the run fails if the source no longer declares one), by
``nvcc`` into ``salt_tpu_torch/build/ab/``, all at once, and called
through its own ``salt_preprocess_inference``:

- ``kernel``: the source as it is (2 chunks of 16 bytes a thread, 16
  output rows a block in bf16, 8 in fp32, the input read straight from
  device memory, gray values and ramps from tables in shared memory);
- ``c1_r8``, ``c1_r4``, ``c2_r8``, ``c4_r16``, ``c4_r32``: 1, 2 or 4
  chunks a thread, 4 to 32 rows a block (bf16; half as many in fp32);
- ``stage``: the band's source rows staged in shared memory first;
- ``no_lut``: each chunk computes its gray values and ramp (two IEEE
  divisions a pixel) instead of looking them up;
- ``v1``: the earlier kernel, one thread per pixel, its three channels
  stored one by one (2-byte stores in bf16);
- ``no_loads`` and ``stores_only`` (diagnostics; their output is wrong
  by design): the kernel with made-up bytes in place of its loads, and
  the kernel's grid and 16-byte stores with no loads and no arithmetic.

Beside them, ``copy``: ``dst.copy_(src)`` of a tensor the output's size
(reads and writes that many bytes), and ``fill``: ``dst.fill_(0)`` of it
(writes them): what the card's own copy and fill take for those bytes.

Inputs are seeded uint8 images; every variant but ``stores_only`` must
equal the plain version (``ops.preprocess.preprocess_inference``, on the
CPU, whose divisions the kernel repeats; on the card torch divides by a
scalar through its reciprocal): fp32 within 1e-5, bf16 within one bf16
ulp of the plain fp32 result. The errors are printed: 0 in bf16; in
fp32 an ulp or so where torch's CPU linspace rounds a ramp value apart
from the kernel's (which is torch's on the card). Times
are device times from ``torch.profiler``: in each of ``--windows``
windows, under one profiler session, every probe runs ``--iters`` times,
the probes in an order that starts one later each window; a probe's time
in a window is the mean duration of its device operations. Min and
median per probe, one JSON
line per (batch, dtype, probe), with the card's name and power limit.
A kernel of a few microseconds cannot be timed with CUDA events around
back-to-back launches: those time the host's launch rate. Needs a CUDA
card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.preprocess import preprocess_inference
from salt_tpu_torch.ops.preprocess_kernel import _ARGTYPES, NET, RAW

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory

#: name -> (-D switches of csrc/preprocess.cu, computes the output)
VARIANTS = {
    "kernel": ({}, True),
    "c1_r8": ({"SALT_PRE_CHUNKS": 1, "SALT_PRE_ROWS": 8}, True),
    "c1_r4": ({"SALT_PRE_CHUNKS": 1, "SALT_PRE_ROWS": 4}, True),
    "c2_r8": ({"SALT_PRE_ROWS": 8}, True),
    "c4_r16": ({"SALT_PRE_CHUNKS": 4}, True),
    "c4_r32": ({"SALT_PRE_CHUNKS": 4, "SALT_PRE_ROWS": 32}, True),
    "stage": ({"SALT_PRE_STAGE": 1}, True),
    "no_lut": ({"SALT_PRE_LUT": 0}, True),
    "v1": ({"SALT_PRE_V1": 1}, True),
    "no_loads": ({"SALT_PRE_NO_LOADS": 1}, False),
    "stores_only": ({"SALT_PRE_STORES_ONLY": 1}, False),
}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--batches", default="24,48,96,384")
    ap.add_argument("--dtypes", default="bf16,fp32")
    ap.add_argument("--iters", type=int, default=50,
                    help="launches per probe and window")
    ap.add_argument("--windows", type=int, default=7)
    args = ap.parse_args(argv)
    args.variants = args.variants.split(",")
    args.batches = [int(b) for b in args.batches.split(",")]
    args.dtypes = args.dtypes.split(",")
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if set(args.dtypes) - set(DTYPES):
        ap.error(f"dtypes are {sorted(DTYPES)}")
    return args


def variant_flags(name: str) -> list:
    """The nvcc ``-D`` flags of variant ``name``; raises if the source no
    longer declares one of its switches."""
    with open(os.path.join(build.CSRC_DIR, "preprocess.cu")) as f:
        src = f.read()
    flags = []
    for macro, value in VARIANTS[name][0].items():
        if f"#ifndef {macro}\n" not in src:
            raise RuntimeError(f"variant {name}: csrc/preprocess.cu does not "
                               f"declare the switch {macro}")
        flags.append(f"-D{macro}={value}")
    return flags


def build_variants(names):
    """name -> (ctypes function, ptxas lines), built in parallel."""
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(build.CSRC_DIR, "preprocess.cu")
    procs = {}
    for name in names:
        lib = os.path.join(out_dir, f"libpreprocess_{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *variant_flags(name),
               "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit "
                               f"{proc.returncode}\n{log}")
        fn = ctypes.CDLL(lib).salt_preprocess_inference
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = (fn, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return fns


def max_errors(got: torch.Tensor, want: torch.Tensor) -> float:
    """fp32 output: max |got - want| over the tolerance 1e-5; bf16: max
    |got - bf16(want)| in bf16 ulps of bf16(want). At most 1 passes."""
    if got.dtype == torch.float32:
        return float((got - want).abs().max()) / 1e-5
    want16 = want.to(torch.bfloat16).float()
    return float(((got.float() - want16).abs()
                  / (want16.abs() * 2.0 ** -7 + 1e-30)).max())


def window_ms(calls, iters: int, attempts: int = 3) -> dict:
    """name -> device ms per call of each ``(name, call)`` in ``calls``,
    run ``iters`` times each, in order, under one profiler session: each
    call makes one device operation, so the session's device operations
    in time order are the calls' in launch order. A session whose count
    or names do not match that (the profiler drops events now and then)
    is run again, up to ``attempts`` sessions."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _, call in calls:
                for _ in range(iters):
                    call()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        groups = [ops[i * iters:(i + 1) * iters] for i in range(len(calls))]
        if len(ops) == len(calls) * iters and all(
                len({e.name for e in g}) == 1 for g in groups):
            return {name: sum(e.time_range.elapsed_us() for e in g)
                    / iters / 1e3 for (name, _), g in zip(calls, groups)}
    raise RuntimeError(f"the profiler recorded {len(ops)} device operations "
                       f"for {len(calls)} x {iters} calls in each of "
                       f"{attempts} sessions")


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("preprocess_ab measures the kernel on a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    fns = build_variants(args.variants)
    for name, (_, ptxas) in fns.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    failed = []
    for b in args.batches:
        rng = np.random.RandomState(b)
        imgs = torch.from_numpy((rng.rand(b, RAW, RAW) * 255)
                                .astype(np.uint8)).to(dev)
        want = preprocess_inference(imgs.cpu()).to(dev)
        for dname in args.dtypes:
            dtype = DTYPES[dname]
            out = torch.empty(b, NET, NET, 3, dtype=dtype, device=dev)
            ref = torch.empty_like(out)
            calls, errs = {}, {}
            for name, (fn, _) in fns.items():
                def call(fn=fn):
                    rc = fn(imgs.data_ptr(), out.data_ptr(), b,
                            int(dtype == torch.bfloat16), stream)
                    if rc != 0:
                        raise RuntimeError(f"preprocess launch: cudaError "
                                           f"{rc}")
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                errs[name] = max_errors(out, want)
                if VARIANTS[name][1] and not errs[name] <= 1.0:
                    failed.append(f"B {b} {dname} {name}: {errs[name]} x the "
                                  "tolerance")
                calls[name] = call
            calls["copy"] = lambda: out.copy_(ref)
            calls["fill"] = lambda: out.fill_(0)
            times = {name: [] for name in calls}
            order = list(calls.items())
            for i in range(args.windows):
                window = order[i % len(order):] + order[:i % len(order)]
                for name, ms in window_ms(window, args.iters).items():
                    times[name].append(ms)
            out_bytes = out.numel() * out.element_size()
            moved = {"copy": 2 * out_bytes, "fill": out_bytes}
            for name, ts in times.items():
                ts = sorted(ts)
                nbytes = moved.get(name, b * RAW * RAW + out_bytes)
                print(json.dumps({
                    "batch": b, "dtype": dname, "variant": name,
                    "ms_min": ts[0], "ms_median": ts[len(ts) // 2],
                    "ms_windows": ts, "bytes": nbytes,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "tb_per_s_median": nbytes / ts[len(ts) // 2] / 1e9,
                    "max_err_over_tol": errs.get(name),
                    "exact": VARIANTS[name][1] if name in VARIANTS else None,
                    "card": card}), flush=True)
            del out, ref
        del imgs, want
    if failed:
        raise AssertionError("; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
