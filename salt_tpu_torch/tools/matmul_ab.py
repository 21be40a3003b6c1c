"""A/B of the matmul kernel (``csrc/matmul_wgmma.cu``, row 6 of the probe
kernels) against variants of its own source and ``torch.matmul``, at the
probe's two GEMMs.

    python -m salt_tpu_torch.tools.matmul_ab [--variants a,b] \
        [--iters 50] [--windows 8]

Each variant is the checked-in source with a few text edits (``VARIANTS``;
the run fails if an edit no longer applies), compiled by ``nvcc`` into
``salt_tpu_torch/build/ab/`` next to the others, all at once, and called
through its own ``salt_matmul_wgmma``:

- ``kernel``: the source as it is (128-row tiles, a ring of 4 stages,
  64 KB of a in flight, b's box in every stage);
- ``bm256``: 256-row tiles (two m64 accumulators a warpgroup; b's traffic
  into shared memory half of a's, 128 KB of a in flight);
- ``ring6``: a ring of 6 stages (96 KB of a in flight);
- ``loads_only`` (a diagnostic; its sums are wrong by design): every load,
  barrier and store but no wgmma, which times the stream alone.

The GEMMs are [524288, 768] x [768, 128] (the pair-packed conv's) and
[1048576, 576] x [576, 64] (the c64 conv's), bf16, a and b from a seeded
normal draw (b scaled by K^-1/2). The exact variants are held to one
bf16 ulp plus 2 K 2^-24 sum|a||b| of ``ops.probe_conv.matmul_plain``.
Times: CUDA events around ``--iters`` launches, ``--windows`` windows with
the variants and ``torch.matmul`` (cuBLAS, the yardstick) interleaved,
each window starting one probe later than the last; min and median per
variant. One JSON line per (GEMM, variant) and the card's name and power
limit. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.matmul_kernel import _ARGTYPES
from salt_tpu_torch.ops.probe_conv import matmul_plain
from salt_tpu_torch.tools.conv_valid_ab import _ulp_ratio
from salt_tpu_torch.tools.timing import window_ms

_BM256 = [("constexpr int kBM = 128;", "constexpr int kBM = 256;")]
_RING6 = [("constexpr int kStages = 4;", "constexpr int kStages = 6;")]
_LOADS_ONLY = [(
    """        wgmma_ss_tn<NT>(acc[mi], b_desc(a + mi * 64 * 128 + kk * 32),
                          smem_desc(b + kk * 2048, kAtomBytes, 1024));""",
    "        (void)a, (void)b;")]
#: name -> (text edits of csrc/matmul_wgmma.cu, computes the product
#: exactly)
VARIANTS = {
    "kernel": ([], True),
    "bm256": (_BM256, True),
    "ring6": (_RING6, True),
    "loads_only": (_LOADS_ONLY, False),
}
#: (M, K, N) of the probe's GEMMs (tools/pallas_conv.py's main)
GEMMS = ((524288, 768, 128), (1048576, 576, 64))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=50,
                    help="launches per timed window")
    ap.add_argument("--windows", type=int, default=8)
    args = ap.parse_args(argv)
    args.variants = args.variants.split(",")
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    return args


def variant_source(name: str) -> str:
    with open(os.path.join(build.CSRC_DIR, "matmul_wgmma.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: an edit does not apply to "
                               f"csrc/matmul_wgmma.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(names):
    """name -> (ctypes function, ptxas lines), built in parallel."""
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(out_dir, f"matmul_wgmma_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        lib = os.path.join(out_dir, f"libmatmul_wgmma_{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR,
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
        fn = ctypes.CDLL(lib).salt_matmul_wgmma
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = (fn, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "C751" in ln])
    return fns


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_ab measures the kernel on a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    fns = build_variants(args.variants)
    for name, (_, ptxas) in fns.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    g = torch.Generator(dev).manual_seed(0)
    failed = []
    for m, k, n in GEMMS:
        a = torch.randn(m, k, generator=g, device=dev).bfloat16()
        b = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5
             ).bfloat16()
        with torch.no_grad():
            want = matmul_plain(a, b)
            terms = matmul_plain(a.float().abs(), b.float().abs())
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        calls, errs = {}, {}
        for name, (fn, _) in fns.items():
            def call(_i=0, fn=fn):
                rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"matmul launch: cudaError {rc}")
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            errs[name] = _ulp_ratio(out, want, terms, k)
            if VARIANTS[name][1] and not errs[name] <= 1.0:
                failed.append(f"{m}x{k}x{n} {name}: {errs[name]} x the "
                              "tolerance")
            calls[name] = call
        del want, terms
        calls["torch.matmul"] = lambda _i=0: torch.matmul(a, b)
        times = {name: [] for name in calls}
        with torch.no_grad():
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            order = list(calls.items())
            for i in range(args.windows):
                # each window starts one probe later (PERF.md: the first
                # window after another probe's ran slower on an H100)
                for name, call in order[i % len(order):] + order[
                        :i % len(order)]:
                    times[name].append(window_ms(dev, call, args.iters))
        nbytes = (m * k + k * n + m * n) * 2
        for name, ts in times.items():
            ts = sorted(ts)
            print(json.dumps({
                "gemm": f"{m}x{k}x{n}", "variant": name, "ms_min": ts[0],
                "ms_median": ts[len(ts) // 2], "ms_windows": ts,
                "tb_per_s_median": nbytes / ts[len(ts) // 2] / 1e9,
                "worst_err_over_tol": errs.get(name),
                "exact": VARIANTS[name][1] if name in VARIANTS else True,
                "card": card}), flush=True)
        del a, b, out
    if failed:
        raise AssertionError("; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
