"""A/B of the VALID-conv kernel (``csrc/conv_valid.cu``, rows 4, 5 and 7
of the probe kernels) against variants of its own source and cuDNN, at
the probes' full size.

    python -m salt_tpu_torch.tools.conv_valid_ab [--variants a,b] \
        [--batch 64] [--size 128] [--iters 100] [--windows 8]

Each variant is the checked-in source with a few text edits (``VARIANTS``;
the run fails if an edit no longer applies), compiled by ``nvcc`` into
``salt_tpu_torch/build/ab/`` next to the others, all at once, and called
through its own ``salt_conv_valid`` (and ``salt_conv_valid_s8``):

- ``kernel``: the source as it is;
- ``no_setmaxnreg``: a producer warp in place of the producer warpgroup and
  no register hand-over (168 registers a thread: NT 128 spills);
- ``st_shared_epilogue``: 4-byte shared stores in place of stmatrix.x4;
- ``no_drain``: the wgmma pipe kept full across channel chunks and each
  slab released after its last ldmatrix;
- ``weights_once``, ``half_weights`` and ``loads_only`` (diagnostics;
  their sums are wrong by design): the first two load the weights in each
  block's first step only, or every tap's first 64 output channels only,
  which bounds what fewer weight bytes (a cluster multicast) could give;
  the third issues every load, ldmatrix and barrier but no wgmma, which
  times the fill alone.

Row 4 is x [B, H+2, W+8, 128] (columns past W+1 NaN) by w_flat [1152, 128];
row 5 x_packed [B, H+2, (W+16)/2, 128] by w_packed [768, 128], every slot
random; row 7 int8 the same in full-range int8 (the s8 instantiation, the
weights K-major, ``ops.conv_valid.kmajor_weights``), with the variants
that keep the s8 path's byte counts (not ``half_weights``). The exact
variants are held to one bf16 ulp plus 2 K 2^-24 sum|x||w| of
``ops.probe_conv.valid_conv_plain`` (int8: bit for bit). Times: CUDA
events around ``--iters`` launches, ``--windows`` windows with the
variants and cuDNN (``F.conv2d`` of the same function: 3x3 on row 4's
input, 3x2 128 -> 128 on the packed input; none for int8) interleaved,
each window starting one probe later than the last; min and median per
variant. One JSON line per (row, variant) and the card's name and power
limit. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch
import torch.nn.functional as F

from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.conv_valid import kmajor_weights
from salt_tpu_torch.ops.probe_conv import valid_conv_plain
from salt_tpu_torch.tools.timing import window_ms

_NO_SETMAXNREG = [
    ("constexpr int kThreads = kConsumers + 128;",
     "constexpr int kThreads = kConsumers + 32;"),
    ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(\n'
     "        kProducerRegs));\n", ""),
    ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(\n'
     "      kConsumerRegs));\n", ""),
]
_ST_SHARED = [(
    """        for (int j = 0; j < NT / 8; j += 2) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(
                static_cast<float>(acc[jr][(j + (i >> 1)) * 4 + (i & 1) * 2]),
                static_cast<float>(
                    acc[jr][(j + (i >> 1)) * 4 + (i & 1) * 2 + 1]));
            v[i] = *reinterpret_cast<const uint32_t*>(&h);
          }
          const int jj = j + sj;
          asm volatile(
              "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, "
              "%4};\\n" ::"r"(stage + (jj >> 3) * kAtomBytes + sp * 128 +
                              (((jj & 7) ^ (sp & 7)) << 4)),
              "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
              : "memory");
        }""",
    """        for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = warp * 16 + (lane >> 2) + half * 8;
            const __nv_bfloat162 h = __floats2bfloat162_rn(
                static_cast<float>(acc[jr][j * 4 + half * 2]),
                static_cast<float>(acc[jr][j * 4 + half * 2 + 1]));
            asm volatile("st.shared.b32 [%0], %1;\\n" ::"r"(
                             stage + (j >> 3) * kAtomBytes + p * 128 +
                             (((j & 7) ^ (p & 7)) << 4) + (lane & 3) * 4),
                         "r"(*reinterpret_cast<const uint32_t*>(&h))
                         : "memory");
          }
        }""")]
_NO_DRAIN = [
    ("  typename C::Acc acc[kRW][C::kAcc];\n"
     "  for (int s = 0; s < n_steps; ++s) {",
     "  typename C::Acc acc[kRW][C::kAcc];\n  int rslot = 0;\n"
     "  bool carry = false;\n  for (int s = 0; s < n_steps; ++s) {"),
    ("    int rslot = wslot;                       "
     "// the next tap to release\n    load_a(0, a[0]);",
     "    if (carry) wgmma_wait<1>();\n    load_a(0, a[0]);"),
    ("        if (j == 0 && u > 0) {",
     "        if (j == 0 && (u > 0 || carry)) {"),
    ("""        load_a(u + 1, a[(u + 1) & 1]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kRW; ++i) fence_operand<C::kAcc>(acc[i]);
    mbar_arrive(wempty + 8 * rslot);         // the step's last tap
    mbar_arrive(sempty + 8 * slot);          // the slab is free
""", """        load_a(u + 1, a[(u + 1) & 1]);
        if (u + 2 == kUnits) mbar_arrive(sempty + 8 * slot);
      }
    }
    carry = chunk != g.n_chunks - 1;
    if (!carry) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kRW; ++i) fence_operand<C::kAcc>(acc[i]);
      mbar_arrive(wempty + 8 * rslot);
      if (++rslot == C::kWSlots) rslot = 0;
    }
"""),
]
_WEIGHTS_ONCE = [
    ("      for (int tap = 0; tap < C::kTaps; ++tap) {",
     "      for (int tap = 0; tap < (s == 0 ? C::kTaps : 0); ++tap) {"),
    ("      if (j == 0) mbar_wait(wfull + 8 * wslot, wphase);",
     "      if (j == 0 && s == 0) mbar_wait(wfull + 8 * wslot, wphase);"),
    ("          mbar_arrive(wempty + 8 * rslot);\n          if (++rslot",
     "          if (s == 0) mbar_arrive(wempty + 8 * rslot);\n"
     "          if (++rslot"),
    ("    mbar_arrive(wempty + 8 * rslot);         // the step's last tap",
     "    if (s == 0) mbar_arrive(wempty + 8 * rslot);"),
]
_HALF_WEIGHTS = [
    ("        mbar_expect_tx(wfull + 8 * wslot, C::kTapBytes);",
     "        mbar_expect_tx(wfull + 8 * wslot, kAtomBytes);"),
    ("          for (int nb = 0; nb < NT / 64; ++nb)\n            tma_load_2d(",
     "          for (int nb = 0; nb < 1; ++nb)\n            tma_load_2d("),
]
_LOADS_ONLY = [(
    """      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kS8)
          wgmma_rs_s8<NT>(acc[j], a[u & 1][kk], b_desc(w + kk * 32));
        else
          wgmma_rs<NT, 1>(acc[j], a[u & 1][kk],
                          smem_desc(w + kk * 2048, kAtomBytes, 1024));
      }
""", "")]
#: name -> (text edits of csrc/conv_valid.cu, computes the conv exactly)
#: (``half_weights`` halves the bf16 weight boxes only: not run in int8)
VARIANTS = {
    "kernel": ([], True),
    "no_setmaxnreg": (_NO_SETMAXNREG, True),
    "st_shared_epilogue": (_ST_SHARED, True),
    "no_drain": (_NO_DRAIN, True),
    "weights_once": (_WEIGHTS_ONCE, False),
    "half_weights": (_HALF_WEIGHTS, False),
    "loads_only": (_LOADS_ONLY, False),
}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=128, help="H = W, even")
    ap.add_argument("--iters", type=int, default=100,
                    help="launches per timed window")
    ap.add_argument("--windows", type=int, default=8)
    args = ap.parse_args(argv)
    args.variants = args.variants.split(",")
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if args.size < 2 or args.size % 2:
        ap.error(f"--size {args.size}: even")
    return args


def variant_source(name: str) -> str:
    with open(os.path.join(build.CSRC_DIR, "conv_valid.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: an edit does not apply to "
                               f"csrc/conv_valid.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(names):
    """name -> (ctypes library, ptxas lines), built in parallel."""
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(out_dir, f"conv_valid_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        lib = os.path.join(out_dir, f"libconv_valid_{name}.so")
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
        dll = ctypes.CDLL(lib)
        for fn in (dll.salt_conv_valid, dll.salt_conv_valid_s8):
            fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = (dll, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "C751" in ln])
    return fns


def _ulp_ratio(got, want, terms, k):
    want = want.float()
    _, exp = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    tol = ulp + 2 * k * 2.0 ** -24 * terms.float()
    return float(((got.float() - want).abs() / tol.clamp_min(1e-30)).max())


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_valid_ab measures the kernel on a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    fns = build_variants(args.variants)
    for name, (_, ptxas) in fns.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    b, h, w = args.batch, args.size, args.size
    g = torch.Generator(dev).manual_seed(0)
    rows = {"row4": (3, w, w + 8, False), "row5": (2, w // 2, (w + 16) // 2,
                                                    False),
            "row7_int8": (2, w // 2, (w + 16) // 2, True)}
    failed = []
    for row, (kw, w_out, row_pixels, s8) in rows.items():
        k = 3 * kw * 128
        shape = (b, h + 2, row_pixels, 128)
        if s8:
            x = torch.randint(-128, 128, shape, generator=g, device=dev,
                              dtype=torch.int8)
            x[:, :, w_out + kw - 1:] = 127
            wt = torch.randint(-128, 128, (k, 128), generator=g, device=dev,
                               dtype=torch.int8)
        else:
            draw = torch.randn if kw == 3 else torch.rand
            x = draw(*shape, generator=g, device=dev)
            x[:, :, w_out + kw - 1:] = float("nan")
            x = x.bfloat16()
            wt = (torch.randn(k, 128, generator=g, device=dev) / k ** 0.5
                  ).bfloat16()
        w_arg = kmajor_weights(wt) if s8 else wt
        with torch.no_grad():
            want = valid_conv_plain(x, wt, 3, kw, h, w_out)
            terms = valid_conv_plain(x.float().abs().nan_to_num(),
                                     wt.float().abs(), 3, kw, h, w_out)
        out = torch.empty(b, h, w_out, 128, dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        calls, errs = {}, {}
        for name, (dll, _) in fns.items():
            if s8 and name == "half_weights":
                continue
            fn = dll.salt_conv_valid_s8 if s8 else dll.salt_conv_valid

            def call(_i=0, fn=fn):
                rc = fn(x.data_ptr(), w_arg.data_ptr(), out.data_ptr(), b, h,
                        w_out, kw, 128, 128, row_pixels, stream)
                if rc != 0:
                    raise RuntimeError(f"conv_valid launch: cudaError {rc}")
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            errs[name] = (0.0 if torch.equal(out, want) else float("inf")
                          ) if s8 else _ulp_ratio(out, want, terms, k)
            if VARIANTS[name][1] and not errs[name] <= 1.0:
                failed.append(f"{row} {name}: {errs[name]} x the tolerance")
            calls[name] = call
        del want, terms
        if not s8:
            xn = x[:, :, :w_out + kw - 1].contiguous().permute(0, 3, 1, 2)
            wn = wt.reshape(3, kw, 128, 128).permute(3, 2, 0, 1).contiguous()
            calls["cudnn"] = lambda _i=0, xn=xn, wn=wn: F.conv2d(xn, wn)
        times = {name: [] for name in calls}
        with torch.no_grad():
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            order = list(calls.items())
            for i in range(args.windows):
                # each window starts one probe later: the first after
                # another probe's window ran slower on an H100
                for name, call in order[i % len(order):] + order[
                        :i % len(order)]:
                    times[name].append(window_ms(dev, call, args.iters))
        for name, ts in times.items():
            ts = sorted(ts)
            print(json.dumps({
                "row": row, "variant": name, "ms_min": ts[0],
                "ms_median": ts[len(ts) // 2], "ms_windows": ts,
                "worst_err_over_tol": errs.get(name),
                "exact": VARIANTS[name][1] if name in VARIANTS else True,
                "card": card}), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
