// s8 x s8 -> s32 implicit-GEMM convolution with the dequantization in the
// epilogue, for the H100 (sm_90a); plain C interface loaded with ctypes by
// salt_tpu_torch/ops/int8_conv.py.
//
// No TPU kernel: the JAX package's int8 convs are AQT's XLA convolution
// (salt_tpu/models/quant.py:24-34). This computes every conv that route
// takes in the U-Nets (7x7, 3x3 and 1x1 kernels, strides 1 and 2, zero
// padding, groups 1 or 32) on the operands that csrc/int8_quant.cu wrote:
//   out[b, y, x, o] = D((float(acc) * sx[b]) * sw[o]),
//   acc = sum over (ky, kx, c) of xq[b, y*sh - pt + ky, x*sw - pl + kx,
//         g*Cg + c] * wq[o, ky, kx, c]          (exact in s32)
// with the input NHWC int8 [B, H, W, C], the weight [O, KH, KW, Cg] int8
// (Cg = C / groups, o in group g = o / (O / groups)), the output NHWC in
// D = bf16 or fp32. The s32 sums are exact, so before the two fp32
// products (no contraction: __fmul_rn) the kernel equals the plain
// version (F.conv2d in float64 over the integers) bit for bit.
//
// Bound: operations, for the convs of the model: 2 M N K int8 operations
// (M = B Ho Wo pixels, N = O, K = KH KW Cg) at 1,979 TOP/s; bytes (x and
// w read once, the output written once) for the small maps.
//
// Design (a first kernel that is right; PERF.md has its times): the
// GEMM of M pixels by N output channels over K, K ordered (ky, kx, c)
// as the weight rows are. A block of 256 threads (8 warps, 4 x 2) takes a
// 128-pixel x 64-channel tile of one group and walks K in steps of 32,
// the depth of one mma.sync.m16n8k32 s8; each warp owns 32 x 32 outputs
// (2 x 4 MMAs a step, s32 accumulators in registers). The A (pixels x K)
// and B (channels x K) tiles pass through a 3-stage ring in shared memory,
// rows of 32 bytes padded to 48 so that the fragment loads (one 32-bit
// word per thread, rows gid and gid + 8, words tig and tig + 4) hit 32
// distinct banks. Where Cg and C are multiples of 16 every 16-byte
// granule of K lies inside one tap and is one cp.async (zero-filled where
// the tap falls in the padding or past K), so loads overlap the MMAs of
// the stages in flight. Otherwise (the stem's 3 channels, 4 or 8 channels
// a group) the block gathers bytes, the tap of each k from a table in
// shared memory, and stores them to the stage itself. Rows past M and
// channels past the group's width are masked in the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels a block
constexpr int kBN = 64;       // output channels a block (of one group)
constexpr int kBK = 32;       // K a stage: one m16n8k32 step
constexpr int kStages = 3;
constexpr int kRow = 48;      // bytes a tile row in shared memory
constexpr int kThreads = 256;
constexpr int kGatherK = 1024;  // the byte gather's table (ops/int8_conv.py)

struct Geometry {
  int batch, h, w, c, out_h, out_w, o, kh, kw, sh, sw, pt, pl, groups;
  int cg, ng, k;              // channels a group, outputs a group, K
  long long m;                // batch * out_h * out_w
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Out, bool kVector>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 Out* __restrict__ out, Geometry g) {
  __shared__ __align__(16) uint8_t sa[kStages][kBM * kRow];
  __shared__ __align__(16) uint8_t sb[kStages][kBN * kRow];
  // the byte gather's taps: offset of k in the input from the tap's
  // origin pixel (channel included), and (ky << 16) | kx
  __shared__ int tab_off[kVector ? 1 : kGatherK];
  __shared__ int tab_yx[kVector ? 1 : kGatherK];

  const int tid = threadIdx.x;
  const int grp = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nk = (g.k + kBK - 1) / kBK;

  if constexpr (!kVector) {
    for (int k = tid; k < nk * kBK; k += kThreads) {
      const int tap = k / g.cg, ch = k - tap * g.cg;
      const int ky = tap / g.kw, kx = tap - ky * g.kw;
      tab_off[k] = (ky * g.w + kx) * g.c + ch;
      tab_yx[k] = (ky << 16) | kx;
    }
    __syncthreads();
  }

  // this thread's A granule: tile row ar, bytes [16 ah, 16 ah + 16)
  const int ar = tid >> 1, ah = tid & 1;
  const long long am = m0 + ar;
  const bool a_row = am < g.m;
  int img = 0, iy0 = 0, ix0 = 0;
  if (a_row) {
    const int hw = g.out_h * g.out_w;
    img = (int)(am / hw);
    const int rem = (int)(am - (long long)img * hw);
    const int oy = rem / g.out_w, ox = rem - oy * g.out_w;
    iy0 = oy * g.sh - g.pt;
    ix0 = ox * g.sw - g.pl;
  }
  const int8_t* x_img = x + (long long)img * g.h * g.w * g.c + grp * g.cg;
  // this thread's B granule (threads 0..127): channel row br, bytes 16 bh
  const int br = (tid & 127) >> 1, bh = tid & 1;
  const bool b_row = tid < 2 * kBN && n0 + br < g.ng;
  const int8_t* w_row = w + (long long)(grp * g.ng + n0 + br) * g.k;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    uint8_t* a_dst = &sa[stage][ar * kRow + ah * 16];
    uint8_t* b_dst = &sb[stage][br * kRow + bh * 16];
    if constexpr (kVector) {
      const int ka = k0 + ah * 16;
      const void* src = x;
      int bytes = 0;
      if (a_row && ka < g.k) {
        const int tap = ka / g.cg, ch = ka - tap * g.cg;
        const int ky = tap / g.kw, kx = tap - ky * g.kw;
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
          src = x_img + ((long long)iy * g.w + ix) * g.c + ch;
          bytes = 16;
        }
      }
      cp_async16(smem_addr(a_dst), src, bytes);
      if (tid < 2 * kBN) {
        const int kb = k0 + bh * 16;
        const bool ok = b_row && kb < g.k;
        cp_async16(smem_addr(b_dst), ok ? (const void*)(w_row + kb) : w,
                   ok ? 16 : 0);
      }
    } else {
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (a_row) {
        const long long base = ((long long)iy0 * g.w + ix0) * g.c;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = k0 + ah * 16 + j;
          if (k < g.k) {
            const int yx = tab_yx[k];
            const int iy = iy0 + (yx >> 16), ix = ix0 + (yx & 0xffff);
            if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
              const uint32_t v = (uint8_t)x_img[base + tab_off[k]];
              words[j >> 2] |= v << (8 * (j & 3));
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(a_dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
      if (tid < 2 * kBN) {
        uint32_t wb[4] = {0u, 0u, 0u, 0u};
        if (b_row) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int k = k0 + bh * 16 + j;
            if (k < g.k) wb[j >> 2] |= (uint32_t)(uint8_t)w_row[k] << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(b_dst) = make_uint4(wb[0], wb[1], wb[2], wb[3]);
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();
    const uint8_t* a = sa[kt % kStages];
    const uint8_t* b = sb[kt % kStages];
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = a + (wm * 32 + i * 16 + gid) * kRow + tig * 4;
      af[i][0] = lds32(r0);
      af[i][1] = lds32(r0 + 8 * kRow);
      af[i][2] = lds32(r0 + 16);
      af[i][3] = lds32(r0 + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* r0 = b + (wn * 32 + j * 8 + gid) * kRow + tig * 4;
      bf[j][0] = lds32(r0);
      bf[j][1] = lds32(r0 + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // epilogue: rows gid and gid + 8 of each m16 tile, columns 2 tig, +1
  const int hw = g.out_h * g.out_w;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 32 + i * 16 + half * 8 + gid;
      if (m >= g.m) continue;
      const float xs = sx[m / hw];
      Out* row = out + m * g.o + (long long)grp * g.ng;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (n < g.ng) {
            const float v = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), xs),
                sw[grp * g.ng + n]);
            store(row + n, v);
          }
        }
      }
    }
  }
}

template <typename Out>
int launch(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
           Out* out, const Geometry& g, cudaStream_t s) {
  const bool vector = g.cg % 16 == 0 && g.c % 16 == 0;
  const int nk = (g.k + kBK - 1) / kBK;
  if (!vector && nk * kBK > kGatherK) return (int)cudaErrorInvalidValue;
  const long long blocks_m = (g.m + kBM - 1) / kBM;
  if (blocks_m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_m, (g.ng + kBN - 1) / kBN, g.groups);
  if (vector)
    int8_conv_kernel<Out, true><<<grid, kThreads, 0, s>>>(x, w, sx, sw, out, g);
  else
    int8_conv_kernel<Out, false><<<grid, kThreads, 0, s>>>(x, w, sx, sw, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x [batch, h, w, c] int8 (NHWC), wq [o, kh, kw, c / groups] int8, sx
// [batch] and sw [o] fp32, out [batch, out_h, out_w, o] in bf16 when
// out_bf16 else fp32; zero padding pad_t rows on top and pad_l columns on
// the left (the bottom and right follow from out_h and out_w).
extern "C" int salt_int8_conv(const void* x, const void* wq, const void* sx,
                              const void* sw, void* out, int batch, int h,
                              int w, int c, int out_h, int out_w, int o,
                              int kh, int kw, int stride_h, int stride_w,
                              int pad_t, int pad_l, int groups, int out_bf16,
                              void* stream) {
  if (batch <= 0 || out_h <= 0 || out_w <= 0 || o <= 0) return 0;
  if (groups <= 0 || c % groups || o % groups || kh <= 0 || kw <= 0 ||
      stride_h <= 0 || stride_w <= 0 || groups > 65535 || kh > 255 ||
      kw > 255)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.batch = batch; g.h = h; g.w = w; g.c = c; g.out_h = out_h;
  g.out_w = out_w; g.o = o; g.kh = kh; g.kw = kw; g.sh = stride_h;
  g.sw = stride_w; g.pt = pad_t; g.pl = pad_l; g.groups = groups;
  g.cg = c / groups; g.ng = o / groups; g.k = kh * kw * g.cg;
  g.m = (long long)batch * out_h * out_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xx = static_cast<const int8_t*>(x);
  const int8_t* ww = static_cast<const int8_t*>(wq);
  const float* sxx = static_cast<const float*>(sx);
  const float* sww = static_cast<const float*>(sw);
  if (out_bf16)
    return launch(xx, ww, sxx, sww, static_cast<__nv_bfloat16*>(out), g, s);
  return launch(xx, ww, sxx, sww, static_cast<float*>(out), g, s);
}
