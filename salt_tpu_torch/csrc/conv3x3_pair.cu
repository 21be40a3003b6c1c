// 3x3 stride-1 convolution C -> 64, bf16 in and out, fp32 accumulation,
// for the H100 (sm_90a); plain C interface loaded with ctypes by
// salt_tpu_torch/ops/conv_kernel.py.
//
// Replaces the TPU kernel salt_tpu/ops/pallas_conv.py:66-178 (_make_kernel,
// called through conv3x3_pair): y[b,h,w,f] = sum_{ky,kx,c}
// xp[b,h+ky,w+kx,c] * W[ky,kx,c,f], where xp is x zero-padded by one pixel
// on every side (SAME), or x itself when it already carries a 1-px ring
// (halo: VALID). Activations are NHWC bytes (the port's channels_last NCHW
// tensors); the weight comes repacked as [64][3][3][C].
//
// What bounds it. At the serve path's largest shape, x [48,128,128,64]:
// 2 * 48*128*128 * 64 * 576 = 57.98 GFLOP, 0.0586 ms at 989 TFLOP/s bf16;
// input and output 2 * 100.7 MB (the weight is 74 KB), 0.0601 ms at
// 3.35 TB/s. The two are within 3% of each other: the card can only reach
// that bound if the input is read from device memory once and the
// tensor cores are kept busy while it streams.
//
// The design. The Pallas kernel packs two output pixels across the 128
// lanes of the TPU's matrix unit (a 64-wide output half-fills it); that
// trick has no meaning here and is not carried over. What it keeps out of
// device memory is kept out here too: the padded input and any im2col
// matrix are never materialized. It is an implicit GEMM, M = B*H*W output
// pixels, N = 64, K = 9*C:
// - a block of 4 warps owns a tile of 2 output rows x 64 pixels (M = 128)
//   and all 64 outputs; blocks are persistent (two per SM) and walk the
//   tiles in a grid-stride loop;
// - per channel chunk of KC (64, 32 or 16) it stages the 4 x 66 pixel
//   input slab (rows and the halo ring) in shared memory, writing zeros
//   where the padding is, and the chunk's weights (64 x 9 x KC); at C = 64
//   there is one chunk, so the 73.7 KB of weights are staged once per
//   block, not once per tile;
// - each warp computes 32 pixels x 64 outputs with
//   mma.sync.m16n8k16 (bf16 x bf16 -> fp32) from fragments read out of
//   shared memory, with rows padded by 8 bf16 so that a fragment's 32
//   lanes hit 32 distinct banks;
// - the fp32 sums are rounded to bf16 (round to nearest even) and stored.
// The slab is 38 KB and the weights 74.8 KB at KC = 64, so two blocks
// share an SM and one's staging overlaps the other's products. There is
// no asynchronous copy pipeline, no wgmma and no TMA yet: this first cut
// is simple and right, and its time is in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 64;               // output channels
constexpr int kRows = 2;             // output rows per tile
constexpr int kTileW = 64;           // output pixels per row of a tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSlabRows = kRows + 2;
constexpr int kSlabW = kTileW + 2;
constexpr int kPadBf16 = 8;          // row padding: conflict-free fragments

template <int KC>
struct Geometry {
  static constexpr int kPixStride = KC + kPadBf16;           // slab pixel
  static constexpr int kWStride = 9 * KC + kPadBf16;         // weight row
  static constexpr int kSlabElems = kSlabRows * kSlabW * kPixStride;
  static constexpr int kWElems = kF * kWStride;
  static constexpr int kSmemBytes = (kSlabElems + kWElems) * 2;
};

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
conv3x3_pair_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int batch, int out_h,
                    int out_w, int channels, int in_h, int in_w, int pad) {
  using G = Geometry<KC>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = slab + G::kSlabElems;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;             // fragment row group
  const int q = lane & 3;              // fragment column pair
  const int wr = warp >> 1;            // the warp's output row in the tile
  const int wp = (warp & 1) * 32;      // the warp's first pixel in the row

  const int tiles_w = (out_w + kTileW - 1) / kTileW;
  const int tiles_h = (out_h + kRows - 1) / kRows;
  const int n_tiles = batch * tiles_h * tiles_w;
  const int n_chunks = channels / KC;
  constexpr int kVecPerPix = KC / 8;   // 16-byte vectors per pixel chunk

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tw = tile % tiles_w;
    const int th = (tile / tiles_w) % tiles_h;
    const int b = tile / (tiles_w * tiles_h);
    const int h0 = th * kRows;
    const int w0 = tw * kTileW;

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int c0 = chunk * KC;
      __syncthreads();   // the previous products are done with the slab
      // input slab: rows h0-pad .. h0-pad+3, pixels w0-pad .. w0-pad+65
      for (int v = threadIdx.x; v < kSlabRows * kSlabW * kVecPerPix;
           v += kThreads) {
        const int pix = v / kVecPerPix;
        const int cv = v % kVecPerPix;
        const int gh = h0 + pix / kSlabW - pad;
        const int gw = w0 + pix % kSlabW - pad;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gh >= 0 && gh < in_h && gw >= 0 && gw < in_w) {
          const size_t off =
              ((static_cast<size_t>(b) * in_h + gh) * in_w + gw) * channels +
              c0 + cv * 8;
          val = *reinterpret_cast<const uint4*>(x + off);
        }
        *reinterpret_cast<uint4*>(slab + pix * G::kPixStride + cv * 8) = val;
      }
      // the chunk's weights, staged once per block when there is one chunk
      if (n_chunks > 1 || tile == static_cast<int>(blockIdx.x)) {
        for (int v = threadIdx.x; v < kF * 9 * kVecPerPix; v += kThreads) {
          const int n = v / (9 * kVecPerPix);
          const int rem = v % (9 * kVecPerPix);
          const int tap = rem / kVecPerPix;
          const int cv = rem % kVecPerPix;
          const uint4 val = *reinterpret_cast<const uint4*>(
              w + (static_cast<size_t>(n) * 9 + tap) * channels + c0 + cv * 8);
          *reinterpret_cast<uint4*>(ws + n * G::kWStride + tap * KC + cv * 8) =
              val;
        }
      }
      __syncthreads();

#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap % 3;
        const __nv_bfloat16* arow =
            slab + ((wr + ky) * kSlabW + wp + kx) * G::kPixStride;
        const __nv_bfloat16* brow = ws + tap * KC;
#pragma unroll
        for (int cc = 0; cc < KC; cc += 16) {
          uint32_t bf[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const __nv_bfloat16* p = brow + (j * 8 + g) * G::kWStride + cc + q * 2;
            bf[j][0] = lds32(p);
            bf[j][1] = lds32(p + 8);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const __nv_bfloat16* p =
                arow + (i * 16 + g) * G::kPixStride + cc + q * 2;
            uint32_t af[4];
            af[0] = lds32(p);
            af[1] = lds32(p + 8 * G::kPixStride);
            af[2] = lds32(p + 8);
            af[3] = lds32(p + 8 * G::kPixStride + 8);
#pragma unroll
            for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[i][j], af, bf[j]);
          }
        }
      }
    }

    // epilogue: fp32 -> bf16 (round to nearest even), NHWC stores
    const int oh = h0 + wr;
    if (oh < out_h) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ow = w0 + wp + i * 16 + g + half * 8;
          if (ow < out_w) {
            __nv_bfloat16* dst =
                y + ((static_cast<size_t>(b) * out_h + oh) * out_w + ow) * kF +
                q * 2;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
                  __floats2bfloat162_rn(acc[i][j][half * 2],
                                        acc[i][j][half * 2 + 1]);
            }
          }
        }
      }
    }
  }
}

template <int KC>
int launch(const void* x, const void* w, void* y, int batch, int out_h,
           int out_w, int channels, int in_h, int in_w, int pad,
           cudaStream_t stream) {
  const int smem = Geometry<KC>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_pair_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(batch) *
                          ((out_h + kRows - 1) / kRows) *
                          ((out_w + kTileW - 1) / kTileW);
  const int grid = static_cast<int>(tiles < 2LL * sms ? tiles : 2LL * sms);
  conv3x3_pair_kernel<KC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), batch, out_h, out_w, channels, in_h, in_w,
      pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 NHWC [batch, in_h, in_w, channels], in_h = out_h (SAME, zero pad
// 1) or out_h + 2 (halo, VALID), likewise in_w; w: bf16 [64, 3, 3,
// channels]; y: bf16 NHWC [batch, out_h, out_w, 64]. channels a multiple of
// 16; x and w 16-byte aligned and contiguous; y distinct from x. Launches
// on `stream` and returns cudaGetLastError() (0 on success), or the error
// of the setup calls; never synchronizes.
extern "C" int salt_conv3x3_pair(const void* x, const void* w, void* y,
                                 int batch, int out_h, int out_w, int channels,
                                 int in_h, int in_w, void* stream) {
  if (batch <= 0) return 0;
  const int dh = in_h - out_h;
  const int dw = in_w - out_w;
  if (out_h <= 0 || out_w <= 0 || channels <= 0 || channels % 16 != 0 ||
      dh != dw || (dh != 0 && dh != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pad = dh == 2 ? 0 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 64 == 0)
    return launch<64>(x, w, y, batch, out_h, out_w, channels, in_h, in_w, pad, s);
  if (channels % 32 == 0)
    return launch<32>(x, w, y, batch, out_h, out_w, channels, in_h, in_w, pad, s);
  return launch<16>(x, w, y, batch, out_h, out_w, channels, in_h, in_w, pad, s);
}
