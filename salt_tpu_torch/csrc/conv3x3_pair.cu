// 3x3 stride-1 convolution C -> 64, bf16 in and out, fp32 accumulation,
// for the H100 (sm_90a); plain C interface loaded with ctypes by
// salt_tpu_torch/ops/conv_kernel.py. The PTX wrappers and the tensor-map
// encoder are in sm90.cuh.
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
// that bound if the input streams from device memory while the tensor
// cores stay busy, so loads, products and stores all run asynchronously.
//
// The design: an implicit GEMM, M = B*H*W output pixels, N = 64, K = 9*C,
// with neither the padded input nor an im2col matrix in device memory.
// - Persistent blocks, one per SM, walk tiles of R = 4 output rows x 64
//   pixels in a grid-stride loop. A block is two consumer warpgroups, each
//   owning 2 output rows (two wgmma m64n64k16 accumulators, 64 fp32
//   registers a thread), and one producer warp that issues every load.
// - Channels go in chunks of 64 (128 bytes a pixel). The tensor maps' out
//   of bounds boxes fill zeros: the SAME padding, the image's ragged edges
//   and, for C < 64, the missing channels cost no branch, so one code path
//   serves every C % 16 == 0; for C > 64 the chunks stream.
// - The input slab of a (tile, chunk) step is (R+2) x 66 pixels x 64
//   channels (50.7 KB), one TMA box of a 4-D map over NHWC, in the 128-byte
//   swizzle. Two slabs form a ring under full / empty mbarriers: the
//   producer refills a slab as soon as both warpgroups have released it,
//   so step s+1's slab loads while step s computes, as the Pallas kernel's
//   two DMA slots do. Each tile reads (R+2)/R = 1.5 input rows per output
//   row and 66/64 pixels per pixel.
// - The chunk's weights sit in shared memory as nine [64 f][64 c] TMA boxes
//   in the 128-byte swizzle that the wgmma B descriptor reads (K-major, SBO
//   1024 B, a k-step is +32 bytes of start address inside the swizzle
//   atom). At C <= 64 they load once per block (73.7 KB), not per tile.
// - A comes from the slab into registers by ldmatrix.x4: the tap's (ky, kx)
//   shift only moves the row address, so no descriptor starts inside a
//   swizzle atom. One load of slab row sr at shift kx serves both output
//   rows of the warpgroup (ky = sr and sr - 1): 12 A loads for 18 taps. The
//   products of one load are one wgmma group; the next load's fragments
//   are read while it runs (two register sets, wait_group 1).
// - Epilogue: fp32 -> bf16 (round to nearest even) into a swizzled staging
//   tile per output row, then one TMA store per row (out of bounds pixels
//   and rows are dropped), which drains while the next tile computes.
// Shared memory: 73,728 (weights) + 2 x 51,200 (slabs, 1024-aligned) +
// 32,768 (staging) + 48 (barriers) + 1,024 (alignment) = 209,968 bytes.
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int kF = 64;                       // output channels
constexpr int kR = 4;                        // output rows per tile
constexpr int kRW = 2;                       // output rows per warpgroup
constexpr int kTileW = 64;                   // output pixels per tile row
constexpr int kKC = 64;                      // channels per chunk
constexpr int kConsumers = 128 * (kR / kRW); // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kSlabRows = kR + 2;
constexpr int kSlabW = kTileW + 2;
constexpr int kPix = kKC * 2;                // 128 bytes a slab pixel
constexpr int kTapBytes = kF * kPix;         // one tap's [64][64] B tile
constexpr int kWBytes = 9 * kTapBytes;       // 73,728
constexpr int kSlabBytes = kSlabRows * kSlabW * kPix;   // 50,688
constexpr int kSlabStride = (kSlabBytes + 1023) / 1024 * 1024;
constexpr int kStageBytes = kTileW * kF * 2;            // 8,192 per row
constexpr int kBarOffset = kWBytes + 2 * kSlabStride + kR * kStageBytes;
constexpr int kSmemBytes = kBarOffset + 6 * 8 + 1024;

using namespace sm90;

struct Geometry {
  int out_h, pad, tiles_w, tiles_h, n_tiles, n_chunks;
};

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_pair_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_y, Geometry g) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte
  // alignment
  const uint32_t base =
      smem_addr(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ws = base;
  const uint32_t slabs = ws + kWBytes;
  const uint32_t stages = slabs + 2 * kSlabStride;
  const uint32_t bars = base + kBarOffset;
  const uint32_t full0 = bars, empty0 = bars + 16, wfull = bars + 32,
                 wempty = bars + 40;         // full / empty: 2 slots, 8 B

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers);
    }
    mbar_init(wfull, 1);
    mbar_init(wempty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                           // the last block-wide barrier

  const int n_steps =
      (g.n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) -
       1) / static_cast<int>(gridDim.x) * g.n_chunks;

  if (tid >= kConsumers) {
    // producer: one thread issues every load
    if (tid != kConsumers) return;
    for (int s = 0; s < n_steps; ++s) {
      const int slot = s & 1;
      const int use = s >> 1;
      const int tile = blockIdx.x + (s / g.n_chunks) * gridDim.x;
      const int c0 = (s % g.n_chunks) * kKC;
      const int tw = tile % g.tiles_w;
      const int th = (tile / g.tiles_w) % g.tiles_h;
      const int b = tile / (g.tiles_w * g.tiles_h);
      mbar_wait(empty0 + 8 * slot, (use & 1) ^ 1);  // both warpgroups done
      mbar_expect_tx(full0 + 8 * slot, kSlabBytes);
      tma_load_4d(slabs + slot * kSlabStride, &tm_x, c0, tw * kTileW - g.pad,
                  th * kR - g.pad, b, full0 + 8 * slot);
      if (g.n_chunks > 1 || s == 0) {
        if (g.n_chunks > 1) mbar_wait(wempty, (s & 1) ^ 1);
        mbar_expect_tx(wfull, kWBytes);
        for (int t = 0; t < 9; ++t)
          tma_load_3d(ws + t * kTapBytes, &tm_w, c0, t, 0, wfull);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows 2 wg, 2 wg + 1 of a tile
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  // this lane's ldmatrix row: matrix j = lane / 8 holds pixels
  // (j & 1) * 8 .. + 7 of the warp's 16 and channel piece j >> 1 of a k-step
  const int a_pix = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_piece = lane >> 4;

  float acc[kRW][32];
  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    const int chunk = s % g.n_chunks;
    const int tile = blockIdx.x + (s / g.n_chunks) * gridDim.x;
    mbar_wait(full0 + 8 * slot, (s >> 1) & 1);
    mbar_wait(wfull, g.n_chunks > 1 ? (s & 1) : 0);

    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kRW; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    }
    const uint32_t slab = slabs + slot * kSlabStride;
    // slab row sr at shift kx: its fragments serve output row j of the
    // warpgroup at ky = sr - j
    uint32_t a[2][4][4];
    auto load_a = [&](int it, uint32_t (*dst)[4]) {
      const int p = (wg * kRW + it / 3) * kSlabW + a_pix + it % 3;
      const uint32_t row = slab + p * kPix;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int piece = kk * 2 + a_piece;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(dst[kk][0]), "=r"(dst[kk][1]), "=r"(dst[kk][2]),
              "=r"(dst[kk][3])
            : "r"(row + ((piece ^ (p & 7)) << 4)));
      }
    };
    constexpr int kLoads = (kRW + 2) * 3;
    load_a(0, a[0]);
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int sr = it / 3;
      const int kx = it % 3;
#pragma unroll
      for (int j = 0; j < kRW; ++j) fence_operand(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kRW; ++j) {
        const int ky = sr - j;
        if (ky >= 0 && ky < 3) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs(acc[j], a[it & 1][kk],
                     b_desc(ws + (ky * 3 + kx) * kTapBytes + kk * 32));
        }
      }
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < kRW; ++j) fence_operand(acc[j]);
      if (it + 1 < kLoads) {
        wgmma_wait<1>();                     // it - 1 is done with its A
        load_a(it + 1, a[(it + 1) & 1]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kRW; ++j) fence_operand(acc[j]);
    mbar_arrive(empty0 + 8 * slot);          // the slab is free
    if (g.n_chunks > 1) mbar_arrive(wempty);

    if (chunk == g.n_chunks - 1) {
      // epilogue: accumulator element (pixel p, output f) -> staging row
      // p, piece f / 8 at (f / 8) ^ (p & 7) (TMA's 128-byte swizzle); one
      // thread stores each row once the warpgroup has written it
      const int tw = tile % g.tiles_w;
      const int th = (tile / g.tiles_w) % g.tiles_h;
      const int b = tile / (g.tiles_w * g.tiles_h);
      const uint32_t stage = stages + wg * kRW * kStageBytes;
      if (wtid == 0)                         // the last stores have read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int r = warp * 16 + (lane >> 2);
      const int q = lane & 3;
#pragma unroll
      for (int jr = 0; jr < kRW; ++jr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = r + half * 8;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[jr][j * 4 + half * 2], acc[jr][j * 4 + half * 2 + 1]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             stage + jr * kStageBytes + p * 128 +
                             ((j ^ (p & 7)) << 4) + q * 4),
                         "r"(*reinterpret_cast<const uint32_t*>(&v))
                         : "memory");
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (wtid == 0) {
#pragma unroll
        for (int jr = 0; jr < kRW; ++jr)
          tma_store_4d(&tm_y, stage + jr * kStageBytes, 0, tw * kTileW,
                       th * kR + wg * kRW + jr, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// x: bf16 NHWC [batch, in_h, in_w, channels], in_h = out_h (SAME, zero pad
// 1) or out_h + 2 (halo, VALID), likewise in_w; w: bf16 [64, 3, 3,
// channels]; y: bf16 NHWC [batch, out_h, out_w, 64]. channels a multiple of
// 16; x, w and y 16-byte aligned and contiguous; y distinct from x.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error of the setup calls; never synchronizes.
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
  Geometry g;
  g.out_h = out_h;
  g.pad = dh == 2 ? 0 : 1;
  g.tiles_w = (out_w + kTileW - 1) / kTileW;
  g.tiles_h = (out_h + kR - 1) / kR;
  g.n_chunks = (channels + kKC - 1) / kKC;
  const long long tiles = static_cast<long long>(batch) * g.tiles_h * g.tiles_w;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  g.n_tiles = static_cast<int>(tiles);

  const uint64_t c2 = 2ull * channels;
  CUtensorMap tm_x, tm_w, tm_y;
  const uint64_t x_dims[4] = {static_cast<uint64_t>(channels),
                              static_cast<uint64_t>(in_w),
                              static_cast<uint64_t>(in_h),
                              static_cast<uint64_t>(batch)};
  const uint64_t x_strides[3] = {c2, c2 * in_w, c2 * in_w * in_h};
  const uint32_t x_box[4] = {kKC, kSlabW, kSlabRows, 1};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(channels), 9, kF};
  const uint64_t w_strides[2] = {c2, c2 * 9};
  const uint32_t w_box[3] = {kKC, 1, kF};
  const uint64_t y_dims[4] = {kF, static_cast<uint64_t>(out_w),
                              static_cast<uint64_t>(out_h),
                              static_cast<uint64_t>(batch)};
  const uint64_t y_strides[3] = {2ull * kF, 2ull * kF * out_w,
                                 2ull * kF * out_w * out_h};
  const uint32_t y_box[4] = {kF, kTileW, 1, 1};
  int rc = encode(&tm_x, x, 4, x_dims, x_strides, x_box);
  if (rc == 0) rc = encode(&tm_w, w, 3, w_dims, w_strides, w_box);
  if (rc == 0) rc = encode(&tm_y, y, 4, y_dims, y_strides, y_box);
  if (rc != 0) return rc;

  // the shared-memory opt-in and the SM count, once per device
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    err = cudaFuncSetAttribute(conv3x3_pair_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const int grid = g.n_tiles < sms ? g.n_tiles : sms;
  conv3x3_pair_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(tm_x, tm_w, tm_y,
                                                             g);
  return static_cast<int>(cudaGetLastError());
}
