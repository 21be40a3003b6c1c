// VALID 3 x KW convolution (KW 2 or 3) over NHWC bf16 or int8, C -> F,
// fp32 (s32) accumulation and one rounding to bf16, for the H100
// (sm_90a); plain C interface loaded with ctypes by
// salt_tpu_torch/ops/conv_valid.py for conv128_kernel.py and
// conv64p_kernel.py. PTX wrappers and the tensor-map encoder: sm90.cuh.
//
// y[b,h,w,f] = sum_{ky<3, kx<KW, c<C} x[b,h+ky,w+kx,c] * wf[(ky*KW+kx)*C+c, f]
// for h < out_h, w < out_w; x is read at columns < out_w + KW - 1 of rows
// `row_pixels` pixels long, and nothing past them is loaded.
//
// Replaces three TPU probe kernels, which are this one function:
// - tools/pallas_conv.py:35-88 (make_conv128_kernel): KW 3, x [B][H+2][W+8]
//   [C], w_flat [9C][F]; columns W+2 .. W+7 are never read;
// - tools/pallas_conv.py:115-170 (make_conv64p_kernel): the pair-packed
//   conv is a VALID 3x2 conv 128 -> 128 over x_packed [B][H+2][(W+16)/2]
//   [128] (a packed column is a pixel pair's 2 x 64 channels): its K index
//   (ky*4 + px)*64 + ci is (ky*2 + q)*128 + c with q = px / 2. All 768
//   rows of w_packed are read, the slots pack_pair_weights leaves at zero
//   included;
// - tools/pallas_conv2.py:53-168 (make_conv64p_v2): the same pair-packed
//   conv; its `shift`, `dots` and `db` choose Mosaic's data movement, and
//   `int8` takes s8 operands (salt_conv_valid_s8, below), whose exact s32
//   sums (each below 768 * 128^2 < 2^24) convert to fp32 exactly before
//   the one rounding to bf16.
//
// What bounds it. At the probes' size (B 64, H = W = 128) row 4 moves
// 558.4 MB (0.167 ms at 3.35 TB/s) and does 309.2 GFLOP (0.313 ms at 989
// TFLOP/s), row 5 287.8 MB (0.086 ms) and 103.1 GFLOP (0.104 ms): the
// operations bound both, so the tensor cores have to be kept busy. Row 7
// in int8 moves 211.0 MB (0.063 ms) for 103.1 GOP (0.052 ms at 1,979
// TOP/s): the bytes bound it. The mma.sync implicit GEMM this one replaced also streamed every operand
// from L2 into shared memory once per 128 outputs, and each input pixel 9
// times (once per tap): 4.8 GB (row 4) and 1.6 GB (row 5) a call.
//
// The design, row 3's (conv3x3_pair.cu) with weights that stream:
// - Persistent blocks, one per SM, walk tiles of R = 4 output rows x 64
//   output pixels x NT output channels (NT 128, or 64 where F is not a
//   multiple of 128) in a grid-stride loop. The kernel picks this tile
//   itself; the TPU kernels' tile_h does not reach it. Two consumer
//   warpgroups own 2 output rows each (two wgmma m64nNTk16 accumulators,
//   NT fp32 registers a thread); one thread of a producer warpgroup issues
//   every load. setmaxnreg moves registers from the producer warpgroup to
//   the consumers (232 a thread): at 168, NT 128 spilled and ptxas
//   serialized the wgmma.
// - Channels go in chunks of 64. A (tile, chunk) step's input is one TMA
//   box of (R+2) x (64+KW-1) pixels x 64 channels of a 4-D map over NHWC
//   that declares the valid width out_w + KW - 1 (and the row stride
//   apart from it), in the 128-byte swizzle: columns past the valid width
//   are never loaded, and ragged edges read zeros and need no branch. Two
//   slabs form a ring under full / empty mbarriers, so step s+1's slab
//   loads while step s computes. Each input row is read (R+2)/R = 1.5
//   times per output row.
// - A comes from the slab by ldmatrix.x4: a tap's (ky, kx) shift moves the
//   row address only (the swizzle XOR taken of the shifted pixel index).
// - B is a [64 k][NT n] box of the weights per (tap, chunk), taken straight
//   from wf [K][F] (N contiguous): wgmma reads it MN-major (tnspB), 8-k-row
//   groups 1024 bytes apart, 64-wide n atoms 8 KB apart, so no transposed
//   copy of the weights exists. The boxes stream through a ring of 80 KB
//   (5 slots of 16 KB at NT 128) under full / empty mbarriers, once per
//   256 x NT outputs.
// - Fill a call at the probes' size, NT 128: row 4 4,096 tiles x (101 KB of
//   slab + 295 KB of weights) = 1.62 GB; row 5 2,048 x (100 + 197 KB) =
//   0.61 GB. On an H100 a variant that loaded the weights once per block
//   ran within 5% of this one, so the fill does not bound it, and the
//   weights are not multicast across a cluster (PERF.md).
// - Epilogue: fp32 -> bf16 (round to nearest even), stmatrix.x4 into a
//   swizzled staging row per warpgroup, one TMA store per 64 channels
//   (pixels and rows past out_w x out_h dropped), draining while the next
//   tile computes.
// Shared memory at NT 128, KW 3: 2 x 51,200 (slabs) + 81,920 (weights) +
// 2 x 16,384 (staging) + 112 (barriers) + 1,024 (alignment) = 218,224 B.
//
// int8 (kS8) is the same kernel byte for byte: a slab pixel is still 128
// bytes, now one chunk of 128 channels, so the TMA boxes, the swizzle, the
// ldmatrix A path and the tap shifts do not change (an s8 k32 A fragment
// is the bytes of a bf16 k16 one). wgmma takes 8-bit B K-major only, so
// the weights come as wt [F][K] (a K-major copy the wrapper makes): a
// (tap, chunk) box is NT rows of 128 k bytes, read by wgmma m64nNTk32 s8
// with b_desc, a k32 step 32 bytes on. Accumulators are s32 in the same
// registers.
#include <cuda_bf16.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kR = 4;                        // output rows per tile
constexpr int kRW = 2;                       // output rows per warpgroup
constexpr int kTileW = 64;                   // output pixels per tile row
constexpr int kConsumers = 128 * (kR / kRW); // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
// registers a thread after setmaxnreg: a warp of each warpgroup shares
// each quarter of the SM's register file, (2 x 232 + 40) x 32 <= 16,384
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kSlabRows = kR + 2;
constexpr int kPix = 128;                    // bytes a slab pixel
constexpr int kSlabStride = 51200;           // a slab, 1024-aligned
constexpr int kRingBytes = 81920;            // the weight ring
constexpr int kAtomBytes = 64 * kPix;        // [64 k][64 n] bf16 of a B box

template <int KW, int NT, bool kS8>
struct Cfg {
  using Acc = std::conditional_t<kS8, int32_t, float>;
  static constexpr int kKC = kS8 ? 128 : 64;          // channels a chunk
  static constexpr int kTaps = 3 * KW;
  static constexpr int kSlabW = kTileW + KW - 1;
  static constexpr int kSlabBytes = kSlabRows * kSlabW * kPix;
  static constexpr int kTapBytes = kPix * NT;         // one (tap, chunk)
  static constexpr int kWSlots = kRingBytes / kTapBytes;
  static constexpr int kStageBytes = kTileW * NT * 2; // one output row
  static constexpr int kAcc = NT / 2;                 // a thread's, a row
  static constexpr int kWOff = 2 * kSlabStride;
  static constexpr int kStageOff = kWOff + kRingBytes;
  static constexpr int kBarOff = kStageOff + 2 * kStageBytes;
  static constexpr int kSmemBytes = kBarOff + (4 + 2 * kWSlots) * 8 + 1024;
  static_assert(kSlabBytes <= kSlabStride, "slab");
};

struct Geometry {
  int tiles_w, tiles_h, n_fb, n_tiles, n_chunks, channels;
};

struct Tile {
  int fb, tw, th, b;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int tile) {
  const int t = tile / g.n_fb;
  return {tile % g.n_fb, t % g.tiles_w, (t / g.tiles_w) % g.tiles_h,
          t / (g.tiles_w * g.tiles_h)};
}

template <int KW, int NT, bool kS8>
__global__ void __launch_bounds__(kThreads, 1)
conv_valid_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_y, Geometry g) {
  using C = Cfg<KW, NT, kS8>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte
  // alignment
  const uint32_t base =
      smem_addr(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t slabs = base;
  const uint32_t ring = base + C::kWOff;
  const uint32_t stages = base + C::kStageOff;
  const uint32_t bars = base + C::kBarOff;
  // full / empty barriers, 8 bytes each: 2 slab slots, kWSlots weight slots
  const uint32_t sfull = bars, sempty = bars + 16, wfull = bars + 32,
                 wempty = wfull + 8 * C::kWSlots;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(sfull + 8 * i, 1);
      mbar_init(sempty + 8 * i, kConsumers);
    }
    for (int i = 0; i < C::kWSlots; ++i) {
      mbar_init(wfull + 8 * i, 1);
      mbar_init(wempty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                           // the last block-wide barrier

  const int n_steps =
      (g.n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) -
       1) / static_cast<int>(gridDim.x) * g.n_chunks;
  // the weight ring's position: producer and consumers both advance it by
  // kTaps a step
  int wslot = 0;
  uint32_t wphase = 0;

  if (tid >= kConsumers) {
    // producer: one thread issues every load, in the order of use; its
    // warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid != kConsumers) return;
    for (int s = 0; s < n_steps; ++s) {
      const int slot = s & 1;
      const int chunk = s % g.n_chunks;
      const Tile t = tile_of(g, blockIdx.x + (s / g.n_chunks) * gridDim.x);
      mbar_wait(sempty + 8 * slot, ((s >> 1) & 1) ^ 1);  // both released
      mbar_expect_tx(sfull + 8 * slot, C::kSlabBytes);
      tma_load_4d(slabs + slot * kSlabStride, &tm_x, chunk * C::kKC,
                  t.tw * kTileW, t.th * kR, t.b, sfull + 8 * slot);
      for (int tap = 0; tap < C::kTaps; ++tap) {
        const uint32_t dst = ring + wslot * C::kTapBytes;
        mbar_wait(wempty + 8 * wslot, wphase ^ 1);
        mbar_expect_tx(wfull + 8 * wslot, C::kTapBytes);
        const int k0 = tap * g.channels + chunk * C::kKC;
        if constexpr (kS8) {                 // NT rows of 128 k bytes
          tma_load_2d(dst, &tm_w, k0, t.fb * NT, wfull + 8 * wslot);
        } else {                             // NT / 64 [64 k][64 n] boxes
#pragma unroll
          for (int nb = 0; nb < NT / 64; ++nb)
            tma_load_2d(dst + nb * kAtomBytes, &tm_w, t.fb * NT + nb * 64,
                        k0, wfull + 8 * wslot);
        }
        if (++wslot == C::kWSlots) {
          wslot = 0;
          wphase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows 2 wg, 2 wg + 1 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  // this lane's ldmatrix row: matrix j = lane / 8 holds pixels
  // (j & 1) * 8 .. + 7 of the warp's 16 and 16-byte piece j >> 1 of a
  // k step's 32 bytes
  const int a_pix = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_piece = lane >> 4;

  typename C::Acc acc[kRW][C::kAcc];
  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    const int chunk = s % g.n_chunks;
    mbar_wait(sfull + 8 * slot, (s >> 1) & 1);
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kRW; ++j)
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) acc[j][i] = 0;
    }
    const uint32_t slab = slabs + slot * kSlabStride;
    // unit u: output row j = u % kRW of the warpgroup at tap u / kRW
    // (ky-major), reading slab row 2 wg + j + ky at shift kx
    uint32_t a[2][4][4];
    auto load_a = [&](int u, uint32_t (*dst)[4]) {
      const int tap = u / kRW;
      const int p = (wg * kRW + u % kRW + tap / KW) * C::kSlabW + a_pix +
                    tap % KW;
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
    constexpr int kUnits = C::kTaps * kRW;
    int rslot = wslot;                       // the next tap to release
    load_a(0, a[0]);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int j = u % kRW;
      if (j == 0) mbar_wait(wfull + 8 * wslot, wphase);  // the tap landed
      const uint32_t w = ring + wslot * C::kTapBytes;
#pragma unroll
      for (int i = 0; i < kRW; ++i) fence_operand<C::kAcc>(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kS8)
          wgmma_rs_s8<NT>(acc[j], a[u & 1][kk], b_desc(w + kk * 32));
        else
          wgmma_rs<NT, 1>(acc[j], a[u & 1][kk],
                          smem_desc(w + kk * 2048, kAtomBytes, 1024));
      }
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < kRW; ++i) fence_operand<C::kAcc>(acc[i]);
      if (j == kRW - 1 && ++wslot == C::kWSlots) {
        wslot = 0;
        wphase ^= 1;
      }
      if (u + 1 < kUnits) {
        wgmma_wait<1>();                     // unit u - 1 is done
        if (j == 0 && u > 0) {               // and with it the last tap
          mbar_arrive(wempty + 8 * rslot);
          if (++rslot == C::kWSlots) rslot = 0;
        }
        load_a(u + 1, a[(u + 1) & 1]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kRW; ++i) fence_operand<C::kAcc>(acc[i]);
    mbar_arrive(wempty + 8 * rslot);         // the step's last tap
    mbar_arrive(sempty + 8 * slot);          // the slab is free

    if (chunk == g.n_chunks - 1) {
      // epilogue, one output row at a time: accumulator element (pixel p,
      // channel f) -> staging atom f / 64, row p, piece (f % 64) / 8 at
      // ((f % 64) / 8) ^ (p & 7) (TMA's 128-byte swizzle), by stmatrix.x4:
      // four 8 x 8 matrices a warp (pixels +0 / +8 by channel groups j,
      // j + 1), lane l giving the address of row l % 8 of matrix l / 8;
      // one thread stores the row once the warpgroup has written it
      const Tile t = tile_of(g, blockIdx.x + (s / g.n_chunks) * gridDim.x);
      const uint32_t stage = stages + wg * C::kStageBytes;
      const int sp = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int sj = lane >> 4;
#pragma unroll
      for (int jr = 0; jr < kRW; ++jr) {
        if (wtid == 0)                       // the last store has read it
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int j = 0; j < NT / 8; j += 2) {
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
              "%4};\n" ::"r"(stage + (jj >> 3) * kAtomBytes + sp * 128 +
                              (((jj & 7) ^ (sp & 7)) << 4)),
              "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
              : "memory");
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (wtid == 0) {
#pragma unroll
          for (int nb = 0; nb < NT / 64; ++nb)
            tma_store_4d(&tm_y, stage + nb * kAtomBytes, t.fb * NT + nb * 64,
                         t.tw * kTileW, t.th * kR + wg * kRW + jr, t.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the shared-memory opt-in and the SM count, once per device and kernel
template <int KW, int NT, bool kS8>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
           const CUtensorMap& tm_y, const Geometry& g, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  constexpr int smem = Cfg<KW, NT, kS8>::kSmemBytes;
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    err = cudaFuncSetAttribute(conv_valid_kernel<KW, NT, kS8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const int grid = g.n_tiles < sms ? g.n_tiles : sms;
  conv_valid_kernel<KW, NT, kS8><<<grid, kThreads, smem, stream>>>(
      tm_x, tm_w, tm_y, g);
  return static_cast<int>(cudaGetLastError());
}

// checks, geometry and tensor maps of both entries; w is [K][F] in bf16,
// [F][K] in s8 (K = 3 kw channels)
template <bool kS8>
int run(const void* x, const void* w, void* y, int batch, int out_h,
        int out_w, int kw, int channels, int filters, int row_pixels,
        void* stream) {
  constexpr int kKC = Cfg<2, 64, kS8>::kKC;
  constexpr int kElem = kS8 ? 1 : 2;         // bytes an operand element
  if (batch <= 0) return 0;
  const int in_w = out_w + kw - 1;
  if (out_h <= 0 || out_w <= 0 || (kw != 2 && (kS8 || kw != 3)) ||
      channels <= 0 || channels % kKC != 0 || filters <= 0 ||
      filters % 64 != 0 || row_pixels < in_w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = filters % 128 == 0 ? 128 : 64;
  Geometry g;
  g.tiles_w = (out_w + kTileW - 1) / kTileW;
  g.tiles_h = (out_h + kR - 1) / kR;
  g.n_fb = filters / nt;
  g.n_chunks = channels / kKC;
  g.channels = channels;
  const long long tiles =
      static_cast<long long>(batch) * g.tiles_h * g.tiles_w * g.n_fb;
  if (tiles > 0x7fffffffLL || 3LL * kw * channels > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  g.n_tiles = static_cast<int>(tiles);

  const CUtensorMapDataType type = kS8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t cb = static_cast<uint64_t>(kElem) * channels;
  const uint64_t k = 3ull * kw * channels;
  const uint64_t in_h = static_cast<uint64_t>(out_h) + 2;
  CUtensorMap tm_x, tm_w, tm_y;
  const uint64_t x_dims[4] = {static_cast<uint64_t>(channels),
                              static_cast<uint64_t>(in_w), in_h,
                              static_cast<uint64_t>(batch)};
  const uint64_t x_strides[3] = {cb, cb * row_pixels, cb * row_pixels * in_h};
  const uint32_t x_box[4] = {kKC, static_cast<uint32_t>(kTileW + kw - 1),
                             kSlabRows, 1};
  // bf16 [K][F] in [64 k][64 n] boxes; s8 [F][K] in [NT n][128 k] boxes
  const uint64_t w_dims[2] = {kS8 ? k : static_cast<uint64_t>(filters),
                              kS8 ? static_cast<uint64_t>(filters) : k};
  const uint64_t w_strides[1] = {kS8 ? k : 2ull * filters};
  const uint32_t w_box[2] = {kS8 ? 128u : 64u,
                             kS8 ? static_cast<uint32_t>(nt) : 64u};
  const uint64_t y_dims[4] = {static_cast<uint64_t>(filters),
                              static_cast<uint64_t>(out_w),
                              static_cast<uint64_t>(out_h),
                              static_cast<uint64_t>(batch)};
  const uint64_t f2 = 2ull * filters;
  const uint64_t y_strides[3] = {f2, f2 * out_w, f2 * out_w * out_h};
  const uint32_t y_box[4] = {64, kTileW, 1, 1};
  int rc = encode(&tm_x, x, 4, x_dims, x_strides, x_box, type);
  if (rc == 0) rc = encode(&tm_w, w, 2, w_dims, w_strides, w_box, type);
  if (rc == 0) rc = encode(&tm_y, y, 4, y_dims, y_strides, y_box);
  if (rc != 0) return rc;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kS8) {
    return nt == 128 ? launch<2, 128, true>(tm_x, tm_w, tm_y, g, s)
                     : launch<2, 64, true>(tm_x, tm_w, tm_y, g, s);
  } else {
    if (kw == 3)
      return nt == 128 ? launch<3, 128, false>(tm_x, tm_w, tm_y, g, s)
                       : launch<3, 64, false>(tm_x, tm_w, tm_y, g, s);
    return nt == 128 ? launch<2, 128, false>(tm_x, tm_w, tm_y, g, s)
                     : launch<2, 64, false>(tm_x, tm_w, tm_y, g, s);
  }
}

}  // namespace

// x: bf16 [batch][out_h + 2][row_pixels][channels], read at columns <
// out_w + kw - 1 <= row_pixels; w: bf16 [3 kw channels][filters], K index
// (ky kw + kx) channels + c; y: bf16 [batch][out_h][out_w][filters]. kw 2
// or 3, channels and filters multiples of 64; x, w and y 16-byte aligned
// and contiguous, y distinct from x. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the setup calls;
// never synchronizes.
extern "C" int salt_conv_valid(const void* x, const void* w, void* y,
                               int batch, int out_h, int out_w, int kw,
                               int channels, int filters, int row_pixels,
                               void* stream) {
  return run<false>(x, w, y, batch, out_h, out_w, kw, channels, filters,
                    row_pixels, stream);
}

// The same conv over int8: x int8 [batch][out_h + 2][row_pixels][channels];
// wt int8 [filters][3 kw channels], the weights K-major (wt[f][k] =
// w[k][f]); y bf16 of the exact sums. kw 2 (the pair-packed conv, its one
// caller), channels a multiple of 128, filters of 64; otherwise as
// salt_conv_valid.
extern "C" int salt_conv_valid_s8(const void* x, const void* wt, void* y,
                                  int batch, int out_h, int out_w, int kw,
                                  int channels, int filters, int row_pixels,
                                  void* stream) {
  return run<true>(x, wt, y, batch, out_h, out_w, kw, channels, filters,
                   row_pixels, stream);
}
