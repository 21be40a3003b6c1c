// SAME-padded 3x3 stride-1 s8 x s8 -> s32 convolution with the
// dequantization in the epilogue, TMA + wgmma, for the H100 (sm_90a);
// plain C interface loaded with ctypes by salt_tpu_torch/ops/int8_conv.py.
// PTX wrappers and the tensor-map encoder: sm90.cuh.
//
// No TPU kernel: the JAX package's int8 convs are AQT's XLA convolution
// (salt_tpu/models/quant.py:24-34). This one takes the convs of that route
// that are 3x3, stride 1, padding 1, groups 1 with C_in a multiple of 64
// (ops/int8_conv.py::conv_path; 49 of the 57 of a UNetResNet-34 int8
// forward, 94% of its operations); int8_conv.cu takes the rest. It
// computes what int8_conv.cu and the plain version compute:
//   out[b, y, x, o] = D((float(acc) * sx[b]) * sw[o]),
//   acc = sum over (ky, kx, c) of xq[b, y + ky - 1, x + kx - 1, c]
//         * wq[o, ky, kx, c]                    (exact in s32)
// with the input NHWC int8 [B, H, W, C], zero outside the image, the
// weight [O, 3, 3, C] int8 (K-major: the layout quantize_weight leaves),
// the output NHWC in D = bf16 or fp32, the two fp32 products with
// __fmul_rn, rounded to D once: bit for bit the plain version.
//
// What bounds it. Over the 49 convs of a forward at 128 images it does
// 2,344 GOP (1.18 ms at 1,979 TOP/s) and moves the int8 input once and
// the bf16 output once; the output is the larger stream (at [64,128,128]
// -> 64, 268 MB written against 134 MB read), and the 128^2 and 64^2
// convs are bound by their bytes, the 8^2 to 32^2 ones by their
// operations. int8_conv.cu's mma.sync design ran at 5-11% of the int8
// peak on these convs: it read each input pixel nine times from L2 (once
// a tap) through 16-byte cp.async and 32-bit fragment loads, and wrote its
// output as scattered scalars.
//
// The design, conv_valid.cu's with SAME padding, the dequantization and
// tiles for the layers' maps:
// - Persistent blocks, one per SM, walk tiles of 256 output pixels x NT
//   output channels, the NT blocks of one pixel tile next to each other.
//   NT is 128 where O is a multiple of 128 and those tiles fill more than
//   half the SMs, else 64 (an 8x8 map at 48 images: 48 tiles of NT 128,
//   96 of 64); weight rows past O load as zeros and their outputs are
//   never stored. A tile is tile_b images
//   x tile_h rows x tile_w columns (ops/int8_conv.py::wgmma_tile: 4 x 64
//   at 128^2 and 64^2, 8 x 32 at 32^2, a whole 16^2 image, four whole 8^2
//   images), so small maps waste no pixels. Two consumer warpgroups own
//   two m64 units of it each (64 pixels: whole tile rows of one image);
//   one thread of a producer warpgroup issues every load; setmaxnreg moves
//   registers from the producer warpgroup to the consumers.
// - Channels go in chunks of KC = 128 (C a multiple of 128) or 64. A
//   (tile, chunk) step's input is one TMA box of tile_b x (tile_h + 2) x
//   (tile_w + 2) pixels x KC channels of a 4-D map over the NHWC input,
//   starting a row and a column before the tile: TMA's zero fill of what
//   lies outside the image is the SAME padding, with no padded copy and no
//   branch. Two slabs form a ring under full / empty mbarriers. A tap's
//   shift moves the slab row address only, so each input pixel is read
//   (tile_h + 2) / tile_h times, not 9.
// - A comes from the slab by ldmatrix.x4 (an s8 k32 fragment is the bytes
//   of a bf16 k16 one). The slab is in TMA's 128-byte swizzle at KC 128
//   (a pixel is one 128-byte row) and its 64-byte swizzle at KC 64 (a
//   pixel is 64 bytes; the 16-byte piece index XORs with bits 7-8 of the
//   byte offset), so the eight rows an ldmatrix reads hit distinct banks.
// - B is a [NT rows][KC k] box of wq per (tap, chunk), taken as it lies
//   (wgmma takes 8-bit B K-major only, which is wq's layout): a ring of 80
//   KB under full / empty mbarriers, in the slab's swizzle, read by
//   wgmma m64nNTk32 s8 with a descriptor, a k32 step 32 bytes on.
// - Epilogue: s32 -> fp32, times sx of the unit's image and sw of the
//   channel (two __fmul_rn), rounded to D, stored into a swizzled staging
//   buffer per warpgroup (16 KB: 64 pixels x 128 bf16 or 64 fp32
//   channels) and written by TMA stores of 128-byte lines, pixels past W,
//   H, B and channels past O dropped by TMA, draining while the next tile
//   computes.
// Shared memory: 2 x 55,296 (slabs, at most 432 pixels of 128 bytes) +
// 81,920 (weights) + 2 x 16,384 (staging) + barriers + 1,024 (alignment)
// <= 226,656 B.
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kTilePixels = 256;
constexpr int kUW = 2;                       // m64 units a warpgroup
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kConsumerRegs = 232;           // as in conv_valid.cu
constexpr int kProducerRegs = 40;
constexpr int kTaps = 9;
constexpr int kSlabStride = 55296;           // a slab, 1024-aligned
constexpr int kRingBytes = 81920;            // the weight ring
constexpr int kStageBytes = 16384;           // a warpgroup's staging
constexpr int kAtomBytes = 64 * 128;         // 64 pixels x 128 bytes

template <int KC, int NT, typename Out>
struct Cfg {
  static constexpr int kSteps = KC / 32;                  // k32 steps a tap
  static constexpr int kTapBytes = NT * KC;               // a (tap, chunk)
  static constexpr int kWSlots = kRingBytes / kTapBytes;
  static constexpr int kAcc = NT / 2;                     // a thread's, a unit
  static constexpr int kAtomCh = 128 / static_cast<int>(sizeof(Out));
  static constexpr int kStageCh = kStageBytes / (64 * static_cast<int>(sizeof(Out)));
  static constexpr int kPassCh = NT < kStageCh ? NT : kStageCh;  // a pass
  static constexpr int kPasses = NT / kPassCh;
  static constexpr int kPassAtoms = kPassCh / kAtomCh;
  static constexpr int kWOff = 2 * kSlabStride;
  static constexpr int kStageOff = kWOff + kRingBytes;
  static constexpr int kBarOff = kStageOff + 2 * kStageBytes;
  static constexpr int kSmemBytes = kBarOff + (4 + 2 * kWSlots) * 8 + 1024;
  static_assert(kPassAtoms >= 1 && kPasses * kPassCh == NT, "passes");
};

struct Geometry {
  int batch, h, w, c, o;
  int tile_w, tile_h, tile_b;                // tile_b x tile_h x tile_w = 256
  int tiles_w, tiles_h, n_fb, n_tiles, n_chunks;
  uint32_t slab_bytes;
};

struct Tile {
  int fb, x0, y0, b0;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int tile) {
  const int t = tile / g.n_fb;
  return {tile % g.n_fb, (t % g.tiles_w) * g.tile_w,
          ((t / g.tiles_w) % g.tiles_h) * g.tile_h,
          t / (g.tiles_w * g.tiles_h) * g.tile_b};
}

// two neighbouring channels of a pixel into the staging buffer
__device__ __forceinline__ void st_pair(uint32_t addr, float v0, float v1,
                                        const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&h))
               : "memory");
}
__device__ __forceinline__ void st_pair(uint32_t addr, float v0, float v1,
                                        const float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v0),
               "f"(v1)
               : "memory");
}

__device__ __forceinline__ float dequant(int32_t acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

template <int KC, int NT, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_y,
                       const float* __restrict__ sx,
                       const float* __restrict__ sw, Geometry g) {
  using C = Cfg<KC, NT, Out>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's swizzles and the wgmma descriptors need 1024-byte alignment
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
    // producer: one thread issues every load, in the order of use
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid != kConsumers) return;
    for (int s = 0; s < n_steps; ++s) {
      const int slot = s & 1;
      const int chunk = s % g.n_chunks;
      const Tile t = tile_of(g, blockIdx.x + (s / g.n_chunks) * gridDim.x);
      mbar_wait(sempty + 8 * slot, ((s >> 1) & 1) ^ 1);  // both released
      mbar_expect_tx(sfull + 8 * slot, g.slab_bytes);
      // a row and a column before the tile: the zero fill is the padding
      tma_load_4d(slabs + slot * kSlabStride, &tm_x, chunk * KC, t.x0 - 1,
                  t.y0 - 1, t.b0, sfull + 8 * slot);
      for (int tap = 0; tap < kTaps; ++tap) {
        const uint32_t dst = ring + wslot * C::kTapBytes;
        mbar_wait(wempty + 8 * wslot, wphase ^ 1);
        mbar_expect_tx(wfull + 8 * wslot, C::kTapBytes);
        tma_load_2d(dst, &tm_w, tap * g.c + chunk * KC, t.fb * NT,
                    wfull + 8 * wslot);
        if (++wslot == C::kWSlots) {
          wslot = 0;
          wphase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns units kUW wg .. kUW wg + kUW - 1 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int row_pixels = g.tile_w + 2;       // a slab row
  const int image_pixels = g.tile_w * g.tile_h;
  // this lane's ldmatrix row: matrix j = lane / 8 holds pixels
  // (j & 1) * 8 .. + 7 of the warp's 16 and 16-byte piece j >> 1 of a
  // k step's 32 bytes; a_base[u] is that pixel's slab pixel at tap (0, 0)
  // in unit u of the warpgroup
  const int a_pix = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_piece = lane >> 4;
  int a_base[kUW];
#pragma unroll
  for (int j = 0; j < kUW; ++j) {
    const int m = (wg * kUW + j) * 64 + a_pix;
    const int x = m % g.tile_w, r = (m / g.tile_w) % g.tile_h;
    a_base[j] = ((m / image_pixels) * (g.tile_h + 2) + r) * row_pixels + x;
  }

  int32_t acc[kUW][C::kAcc];
  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    const int chunk = s % g.n_chunks;
    mbar_wait(sfull + 8 * slot, (s >> 1) & 1);
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kUW; ++j)
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) acc[j][i] = 0;
    }
    const uint32_t slab = slabs + slot * kSlabStride;
    // unit u: the warpgroup's unit u % kUW at tap u / kUW (ky-major)
    uint32_t a[2][C::kSteps][4];
    auto load_a = [&](int u, uint32_t (*dst)[4]) {
      const int tap = u / kUW;
      const int p = a_base[u % kUW] + (tap / 3) * row_pixels + tap % 3;
      const uint32_t row = slab + p * KC;
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        const int piece = kk * 2 + a_piece;
        const int swz = KC == 128 ? piece ^ (p & 7) : piece ^ ((p >> 1) & 3);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(dst[kk][0]), "=r"(dst[kk][1]), "=r"(dst[kk][2]),
              "=r"(dst[kk][3])
            : "r"(row + (swz << 4)));
      }
    };
    constexpr int kUnits = kTaps * kUW;
    int rslot = wslot;                       // the next tap to release
    load_a(0, a[0]);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int j = u % kUW;
      if (j == 0) mbar_wait(wfull + 8 * wslot, wphase);  // the tap landed
      const uint32_t w = ring + wslot * C::kTapBytes;
#pragma unroll
      for (int i = 0; i < kUW; ++i) fence_operand<C::kAcc>(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk)
        wgmma_rs_s8<NT>(acc[j], a[u & 1][kk],
                        KC == 128 ? b_desc(w + kk * 32)
                                  : b_desc64(w + kk * 32));
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < kUW; ++i) fence_operand<C::kAcc>(acc[i]);
      if (j == kUW - 1 && ++wslot == C::kWSlots) {
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
    for (int i = 0; i < kUW; ++i) fence_operand<C::kAcc>(acc[i]);
    mbar_arrive(wempty + 8 * rslot);         // the step's last tap
    mbar_arrive(sempty + 8 * slot);          // the slab is free

    if (chunk == g.n_chunks - 1) {
      // epilogue, a unit and a pass of kPassCh channels at a time:
      // accumulator element (pixel p, channel f) -> staging atom
      // f / kAtomCh, row p, byte (f % kAtomCh) * sizeof(Out) with its
      // 16-byte piece XORed with p & 7 (TMA's 128-byte swizzle); one
      // thread stores the atoms once the warpgroup has written them
      const Tile t = tile_of(g, blockIdx.x + (s / g.n_chunks) * gridDim.x);
      const uint32_t stage = stages + wg * kStageBytes;
      const int gid = lane >> 2, tig = lane & 3;
      const int p0 = warp * 16 + gid;        // pixels p0, p0 + 8 of a unit
#pragma unroll
      for (int j = 0; j < kUW; ++j) {
        const int m0 = (wg * kUW + j) * 64;  // the unit's first pixel
        const int b = t.b0 + m0 / image_pixels;
        const int y = t.y0 + (m0 / g.tile_w) % g.tile_h;
        const float xs = sx[b < g.batch ? b : g.batch - 1];
        const bool live = b < g.batch && y < g.h;
#pragma unroll
        for (int pass = 0; pass < C::kPasses; ++pass) {
          if (wtid == 0)                     // the last store has read it
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
          for (int jn = 0; jn < C::kPassCh / 8; ++jn) {
            const int nj = pass * (C::kPassCh / 8) + jn;  // n8 group of NT
            const int f = jn * 8 + 2 * tig;               // in the pass
            const int o = t.fb * NT + nj * 8 + 2 * tig;
            const float w0 = o < g.o ? sw[o] : 0.f;
            const float w1 = o + 1 < g.o ? sw[o + 1] : 0.f;
            const int byte = (f % C::kAtomCh) * static_cast<int>(sizeof(Out));
            const uint32_t atom = stage + (f / C::kAtomCh) * kAtomBytes;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int p = p0 + half * 8;
              st_pair(atom + p * 128 +
                          ((((byte >> 4) ^ (p & 7)) << 4) | (byte & 15)),
                      dequant(acc[j][nj * 4 + half * 2], xs, w0),
                      dequant(acc[j][nj * 4 + half * 2 + 1], xs, w1),
                      static_cast<const Out*>(nullptr));
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
          if (wtid == 0 && live) {
#pragma unroll
            for (int at = 0; at < C::kPassAtoms; ++at) {
              const int ch = t.fb * NT + pass * C::kPassCh + at * C::kAtomCh;
              if (ch < g.o)
                tma_store_4d(&tm_y, stage + at * kAtomBytes, ch, t.x0, y, b);
            }
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
        }
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the current device's SM count, once per device; -cudaError on failure
int sm_count() {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (device >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return sms_of[device];
}

// the shared-memory opt-in, once per device and kernel; one block an SM
template <int KC, int NT, typename Out>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
           const CUtensorMap& tm_y, const float* sx, const float* sw,
           const Geometry& g, int sms, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  constexpr int smem = Cfg<KC, NT, Out>::kSmemBytes;
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(int8_conv_wgmma_kernel<KC, NT, Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const int grid = g.n_tiles < sms ? g.n_tiles : sms;
  int8_conv_wgmma_kernel<KC, NT, Out><<<grid, kThreads, smem, stream>>>(
      tm_x, tm_w, tm_y, sx, sw, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int dispatch(int kc, int nt, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
             const CUtensorMap& tm_y, const float* sx, const float* sw,
             const Geometry& g, int sms, cudaStream_t s) {
  if (kc == 128)
    return nt == 128
               ? launch<128, 128, Out>(tm_x, tm_w, tm_y, sx, sw, g, sms, s)
               : launch<128, 64, Out>(tm_x, tm_w, tm_y, sx, sw, g, sms, s);
  return nt == 128 ? launch<64, 128, Out>(tm_x, tm_w, tm_y, sx, sw, g, sms, s)
                   : launch<64, 64, Out>(tm_x, tm_w, tm_y, sx, sw, g, sms, s);
}

bool power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// x [batch, h, w, c] int8 (NHWC), wq [o, 3, 3, c] int8, sx [batch] and
// sw [o] fp32, out [batch, h, w, o] in bf16 when out_bf16 else fp32: the
// 3x3 conv, stride 1, one row and column of zeros around the image. c a
// multiple of 64, o of 8; a tile of tile_b images x tile_h rows x tile_w
// columns (tile_w 8..64 and tile_h powers of two, 256 pixels, tile_h x
// tile_w a multiple of 64, a slab of at most 432 pixels); x, wq and out
// 16-byte aligned and contiguous, out distinct from x. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or the error of
// the setup calls; never synchronizes.
extern "C" int salt_int8_conv_wgmma(const void* x, const void* wq,
                                    const void* sx, const void* sw,
                                    void* out, int batch, int h, int w,
                                    int c, int o, int tile_w, int tile_h,
                                    int tile_b, int out_bf16, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || o <= 0) return 0;
  const int kc = c % 128 == 0 ? 128 : 64;
  const int image_pixels = tile_w * tile_h;
  if (c <= 0 || c % 64 || o % 8 || tile_w < 8 || tile_w > 64 ||
      !power_of_two(tile_w) || !power_of_two(tile_h) || tile_b <= 0 ||
      image_pixels * tile_b != kTilePixels || image_pixels % 64 ||
      static_cast<long long>(tile_b) * (tile_h + 2) * (tile_w + 2) * kc >
          kSlabStride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const long long pixel_tiles =
      static_cast<long long>((batch + tile_b - 1) / tile_b) *
      ((h + tile_h - 1) / tile_h) * ((w + tile_w - 1) / tile_w);
  // NT 128 where O allows it, unless its tiles would leave more than half
  // of the SMs idle (an 8x8 map at 48 images: 48 tiles of NT 128)
  const int nt = o % 128 == 0 && 2 * pixel_tiles * (o / 128) > sms ? 128 : 64;
  Geometry g;
  g.batch = batch; g.h = h; g.w = w; g.c = c; g.o = o;
  g.tile_w = tile_w; g.tile_h = tile_h; g.tile_b = tile_b;
  g.tiles_w = (w + tile_w - 1) / tile_w;
  g.tiles_h = (h + tile_h - 1) / tile_h;
  g.n_fb = (o + nt - 1) / nt;
  g.n_chunks = c / kc;
  g.slab_bytes = static_cast<uint32_t>(tile_b * (tile_h + 2) *
                                       (tile_w + 2) * kc);
  const long long tiles = pixel_tiles * g.n_fb;
  if (tiles > 0x7fffffffLL || 9LL * c > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  g.n_tiles = static_cast<int>(tiles);

  const CUtensorMapSwizzle swizzle =
      kc == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint64_t cb = static_cast<uint64_t>(c);
  const uint64_t x_dims[4] = {cb, static_cast<uint64_t>(w),
                              static_cast<uint64_t>(h),
                              static_cast<uint64_t>(batch)};
  const uint64_t x_strides[3] = {cb, cb * w, cb * w * h};
  const uint32_t x_box[4] = {static_cast<uint32_t>(kc),
                             static_cast<uint32_t>(tile_w + 2),
                             static_cast<uint32_t>(tile_h + 2),
                             static_cast<uint32_t>(tile_b)};
  const uint64_t w_dims[2] = {9 * cb, static_cast<uint64_t>(o)};
  const uint64_t w_strides[1] = {9 * cb};
  const uint32_t w_box[2] = {static_cast<uint32_t>(kc),
                             static_cast<uint32_t>(nt)};
  const uint64_t esize = out_bf16 ? 2 : 4;
  const uint64_t ob = esize * o;
  const uint64_t y_dims[4] = {static_cast<uint64_t>(o),
                              static_cast<uint64_t>(w),
                              static_cast<uint64_t>(h),
                              static_cast<uint64_t>(batch)};
  const uint64_t y_strides[3] = {ob, ob * w, ob * w * h};
  // a unit: 64 / tile_w whole rows of tile_w pixels, 128 bytes of channels
  const uint32_t y_box[4] = {static_cast<uint32_t>(128 / esize),
                             static_cast<uint32_t>(tile_w),
                             static_cast<uint32_t>(64 / tile_w), 1};
  CUtensorMap tm_x, tm_w, tm_y;
  int rc = encode(&tm_x, x, 4, x_dims, x_strides, x_box,
                  CU_TENSOR_MAP_DATA_TYPE_UINT8, swizzle);
  if (rc == 0)
    rc = encode(&tm_w, wq, 2, w_dims, w_strides, w_box,
                CU_TENSOR_MAP_DATA_TYPE_UINT8, swizzle);
  if (rc == 0)
    rc = encode(&tm_y, out, 4, y_dims, y_strides, y_box,
                out_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (rc != 0) return rc;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxx = static_cast<const float*>(sx);
  const float* sww = static_cast<const float*>(sw);
  if (out_bf16)
    return dispatch<__nv_bfloat16>(kc, nt, tm_x, tm_w, tm_y, sxx, sww, g, sms,
                                   s);
  return dispatch<float>(kc, nt, tm_x, tm_w, tm_y, sxx, sww, g, sms, s);
}
