// Matmul [M, K] x [K, N], bf16 in and out, fp32 accumulation and one
// rounding to bf16, for the H100 (sm_90a); plain C interface loaded with
// ctypes by salt_tpu_torch/ops/matmul_kernel.py. PTX wrappers and the
// tensor-map encoder: sm90.cuh.
//
// Replaces the TPU probe kernel tools/pallas_conv.py:173-200
// (make_matmul_kernel): a grid over tile_m rows of a, the whole [K, N] of b
// resident, one fp32-accumulated dot per tile. tile_m is that kernel's
// contract (the wrapper checks M % tile_m) and does not reach this one,
// which picks its own tile.
//
// What bounds it. At the probe's shapes it moves 939.7 MB for 103.1 GFLOP
// (M 524,288, K 768, N 128: 0.281 ms at 3.35 TB/s against 0.104 ms at 989
// TFLOP/s) and 1,342.3 MB for 77.3 GFLOP (M 1,048,576, K 576, N 64: 0.401
// ms against 0.078): the bytes bound both, so a has to stream from device
// memory once, at full rate, with the products and the epilogue hidden
// under it.
//
// The design, conv_valid.cu's producer / consumer split for a 1x1 "conv":
// - Persistent blocks, one per SM, walk tiles of kBM = 128 rows x NT
//   columns (NT 128, or 64 where N is not a multiple of 128) in a
//   grid-stride loop, the column blocks of one row tile next to each
//   other. Two consumer warpgroups own 64 rows each (one wgmma m64nNTk16
//   accumulator, both operands by descriptor: a K-major, b MN-major); one
//   thread of a producer warpgroup issues every load; setmaxnreg moves
//   registers from the producer warpgroup to the consumers.
// - a streams through a ring of stages under full / empty mbarriers: a
//   stage is one TMA box of [kBM rows][64 k] (128-byte rows, 128-byte
//   swizzle), 16 KB, so a ring of 4 keeps 64 KB of a in flight a block.
//   The producer runs ahead across tile boundaries: the ring does not
//   drain at an epilogue. Rows past M load as zeros.
// - b is read as it is, [K][N] (N contiguous), in [64 k][64 n] boxes that
//   wgmma reads MN-major (tnspB), as conv_valid.cu reads its weights: no
//   transposed copy exists. Each stage carries its [64 k][NT] box of b
//   beside a's, so b's traffic into shared memory is NT / kBM of a's, all
//   of it L2 hits.
// - The tile and the ring's depth were chosen by
//   salt_tpu_torch/tools/matmul_ab.py on an H100 (PERF.md): 128-row tiles
//   ran 1.4% and 3.1% faster than 256-row ones at the probe's two GEMMs
//   (the stream alone at 256 rows was no faster than the whole kernel); a
//   ring of 6, or b loaded once per block at N 64, moved neither.
// - Epilogue: fp32 -> bf16 (round to nearest even), stmatrix.x4 into a
//   swizzled [64 rows][NT] staging buffer per warpgroup, one TMA store per
//   64 columns (rows past M dropped), draining while the next tile's
//   products run.
// Shared memory at NT 128: 4 x 32,768 (ring) + 2 x 16,384 (staging) + 64
// (barriers) + 1,024 (alignment) = 164,928 B. cuBLAS and torch.matmul are
// the yardstick and never the implementation.
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;                     // rows a tile
constexpr int kStages = 4;                   // the ring's depth
constexpr int kKC = 64;                      // k a stage: 128-byte rows
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kConsumerRegs = 232;           // as in conv_valid.cu
constexpr int kProducerRegs = 40;
constexpr int kAtomBytes = 64 * 128;         // [64][64] bf16, swizzled
constexpr int kABytes = kBM * kKC * 2;       // a's box in a stage
constexpr int kWGRows = kBM / 2;             // rows a warpgroup
constexpr int kMAcc = kWGRows / 64;          // m64 accumulators

template <int NT>
struct Cfg {
  static constexpr int kAcc = NT / 2;        // fp32 a thread, each
  static constexpr int kStageBytes = kABytes + kKC * NT * 2;  // a's, b's
  static constexpr int kStagingBytes = 64 * NT * 2;   // a warpgroup's
  static constexpr int kStagingOff = kStages * kStageBytes;
  static constexpr int kBarOff = kStagingOff + 2 * kStagingBytes;
  static constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;
};

struct Geometry {
  int n_k;           // 64-wide k chunks
  int n_fb;          // column blocks of NT
  int n_tiles;       // row tiles x column blocks
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_y, Geometry g) {
  using C = Cfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte
  // alignment
  const uint32_t base =
      smem_addr(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = base;
  const uint32_t staging = base + C::kStagingOff;
  // full / empty barriers, 8 bytes each, one per stage
  const uint32_t full = base + C::kBarOff, empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                           // the last block-wide barrier

  if (tid >= kConsumers) {
    // producer: one thread issues every load, in the order of use; its
    // warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid != kConsumers) return;
    int slot = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
      const int fb = tile % g.n_fb, mt = tile / g.n_fb;
      for (int kc = 0; kc < g.n_k; ++kc) {
        const uint32_t dst = ring + slot * C::kStageBytes;
        mbar_wait(empty + 8 * slot, phase ^ 1);  // the consumers freed it
        mbar_expect_tx(full + 8 * slot, C::kStageBytes);
        tma_load_2d(dst, &tm_a, kc * kKC, mt * kBM, full + 8 * slot);
#pragma unroll
        for (int nb = 0; nb < NT / 64; ++nb)
          tma_load_2d(dst + kABytes + nb * kAtomBytes, &tm_b,
                      fb * NT + nb * 64, kc * kKC, full + 8 * slot);
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * kWGRows .. + kWGRows - 1 of a
  // tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;

  float acc[kMAcc][C::kAcc];
  int slot = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int mi = 0; mi < kMAcc; ++mi)
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[mi][i] = 0.f;
    int held = -1;                           // the stage to release
    for (int kc = 0; kc < g.n_k; ++kc) {
      mbar_wait(full + 8 * slot, phase);     // the stage landed
      const uint32_t a = ring + slot * C::kStageBytes + wg * kWGRows * 128;
      const uint32_t b = ring + slot * C::kStageBytes + kABytes;
#pragma unroll
      for (int mi = 0; mi < kMAcc; ++mi) fence_operand<C::kAcc>(acc[mi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
        for (int mi = 0; mi < kMAcc; ++mi)
          wgmma_ss_tn<NT>(acc[mi], b_desc(a + mi * 64 * 128 + kk * 32),
                          smem_desc(b + kk * 2048, kAtomBytes, 1024));
      wgmma_commit();
#pragma unroll
      for (int mi = 0; mi < kMAcc; ++mi) fence_operand<C::kAcc>(acc[mi]);
      wgmma_wait<1>();                       // the last step's are done
      if (held >= 0) mbar_arrive(empty + 8 * held);
      held = slot;
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < kMAcc; ++mi) fence_operand<C::kAcc>(acc[mi]);
    mbar_arrive(empty + 8 * held);
    // epilogue, 64 rows at a time: accumulator element (row p, column f)
    // -> staging atom f / 64, row p, piece (f % 64) / 8 at
    // ((f % 64) / 8) ^ (p & 7) (TMA's 128-byte swizzle), by stmatrix.x4:
    // four 8 x 8 matrices a warp (rows +0 / +8 by column groups j, j + 1),
    // lane l giving the address of row l % 8 of matrix l / 8; one thread
    // stores the rows once the warpgroup has written them
    const int fb = tile % g.n_fb, mt = tile / g.n_fb;
    const uint32_t stage = staging + wg * C::kStagingBytes;
    const int sp = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int sj = lane >> 4;
#pragma unroll
    for (int mi = 0; mi < kMAcc; ++mi) {
      if (wtid == 0)                         // the last store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int j = 0; j < NT / 8; j += 2) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              acc[mi][(j + (i >> 1)) * 4 + (i & 1) * 2],
              acc[mi][(j + (i >> 1)) * 4 + (i & 1) * 2 + 1]);
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
          tma_store_2d(&tm_y, stage + nb * kAtomBytes, fb * NT + nb * 64,
                       mt * kBM + wg * kWGRows + mi * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the shared-memory opt-in and the SM count, once per device and kernel
template <int NT>
int launch(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
           const CUtensorMap& tm_y, const Geometry& g, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  constexpr int smem = Cfg<NT>::kSmemBytes;
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    err = cudaFuncSetAttribute(matmul_wgmma_kernel<NT>,
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
  matmul_wgmma_kernel<NT><<<grid, kThreads, smem, stream>>>(tm_a, tm_b, tm_y,
                                                            g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: bf16 [m][k]; b: bf16 [k][n]; y: bf16 [m][n]. k and n multiples of 64,
// m < 2^31; a, b and y 16-byte aligned and contiguous, y distinct from
// both. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or the error of the setup calls; never synchronizes.
extern "C" int salt_matmul_wgmma(const void* a, const void* b, void* y,
                                 long long m, int k, int n, void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL - kBM || k <= 0 || k % kKC != 0 || n <= 0 ||
      n % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = n % 128 == 0 ? 128 : 64;
  const long long tiles = (m + kBM - 1) / kBM * (n / nt);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.n_k = k / kKC;
  g.n_fb = n / nt;
  g.n_tiles = static_cast<int>(tiles);

  CUtensorMap tm_a, tm_b, tm_y;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(k),
                              static_cast<uint64_t>(m)};
  const uint64_t a_strides[1] = {2ull * k};
  const uint32_t a_box[2] = {kKC, kBM};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(n),
                              static_cast<uint64_t>(k)};
  const uint64_t n_strides[1] = {2ull * n};
  const uint32_t box64[2] = {64, 64};
  const uint64_t y_dims[2] = {static_cast<uint64_t>(n),
                              static_cast<uint64_t>(m)};
  int rc = encode(&tm_a, a, 2, a_dims, a_strides, a_box);
  if (rc == 0) rc = encode(&tm_b, b, 2, b_dims, n_strides, box64);
  if (rc == 0) rc = encode(&tm_y, y, 2, y_dims, n_strides, box64);
  if (rc != 0) return rc;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nt == 128 ? launch<128>(tm_a, tm_b, tm_y, g, s)
                   : launch<64>(tm_a, tm_b, tm_y, g, s);
}
