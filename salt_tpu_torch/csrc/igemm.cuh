// Implicit GEMM on mma.sync for the H100 (sm_90a), shared by the probe
// kernels of rows 6 and 7 of PERF.md's kernel table: matmul_bf16.cu (plain
// tiled matmul) and conv64p.cu's make_conv64p_v2 path (pair-packed 3x3
// conv, bf16 or int8, with or without double buffering). Rows 4 and 5 run
// on conv_valid.cu (TMA + wgmma).
//
// out[m, n] = sum_k A[m, k] * Bt[n, k], with A never materialized: an
// operand class (RowMajorA, PairPackedA below) maps an output row m to the
// address of its first K byte and a K byte offset to its distance from
// there. Every K run of A (a row of a matmul, one ky row of a pair window)
// is contiguous and a multiple of 128 bytes long, so a stage of 128 K bytes
// is one contiguous 128-byte piece of each row.
// Bt is the weight matrix transposed to [N][K] (K contiguous) by the caller,
// so that both operands load with plain (untransposed) ldmatrix, for bf16
// and for int8 alike. fp32 (bf16) or s32 (int8) sums stay in registers and
// are rounded once to bf16; an s32 sum below 2^24 converts to fp32 exactly.
//
// Work split, as the Pallas grid splits it: block x owns one grid tile of
// `tile_rows` consecutive output rows (a tile_h x W/2 band of pairs or
// tile_m matrix rows) and walks it in 128-row tiles; block y owns BN (128
// or 64) output columns. 8 warps, each a 64x32
// (BN = 128) or 32x32 (BN = 64) piece of the 128 x BN tile.
//
// Shared memory holds one stage of A (128 rows x 128 bytes) and of Bt (BN
// rows x 128 bytes), filled with cp.async (16 bytes a thread, 8 neighbouring
// threads on one row's 128 contiguous bytes) and read with ldmatrix.x4; the
// 16-byte chunk c of row r sits at chunk c ^ (r & 7), so the 8 rows an
// ldmatrix phase reads hit 8 distinct bank groups. Without double buffering a
// stage is loaded, waited for and computed in turn. With it (kDb), two stages
// alternate: the loads of the next stage, the first stage of the next
// 128-row tile included, are in flight while this one computes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace igemm {

constexpr int kBM = 128;               // output rows of a block's tile
constexpr int kKB = 128;               // K bytes per stage (64 bf16, 128 int8)
constexpr int kThreads = 256;          // 8 warps
constexpr int kRowsPerPass = kThreads / (kKB / 16);   // 32 rows per pass

template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 64, "BN is 128 or 64");
  static constexpr int kWarpsM = BN == 128 ? 2 : 4;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = kBM / kWarpsM;          // 64 or 32
  static constexpr int kWN = BN / kWarpsN;           // 32
  static constexpr int kMT = kWM / 16;               // m16 tiles per warp
  static constexpr int kNT = kWN / 8;                // n8 tiles per warp
  static constexpr int kStageBytes = (kBM + BN) * kKB;
};

// matmul: a [M][K], row-major
struct RowMajorA {
  const unsigned char* a;
  long long row_bytes;
  __device__ const unsigned char* base() const { return a; }
  __device__ const unsigned char* row(long long m) const {
    return a + m * row_bytes;
  }
  __device__ long long koff(int kb) const { return kb; }
};

// pair-packed conv: x [B][H+2][P][128] elements of `es` bytes; row m =
// (b, h, p) reads packed columns p, p+1 (256 contiguous elements) of input
// rows h, h+1, h+2
struct PairPackedA {
  const unsigned char* x;
  int h, po, p, es;
  __device__ const unsigned char* base() const { return x; }
  __device__ const unsigned char* row(long long m) const {
    const long long t = m / po;
    const long long b = t / h;
    return x + ((b * (h + 2) + t % h) * p + m % po) * 128LL * es;
  }
  __device__ long long koff(int kb) const {
    const int run = 256 * es;
    return static_cast<long long>(kb / run) * p * 128 * es + kb % run;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

template <class AOp, int BN, bool kInt8, bool kDb>
__global__ void __launch_bounds__(kThreads, 2)
igemm_kernel(AOp a_op, const unsigned char* __restrict__ bt,
             __nv_bfloat16* __restrict__ out, long long tile_rows,
             long long m_total, int n_total, int k_bytes) {
  using T = Tile<BN>;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kARows = kBM / kRowsPerPass;          // 4
  constexpr int kBRows = BN / kRowsPerPass;           // 4 or 2
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / T::kWarpsN;
  const int warp_n = warp % T::kWarpsN;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const long long row_lo = static_cast<long long>(blockIdx.x) * tile_rows;
  const long long row_hi =
      row_lo + tile_rows < m_total ? row_lo + tile_rows : m_total;
  const int n0 = blockIdx.y * BN;
  const int k_stages = k_bytes / kKB;
  const int m_tiles = static_cast<int>((row_hi - row_lo + kBM - 1) / kBM);
  const int units = m_tiles * k_stages;

  // this thread's loads: chunk column `ch` of rows `r0 + 32 i`
  const int ch = tid & 7;
  const int r0 = tid >> 3;
  const int swz = (ch ^ (r0 & 7)) << 4;
  const unsigned char* a_row[kARows];
  bool a_ok[kARows];
  int cached_mt = -1;

  auto load = [&](int u, int buf) {
    const int mt = u / k_stages;
    const int ks = u - mt * k_stages;
    if (mt != cached_mt) {
      cached_mt = mt;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const long long m = row_lo + static_cast<long long>(mt) * kBM + r0 +
                            i * kRowsPerPass;
        a_ok[i] = m < row_hi;
        a_row[i] = a_ok[i] ? a_op.row(m) : a_op.base();
      }
    }
    unsigned char* sa = smem + buf * T::kStageBytes;
    unsigned char* sb = sa + kBM * kKB;
    const long long ka = a_op.koff(ks * kKB) + ch * 16;
#pragma unroll
    for (int i = 0; i < kARows; ++i)
      cp_async16(sa + (r0 + i * kRowsPerPass) * kKB + swz,
                 a_row[i] + (a_ok[i] ? ka : 0), a_ok[i]);
    const long long kb = static_cast<long long>(ks) * kKB + ch * 16;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int r = r0 + i * kRowsPerPass;
      cp_async16(sb + r * kKB + swz,
                 bt + static_cast<long long>(n0 + r) * k_bytes + kb, true);
    }
  };

  Acc acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  if (kDb && units > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    const int buf = kDb ? (u & 1) : 0;
    if (kDb) {
      if (u + 1 < units) load(u + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load(u, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    const unsigned char* sa = smem + buf * T::kStageBytes;
    const unsigned char* sb = sa + kBM * kKB;
#pragma unroll
    for (int kk = 0; kk < kKB / 32; ++kk) {
      uint32_t af[T::kMT][4];
      uint32_t bf[T::kNT][2];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        const int r = warp_m * T::kWM + i * 16 + (lane & 15);
        const int c = kk * 2 + (lane >> 4);
        ldsm_x4(af[i], sa + r * kKB + ((c ^ (r & 7)) << 4));
      }
#pragma unroll
      for (int j = 0; j < T::kNT; j += 2) {
        const int r =
            warp_n * T::kWN + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk * 2 + ((lane >> 3) & 1);
        uint32_t q[4];
        ldsm_x4(q, sb + r * kKB + ((c ^ (r & 7)) << 4));
        bf[j][0] = q[0];
        bf[j][1] = q[1];
        bf[j + 1][0] = q[2];
        bf[j + 1][1] = q[3];
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) mma(acc[i][j], af[i], bf[j]);
    }

    const int mt = u / k_stages;
    if (u - mt * k_stages == k_stages - 1) {
      // epilogue of a 128-row tile: round once to bf16, store, reset
      const long long m0 = row_lo + static_cast<long long>(mt) * kBM +
                           warp_m * T::kWM + g;
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long m = m0 + i * 16 + half * 8;
          if (m < row_hi) {
            __nv_bfloat16* dst = out + m * n_total + n0 + warp_n * T::kWN +
                                 tig * 2;
#pragma unroll
            for (int j = 0; j < T::kNT; ++j)
              *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
                  __floats2bfloat162_rn(to_float(acc[i][j][half * 2]),
                                        to_float(acc[i][j][half * 2 + 1]));
          }
        }
#pragma unroll
        for (int j = 0; j < T::kNT; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
      }
    }
    __syncthreads();   // the stage is free for the load two units ahead
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success) or the
// error of the set-up call. Never synchronizes.
template <class AOp, int BN, bool kInt8, bool kDb>
int launch(const AOp& a_op, const void* bt, void* out, long long grid_tiles,
           long long tile_rows, long long m_total, int n_total, int k_bytes,
           cudaStream_t stream) {
  constexpr int smem = (kDb ? 2 : 1) * Tile<BN>::kStageBytes;
  auto kernel = igemm_kernel<AOp, BN, kInt8, kDb>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(grid_tiles),
                  static_cast<unsigned>(n_total / BN));
  kernel<<<grid, kThreads, smem, stream>>>(
      a_op, static_cast<const unsigned char*>(bt),
      static_cast<__nv_bfloat16*>(out), tile_rows, m_total, n_total, k_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace igemm
