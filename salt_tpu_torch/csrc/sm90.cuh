// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels,
// conv3x3_pair.cu, conv_valid.cu, matmul_wgmma.cu and int8_conv_wgmma.cu:
// mbarriers, TMA loads and stores, wgmma (bf16 with A in registers or by
// descriptor, s8 with A in registers) with B by shared-memory descriptor,
// and the tensor-map encoder (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so nothing links against libcuda).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- TMA ----
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----
// shared-memory descriptor, 128-byte swizzle: `lbo` and `sbo` in bytes.
// K-major B: 8-row atoms `sbo` apart (lbo unused). MN-major B: 8-k-row
// groups `sbo` apart, 64-wide N atoms `lbo` apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major: rows of 128 bytes (64 bf16 or 128 s8 k values) in 8-row atoms
// 1024 bytes apart, as TMA's 128-byte swizzle leaves a box; a k step (16
// bf16, 32 s8) is +32 bytes of `addr` inside the atom. wgmma's B, or the
// A of wgmma_ss_tn.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return smem_desc(addr, 0, 1024);
}
// K-major under the 64-byte swizzle: rows of 64 bytes (64 s8 k values) in
// 8-row atoms 512 bytes apart, as TMA's 64-byte swizzle leaves a box
// whose inner dimension is 64 bytes; a k32 step is +32 bytes of `addr`.
__device__ __forceinline__ uint64_t b_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int kRegs = 32>
__device__ __forceinline__ void fence_operand(float* d) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kRegs = 32>
__device__ __forceinline__ void fence_operand(int32_t* d) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The wgmma wrappers' operand lists: 32 or 64 accumulator registers (N 64
// or 128 of an m64 tile), fp32 ("+f") or s32 ("+r"), numbered from %0.
#define SM90_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define SM90_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_ACC8(c, d, i)                                                \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),            \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define SM90_ACC32(c, d) \
  SM90_ACC8(c, d, 0), SM90_ACC8(c, d, 8), SM90_ACC8(c, d, 16),            \
      SM90_ACC8(c, d, 24)
#define SM90_ACC64(c, d) \
  SM90_ACC32(c, d), SM90_ACC8(c, d, 32), SM90_ACC8(c, d, 40),             \
      SM90_ACC8(c, d, 48), SM90_ACC8(c, d, 56)

// d[64 x N] += a[64 x 16] (registers) * B[16 x N] (descriptor), bf16 ->
// fp32; B is K-major (kTransB 0) or MN-major (kTransB 1)
template <int N = 64, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SM90_ACC32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 1>(float* d, const uint32_t* a,
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_ACC64("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// d[64 x N] += a[64 x 32] (registers) * B[32 x N] (descriptor), s8 -> s32.
// wgmma takes 8-bit B K-major only (no transpose): B is [N][32 k] under
// b_desc, a k32 step 32 bytes on. a's fragment holds the same bytes as a
// bf16 k16 fragment (ldmatrix.x4 of the same 16-byte row pieces).
template <int N>
__device__ __forceinline__ void wgmma_rs_s8(int32_t* d, const uint32_t* a,
                                            uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs_s8<64>(int32_t* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : SM90_ACC32("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_rs_s8<128>(int32_t* d,
                                                 const uint32_t* a,
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : SM90_ACC64("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// d[64 x N] += A[64 x 16] * B[16 x N], both by descriptor, bf16 -> fp32:
// A K-major (b_desc's layout: [64 m][64 k] swizzled rows), B MN-major
// (tnspB)
template <int N>
__device__ __forceinline__ void wgmma_ss_tn(float* d, uint64_t a_desc,
                                            uint64_t b_desc);

template <>
__device__ __forceinline__ void wgmma_ss_tn<64>(float* d, uint64_t a_desc,
                                                uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SM90_ACC32("+f", d)
      : "l"(a_desc), "l"(b_desc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tn<128>(float* d, uint64_t a_desc,
                                                 uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : SM90_ACC64("+f", d)
      : "l"(a_desc), "l"(b_desc));
}

// A 2- to 4-D tensor map of `type` (bf16, or bytes for s8) with a
// 128-byte swizzle (the innermost box is 128 bytes: 64 bf16, 128 s8), or
// `swizzle` (64 bytes: an innermost box of 64 bytes); dims and box
// innermost first, in elements, strides in bytes of dims 1.. .
// Out-of-bounds elements load as zero bits. Returns 0 or a cudaError_t.
inline int encode(CUtensorMap* m, const void* ptr, int rank,
                  const uint64_t* dims, const uint64_t* strides,
                  const uint32_t* box,
                  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult rc = fn(
      m, type, rank, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
