// Tiled matmul [M, K] x [K, N], bf16 in and out, fp32 accumulation, for the
// H100 (sm_90a); plain C interface loaded with ctypes by
// salt_tpu_torch/ops/matmul_kernel.py.
//
// Replaces the TPU probe kernel tools/pallas_conv.py:173-200
// (make_matmul_kernel): a grid over tile_m rows of a, the whole [K, N] of b
// resident, one fp32-accumulated dot per tile.
//
// What bounds it. At the probe's shapes it moves 939.7 MB for 103.1 GFLOP
// (M 524,288, K 768, N 128: 0.281 ms at 3.35 TB/s against 0.104 ms at 989
// TFLOP/s) and 1,342.3 MB for 77.3 GFLOP (M 1,048,576, K 576, N 64: 0.401
// ms): both are bound by the bytes, so the product must stream a once, at
// full rate, while the tensor cores keep up.
//
// The design (igemm.cuh, with a plain row-major A). A block owns a Pallas
// grid tile of tile_m rows and BN = 128 (or 64) columns and walks it in
// 128-row tiles; a and b^T stream through shared memory in 128-byte K stages,
// double-buffered with cp.async, so the next stage's rows load while this
// one's mma.sync m16n8k16 products run. b^T (196 KB at K 768, N 128) is
// read from L2 by every tile. cuBLAS and torch.matmul are the yardstick
// and never the implementation.
#include "igemm.cuh"

// a: bf16 [m][k], k a multiple of 64; bt: b transposed, bf16 [n][k], n a
// multiple of 64; y: bf16 [m][n]. m a multiple of tile_m; a and bt 16-byte
// aligned and contiguous. Launches on `stream` and returns cudaGetLastError()
// (0 on success); never synchronizes.
extern "C" int salt_matmul_bf16(const void* a, const void* bt, void* y,
                                long long m, int k, int n, long long tile_m,
                                void* stream) {
  if (m <= 0) return 0;
  if (k <= 0 || k % 64 != 0 || n <= 0 || n % 64 != 0 || tile_m <= 0 ||
      m % tile_m != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const igemm::RowMajorA op{static_cast<const unsigned char*>(a), 2LL * k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 128 == 0)
    return igemm::launch<igemm::RowMajorA, 128, false, true>(
        op, bt, y, m / tile_m, tile_m, m, n, 2 * k, s);
  return igemm::launch<igemm::RowMajorA, 64, false, true>(
      op, bt, y, m / tile_m, tile_m, m, n, 2 * k, s);
}
