// 3x3 VALID conv C -> F as one deep-K product, bf16 in and out, fp32
// accumulation, for the H100 (sm_90a); plain C interface loaded with ctypes
// by salt_tpu_torch/ops/conv128_kernel.py.
//
// Replaces the TPU probe kernel tools/pallas_conv.py:35-88
// (make_conv128_kernel): x [B][H+2][W+8][C] (C a multiple of 128), w_flat
// [9C][F] with K index (ky*3 + kx)*C + ci; out [B][H][W][F] = the VALID conv
// of x[:, :, :W+2]. Columns W+2 .. W+7 are never read.
//
// What bounds it. At the probe's size (B 64, H = W = 128, C = F = 128) it
// moves 558.4 MB (0.167 ms at 3.35 TB/s) and does 309.2 GFLOP (0.313 ms at
// 989 TFLOP/s): the operations bound it.
//
// The design (igemm.cuh). The Pallas kernel builds the [tile_h*W, 9C] im2col
// matrix in VMEM with f32 rolls and one lane concat, then makes one MXU dot.
// Here the same K = 9C product is an implicit GEMM: each output pixel's K
// runs over 9 taps of C contiguous channels, so a stage of 64 channels of
// one tap is one contiguous 128-byte load per pixel and no im2col matrix is
// built. The weights (295 KB at C = F = 128, above a block's 227 KB of
// shared memory) stream through shared memory over K with the input, one
// 128-byte stage at a time, double-buffered with cp.async. A block owns the
// Pallas grid tile, tile_h rows x W pixels of one image, and BN = 128 (or
// 64) of the F outputs. mma.sync m16n8k16 bf16 -> fp32, one rounding to bf16.
#include "igemm.cuh"

// x: bf16 [batch][h+2][w+8][c], c a multiple of 128; wt: w_flat transposed,
// bf16 [f][9c], f a multiple of 64; y: bf16 [batch][h][w][f]. h a multiple
// of tile_h; x and wt 16-byte aligned and contiguous. Launches on `stream`
// and returns cudaGetLastError() (0 on success); never synchronizes.
extern "C" int salt_conv128(const void* x, const void* wt, void* y, int batch,
                            int h, int w, int c, int f, int tile_h,
                            void* stream) {
  if (batch <= 0) return 0;
  if (h <= 0 || w <= 0 || c <= 0 || c % 128 != 0 || f <= 0 || f % 64 != 0 ||
      tile_h <= 0 || h % tile_h != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const igemm::Im2colA a{static_cast<const unsigned char*>(x), h, w, w + 8, c};
  const long long tile_rows = static_cast<long long>(tile_h) * w;
  const long long m_total = static_cast<long long>(batch) * h * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f % 128 == 0)
    return igemm::launch<igemm::Im2colA, 128, false, true>(
        a, wt, y, m_total / tile_rows, tile_rows, m_total, f, 18 * c, s);
  return igemm::launch<igemm::Im2colA, 64, false, true>(
      a, wt, y, m_total / tile_rows, tile_rows, m_total, f, 18 * c, s);
}
