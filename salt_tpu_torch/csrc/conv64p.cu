// Pair-packed 3x3 conv 64 -> 64, bf16 or int8 in, bf16 out, for the H100
// (sm_90a); plain C interface loaded with ctypes by
// salt_tpu_torch/ops/conv64p_kernel.py.
//
// Replaces the TPU probe kernel tools/pallas_conv2.py:53-168
// (make_conv64p_v2, with its double-buffered and int8 variants); row 5,
// tools/pallas_conv.py:115-170 (make_conv64p_kernel), the same function
// without them, runs on conv_valid.cu. x_packed [B][H+2][P][128]
// (P = (W+16)/2; two neighbouring pixels' 64 channels share a row) by
// w_packed [768][128]: output pair (b, h, p) is one [1, 768] x [768, 128]
// product over packed columns p, p+1 of input rows h..h+2. All 768 weight
// rows are read, the slots pack_pair_weights leaves at zero included.
//
// What bounds it. At the probes' size (B 64, H = W = 128) the function moves
// 287.8 MB in bf16 (0.086 ms at 3.35 TB/s) and does 103.1 GFLOP as issued
// (0.104 ms at 989 TFLOP/s): the operations bound it. In int8 it moves
// 211.0 MB (0.063 ms) for 103.1 GOP (0.052 ms at 1,979 TOP/s): the bytes do.
//
// The design (igemm.cuh). On the TPU the packing fills the 128-lane MXU
// with 64-wide outputs; here it makes the A matrix an implicit GEMM with
// K = 768 in three contiguous runs of 256 elements (one per input row), so
// no im2col matrix exists anywhere: M = B*H*W/2 pairs, N = 128, K = 768.
// A block owns the Pallas grid tile, tile_h rows x W/2 pairs of one image.
// mma.sync m16n8k16 bf16 -> fp32, or m16n8k32 s8 -> s32 whose sum (below
// 768 * 128^2 < 2^24) converts to fp32 exactly before the one rounding to
// bf16. `db` double-buffers the input tiles with cp.async, as the Pallas
// variant double-buffers its slab DMA; without it each stage is loaded and
// then computed. The Pallas variants `shift` and `dots` only choose Mosaic's
// data movement (32-bit rolls, one concatenated dot or six split dots) and
// have no counterpart here.
#include "igemm.cuh"

namespace {

template <bool kInt8, bool kDb>
int run(const void* x, const void* wt, void* y, int batch, int h, int w,
        int tile_h, cudaStream_t stream) {
  const igemm::PairPackedA a{static_cast<const unsigned char*>(x), h, w / 2,
                             (w + 16) / 2, kInt8 ? 1 : 2};
  const long long tile_rows = static_cast<long long>(tile_h) * (w / 2);
  const long long m_total = static_cast<long long>(batch) * h * (w / 2);
  return igemm::launch<igemm::PairPackedA, 128, kInt8, kDb>(
      a, wt, y, m_total / tile_rows, tile_rows, m_total, 128,
      768 * (kInt8 ? 1 : 2), stream);
}

}  // namespace

// x: [batch][h+2][(w+16)/2][128] bf16 (int8 = 0) or int8 (int8 = 1);
// wt: the packed weights transposed, [128][768], same type; y: bf16
// [batch][h][w/2][128]. w even, h a multiple of tile_h; x and wt 16-byte
// aligned and contiguous. Launches on `stream` and returns cudaGetLastError()
// (0 on success); never synchronizes.
extern "C" int salt_conv64p(const void* x, const void* wt, void* y, int batch,
                            int h, int w, int tile_h, int db, int int8,
                            void* stream) {
  if (batch <= 0) return 0;
  if (h <= 0 || w <= 0 || w % 2 != 0 || tile_h <= 0 || h % tile_h != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return db ? run<true, true>(x, wt, y, batch, h, w, tile_h, s)
              : run<true, false>(x, wt, y, batch, h, w, tile_h, s);
  return db ? run<false, true>(x, wt, y, batch, h, w, tile_h, s)
            : run<false, false>(x, wt, y, batch, h, w, tile_h, s);
}
