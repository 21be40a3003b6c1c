// Descending bitonic sort with payload for the H100 (sm_90a), plain C
// interface loaded with ctypes by salt_tpu_torch/ops/sort_kernel.py.
//
// Replaces the TPU kernel salt_tpu/ops/pallas_sort.py (_sort_kernel :46,
// called through sort_desc_pallas :87-121), the sort of the per-image
// Lovasz hinge: fp32 keys [rows, P] sorted descending along P with an
// int32 payload permuted alongside. The network is the one of
// salt_tpu_torch/ops/bitonic.py (stage (k, j): element i against i ^ j,
// descending where (i & k) == 0, swap on a strict < / >), so equal keys
// never swap and keys and payload are bit-identical to that plain version,
// ties included.
//
// Bound at the training shape (24 rows x 32,768): 16 B per element (keys
// and payload each read once and written once) x 786,432 = 12.6 MB, i.e.
// 0.00376 ms at 3.35 TB/s; the 120 stages x 16,384 x 24 = 47.2 M
// compare-exchanges are 0.7 us at 67 TFLOP/s fp32. Bytes bound it.
//
// Shared memory. The TPU kernel keeps a whole row of keys and payload in
// VMEM for all 120 stages. On the H100 a block may use 227 KB of shared
// memory, and fp32 keys plus an int32 payload are 256 KiB per row. The
// network's permutation depends on the keys alone, so the block sorts
// (key, uint16 index) pairs, 6 B per element = 192 KiB at P = 32,768
// (dynamic shared memory, opted into with cudaFuncSetAttribute), and
// gathers the int32 payload from device memory through the sorted index at
// the end: payload_out[i] = payload_in[index[i]]. That carries any payload
// exactly, the Lovasz loss's (label << 20 | index) included. P is limited
// to 32,768 by the shared memory (and to 65,536 by the index width).
//
// Parallelism. One block per row, up to 1,024 threads, each doing
// P / 2 / threads compare-exchanges per stage, with __syncthreads() between
// stages. At 24 rows this occupies 24 of the 132 SMs and every stage is
// bound by shared-memory bandwidth and the barrier, far above the bound
// above. That simple design is accepted for now; the ways to make it fast
// are registers and warp shuffles for j < 32, the early stages (k <= 2048)
// spread over many blocks per row, and a 2-CTA cluster with distributed
// shared memory for the last merges.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLength = 32768;
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
bitonic_sort_desc_kernel(const float* __restrict__ keys,
                         const int32_t* __restrict__ payload,
                         float* __restrict__ keys_out,
                         int32_t* __restrict__ payload_out, int log_length) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int length = 1 << log_length;
  float* sk = reinterpret_cast<float*>(smem);
  uint16_t* si = reinterpret_cast<uint16_t*>(sk + length);
  const size_t base = static_cast<size_t>(blockIdx.x) * length;

  for (int i = threadIdx.x; i < length; i += blockDim.x) {
    sk[i] = keys[base + i];
    si[i] = static_cast<uint16_t>(i);
  }
  __syncthreads();

  const int half = length >> 1;
  for (int k_exp = 1; k_exp <= log_length; ++k_exp) {
    for (int j_exp = k_exp - 1; j_exp >= 0; --j_exp) {
      const int j_mask = (1 << j_exp) - 1;
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // the t-th pair: low partner lo (bit j_exp clear), high lo + j
        const int lo = ((t >> j_exp) << (j_exp + 1)) | (t & j_mask);
        const int hi = lo + (1 << j_exp);
        const float a = sk[lo];
        const float b = sk[hi];
        const bool desc = ((lo >> k_exp) & 1) == 0;
        if (desc ? (a < b) : (a > b)) {
          sk[lo] = b;
          sk[hi] = a;
          const uint16_t ia = si[lo];
          si[lo] = si[hi];
          si[hi] = ia;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < length; i += blockDim.x) {
    keys_out[base + i] = sk[i];
    payload_out[base + i] = payload[base + si[i]];
  }
}

}  // namespace

// keys, keys_out: fp32 [rows, length]; payload, payload_out: int32
// [rows, length]; all contiguous, outputs distinct from inputs. length a
// power of two in [2, 32768]. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the shared-memory
// opt-in; never synchronizes.
extern "C" int salt_bitonic_sort_desc(const void* keys, const void* payload,
                                      void* keys_out, void* payload_out,
                                      int rows, int length, void* stream) {
  if (rows <= 0) return 0;
  int log_length = 0;
  while ((1 << log_length) < length) ++log_length;
  if (length < 2 || length > kMaxLength || (1 << log_length) != length) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = length * static_cast<int>(sizeof(float) + sizeof(uint16_t));
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort_desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = length / 2 < kMaxThreads ? length / 2 : kMaxThreads;
  bitonic_sort_desc_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const int32_t*>(payload),
      static_cast<float*>(keys_out), static_cast<int32_t*>(payload_out), log_length);
  return static_cast<int>(cudaGetLastError());
}
