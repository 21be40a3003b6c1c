// Descending bitonic sort with payload for the H100 (sm_90a), plain C
// interface loaded with ctypes by salt_tpu_torch/ops/sort_kernel.py.
//
// Replaces the TPU kernel salt_tpu/ops/pallas_sort.py (_sort_kernel :46,
// called through sort_desc_pallas :87-121), the sort of the per-image
// Lovasz hinge: fp32 keys [rows, P] sorted descending along P with an
// int32 payload permuted alongside. The network is the one of
// salt_tpu_torch/ops/bitonic.py (stage (k, j): element i against i ^ 2^j,
// descending where bit k of i, its position in the row, is 0; swap on a
// strict < / >), stage for stage, so equal keys, NaNs and +-0 never swap
// and keys and payload are bit-identical to that plain version.
//
// Bound at the training shape (24 rows x 32,768): 16 B per element (keys
// and payload each read once and written once) x 786,432 = 12.6 MB, i.e.
// 0.00376 ms at 3.35 TB/s; the 120 stages x 16,384 x 24 = 47.2 M
// compare-exchanges are 0.7 us at 67 TFLOP/s fp32. Bytes bound it on
// paper. What bounds this kernel is instruction issue: every stage
// touches every element, each compare-exchange is a few instructions (two
// products by the direction's sign, a compare, the selects of key and
// index), and a stage whose partners sit in two threads adds two shuffles
// or two shared-memory round trips (key and index) per element. A chunk
// launch takes as long as its busiest SM, so the wrapper sizes the chunk
// to the rows: 4,096 while rows x P / 4,096 blocks fit one to an SM
// (up to 33 rows of 32,768 on 132 SMs), else 8,192 (96 blocks at 24
// rows), two launches fewer. chip_smoke.py times the plan on each side,
// every launch counted, beside torch.sort and the bound;
// salt_tpu_torch/tools/sort_probe.py times both chunks and each launch
// (PERF.md, row 2).
//
// Design. The network's permutation depends on the keys alone, so the
// kernel sorts (fp32 key, row index) pairs and gathers the int32 payload
// through the index at the end: payload_out[i] = payload[index[i]] (any
// payload exactly, the Lovasz loss's label << 20 | index included). The
// index is 16 bits between launches (P <= 32,768). Python builds a plan
// (ops/sort_kernel.py::sort_plan, one int32 row per launch with the
// fields of ops/bitonic.py::Launch); salt_bitonic_sort_desc issues its
// launches on the stream and derives nothing the plan does not say. At
// P = 32,768 and a chunk C (4,096 or 8,192) the plan is 7 or 5 launches:
//   1. chunk sort, grid rows x P/C: every stage with k <= log2 C on one
//      chunk per block of C/16 threads;
//   2. for each k above log2 C: a strided pass, in which a thread holds the
//      2^(k - log2 C) elements at stride C of one 2^k-block and does the
//      stages with j >= log2 C in registers (the pairs, 9.4 MB at the
//      training shape, stay in L2), then a chunk merge for j < log2 C;
//      the last writes the keys and gathers the payload.
// In a chunk launch a thread holds 16 consecutive elements in registers.
// A stage with j < 4 is a compare-exchange inside the thread; j < 9 is a
// __shfl_xor_sync with the partner lane, no barrier; only j >= 9 goes
// through shared memory, one barrier per stage (two buffers, so the next
// stage's stores never meet this one's loads) of (fp32 key, uint16 index)
// pairs, 6 B a pair; the keys padded one word in 32 elements and the
// index one word in 64, so that a warp's 32 stores or loads of either hit
// 32 banks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The fields of one plan row, in the order of ops/bitonic.py::Launch.
enum Field : int {
  kOp, kLogLength, kKLo, kKHi, kJHi, kJLo, kLogChunk, kLogPerThread,
  kSrc, kDst, kThreads, kBlocksPerRow, kSmemBytes, kFields
};
constexpr int kOpChunk = 0, kOpStrided = 1;
constexpr int kSrcInput = 0, kSrcScratch = 1;
constexpr int kDstScratch = 0, kDstOutput = 1;

constexpr int kMaxLogLength = 15;
constexpr int kMaxLogChunk = 13;
constexpr int kStridedThreads = 256;
// Two buffers of (fp32 key, uint16 index) pairs, 6 B a pair, each array
// padded to C + C / 32 elements.
constexpr int kMaxSmemBytes = 2 * ((1 << kMaxLogChunk) + (1 << kMaxLogChunk) / 32) * 6;
constexpr int kMaxDevices = 64;

struct Buffers {
  const float* keys;          // [rows, P] input
  const int32_t* payload;     // [rows, P] input
  float* keys_out;            // [rows, P]
  int32_t* payload_out;       // [rows, P]
  float* scratch_keys;        // [rows, P] between launches
  uint16_t* scratch_index;    // [rows, P] between launches
};

// Keys are compared as key * sign, sign +1 or -1: a sign change is exact
// (NaN stays unordered, +0 and -0 stay equal) and the products are only
// compared, never stored, so a strict < of them is the network's strict <
// (sign +1) or > (sign -1). One uniform sign a stage keeps the compare to
// one FSETP, where a select between < and > per element would not.
__device__ __forceinline__ float sign_of(bool positive) { return positive ? 1.0f : -1.0f; }

// The compare-exchange seen from one of its two elements. The pair (lo,
// hi) swaps where desc ? lo < hi : lo > hi; from the element that holds
// lo in a descending block, or hi in an ascending one (sign +1), that is
// key < partner, from the other (sign -1) partner < key. The element then
// takes its partner's pair.
__device__ __forceinline__ void exchange(float& key, uint32_t& index,
                                         float partner_key,
                                         uint32_t partner_index, float sign) {
  if (key * sign < partner_key * sign) {
    key = partner_key;
    index = partner_index;
  }
}

// The compare-exchange of two elements one thread holds, a the lower:
// a swap where a < b in a descending block (sign +1), a > b in an
// ascending one (sign -1).
__device__ __forceinline__ void exchange_pair(float& a, uint32_t& ia, float& b,
                                              uint32_t& ib, float sign) {
  if (a * sign < b * sign) {
    const float t = a;
    a = b;
    b = t;
    const uint32_t it = ia;
    ia = ib;
    ib = it;
  }
}

__device__ __forceinline__ bool descending(int position, int k) {
  return ((position >> k) & 1) == 0;
}

// Stage (k, 2^J) on the 2^kLogE consecutive elements of one thread.
// J is a template argument so that the partners' register indices are
// constants. The direction is bit k of the row position first + e: of e
// where k < kLogE (first is a multiple of 2^kLogE), else the one of first, the
// same for all of the thread's elements, as `sign`.
template <int kLogE, int J>
__device__ __forceinline__ void register_stage_at(float (&key)[1 << kLogE],
                                                  uint32_t (&index)[1 << kLogE],
                                                  int k, float sign) {
  if (k < kLogE) {
#pragma unroll
    for (int e = 0; e < (1 << kLogE); ++e) {
      if ((e & (1 << J)) == 0) {
        exchange_pair(key[e], index[e], key[e | (1 << J)], index[e | (1 << J)],
                      sign_of(((e >> k) & 1) == 0));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < (1 << kLogE); ++e) {
      if ((e & (1 << J)) == 0) {
        exchange_pair(key[e], index[e], key[e | (1 << J)], index[e | (1 << J)], sign);
      }
    }
  }
}

template <int kLogE>
__device__ __forceinline__ void register_stage(float (&key)[1 << kLogE],
                                               uint32_t (&index)[1 << kLogE],
                                               int j, int k, float sign) {
  static_assert(kLogE >= 2 && kLogE <= 4, "2 to 4 elements a thread, log2");
  switch (j) {
    case 0: register_stage_at<kLogE, 0>(key, index, k, sign); break;
    case 1: register_stage_at<kLogE, 1>(key, index, k, sign); break;
    case 2: if constexpr (kLogE > 2) register_stage_at<kLogE, 2>(key, index, k, sign); break;
    case 3: if constexpr (kLogE > 3) register_stage_at<kLogE, 3>(key, index, k, sign); break;
    default: break;
  }
}

// The most threads of a chunk block: a chunk of 8,192 at 2^log_e a thread.
constexpr int chunk_threads(int log_e) {
  return ((1 << kMaxLogChunk) >> log_e) < 1024 ? ((1 << kMaxLogChunk) >> log_e) : 1024;
}

// One chunk of 2^log_chunk elements of a row per block, 2^kLogE
// consecutive elements a thread: the stages (k, j), k from k_lo to k_hi,
// j from min(k - 1, j_hi) down to j_lo (all j < log_chunk). Reads the
// input (index = row position) or the scratch; writes the scratch, or the
// outputs with the payload gathered. In place on the scratch: a thread
// reads and writes the same positions, all reads before any write.
template <int kLogE>
__global__ void __launch_bounds__(chunk_threads(kLogE))
bitonic_sort_chunk_kernel(Buffers buf, int log_length, int log_chunk,
                          int k_lo, int k_hi, int j_hi, int j_lo, int src,
                          int dst) {
  constexpr int E = 1 << kLogE;
  constexpr int kLogWarpSpan = kLogE + 5;   // strides below it: one warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = 1 << log_chunk;
  const int padded = chunk + chunk / 32;
  float* shared_keys = reinterpret_cast<float*>(smem);               // [2][padded]
  uint16_t* shared_index = reinterpret_cast<uint16_t*>(shared_keys + 2 * padded);
  const size_t row = static_cast<size_t>(blockIdx.y) << log_length;
  const int local0 = threadIdx.x * E;                      // in the chunk
  const int first = (blockIdx.x << log_chunk) + local0;    // in the row

  float key[E];
  uint32_t index[E];
  const float* keys_in = src == kSrcInput ? buf.keys : buf.scratch_keys;
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(keys_in + row + first)[q];
    key[4 * q] = v.x;
    key[4 * q + 1] = v.y;
    key[4 * q + 2] = v.z;
    key[4 * q + 3] = v.w;
  }
  if (src == kSrcInput) {
#pragma unroll
    for (int e = 0; e < E; ++e) index[e] = first + e;
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint2 v = reinterpret_cast<const uint2*>(buf.scratch_index + row + first)[q];
      index[4 * q] = v.x & 0xffffu;
      index[4 * q + 1] = v.x >> 16;
      index[4 * q + 2] = v.y & 0xffffu;
      index[4 * q + 3] = v.y >> 16;
    }
  }

  int buffer = 0;
  for (int k = k_lo; k <= k_hi; ++k) {
    // bit k of the row position, the same for all of a thread's elements
    // where k >= kLogE, and so at every stage that crosses threads
    const bool desc = descending(first, k);
    for (int j = min(k - 1, j_hi); j >= j_lo; --j) {
      if (j < kLogE) {
        register_stage<kLogE>(key, index, j, k, sign_of(desc));
      } else if (j < kLogWarpSpan) {
        const int lane_bit = 1 << (j - kLogE);
        const float sign = sign_of(((threadIdx.x & lane_bit) == 0) == desc);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float pk = __shfl_xor_sync(0xffffffffu, key[e], lane_bit);
          const uint32_t pi = __shfl_xor_sync(0xffffffffu, index[e], lane_bit);
          exchange(key[e], index[e], pk, pi, sign);
        }
      } else {
        float* sk = shared_keys + buffer * padded;
        uint16_t* si = shared_index + buffer * padded;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int l = local0 + e;
          sk[l + (l >> 5)] = key[e];
          si[l + ((l >> 6) << 1)] = static_cast<uint16_t>(index[e]);
        }
        __syncthreads();
        const int stride = 1 << j;
        const float sign = sign_of(((local0 & stride) == 0) == desc);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int l = (local0 + e) ^ stride;
          exchange(key[e], index[e], sk[l + (l >> 5)], si[l + ((l >> 6) << 1)], sign);
        }
        buffer ^= 1;
      }
    }
  }

  if (dst == kDstOutput) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      reinterpret_cast<float4*>(buf.keys_out + row + first)[q] =
          make_float4(key[4 * q], key[4 * q + 1], key[4 * q + 2], key[4 * q + 3]);
      reinterpret_cast<int4*>(buf.payload_out + row + first)[q] = make_int4(
          buf.payload[row + index[4 * q]], buf.payload[row + index[4 * q + 1]],
          buf.payload[row + index[4 * q + 2]], buf.payload[row + index[4 * q + 3]]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      reinterpret_cast<float4*>(buf.scratch_keys + row + first)[q] =
          make_float4(key[4 * q], key[4 * q + 1], key[4 * q + 2], key[4 * q + 3]);
      reinterpret_cast<uint2*>(buf.scratch_index + row + first)[q] =
          make_uint2(index[4 * q] | (index[4 * q + 1] << 16),
                     index[4 * q + 2] | (index[4 * q + 3] << 16));
    }
  }
}

// The stages (k, j), j from j_hi down to j_lo (log_chunk <= j < k = log_chunk
// + kLogG), on the scratch in place: a thread holds the 2^kLogG elements at
// stride 2^log_chunk of one 2^k-block, at one offset in the chunk;
// neighbouring threads take neighbouring offsets.
template <int kLogG>
__global__ void __launch_bounds__(kStridedThreads)
bitonic_sort_strided_kernel(Buffers buf, int log_length, int log_chunk, int k,
                            int j_hi, int j_lo) {
  constexpr int G = 1 << kLogG;
  const size_t row = static_cast<size_t>(blockIdx.y) << log_length;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int base = ((t >> log_chunk) << k) + (t & ((1 << log_chunk) - 1));
  float key[G];
  uint32_t index[G];
#pragma unroll
  for (int m = 0; m < G; ++m) {
    key[m] = buf.scratch_keys[row + base + (m << log_chunk)];
    index[m] = buf.scratch_index[row + base + (m << log_chunk)];
  }
  const float sign = sign_of(descending(base, k));
#pragma unroll
  for (int jj = kLogG - 1; jj >= 0; --jj) {
    if (jj + log_chunk > j_hi || jj + log_chunk < j_lo) continue;
#pragma unroll
    for (int m = 0; m < G; ++m) {
      if ((m & (1 << jj)) == 0) {
        exchange_pair(key[m], index[m], key[m | (1 << jj)], index[m | (1 << jj)], sign);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < G; ++m) {
    buf.scratch_keys[row + base + (m << log_chunk)] = key[m];
    buf.scratch_index[row + base + (m << log_chunk)] = static_cast<uint16_t>(index[m]);
  }
}

using ChunkKernel = void (*)(Buffers, int, int, int, int, int, int, int, int);
using StridedKernel = void (*)(Buffers, int, int, int, int, int);

ChunkKernel chunk_kernel(int log_per_thread) {
  switch (log_per_thread) {
    case 2: return bitonic_sort_chunk_kernel<2>;
    case 3: return bitonic_sort_chunk_kernel<3>;
    case 4: return bitonic_sort_chunk_kernel<4>;
    default: return nullptr;
  }
}

StridedKernel strided_kernel(int log_per_thread) {
  switch (log_per_thread) {
    case 1: return bitonic_sort_strided_kernel<1>;
    case 2: return bitonic_sort_strided_kernel<2>;
    case 3: return bitonic_sort_strided_kernel<3>;
    default: return nullptr;
  }
}

// The dynamic shared-memory opt-in, once per chunk kernel and device.
cudaError_t allow_shared_memory(ChunkKernel fn, int log_per_thread) {
  static bool done[kMaxDevices][5];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device][log_per_thread]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device][log_per_thread] = true;
  return err;
}

// A plan row's geometry against what its kernel does (a plan that asked
// for other stages would be sorted wrong, not refused, by the launch).
bool row_ok(const int32_t* r, int rows) {
  const int length = 1 << r[kLogLength];
  const bool common =
      r[kLogLength] >= 7 && r[kLogLength] <= kMaxLogLength && r[kLogChunk] >= 0 &&
      r[kLogChunk] <= kMaxLogChunk && r[kLogChunk] <= r[kLogLength] &&
      r[kThreads] > 0 && r[kBlocksPerRow] > 0 && rows <= 65535 &&
      r[kSmemBytes] >= 0 && r[kSmemBytes] <= kMaxSmemBytes &&
      r[kKLo] >= 1 && r[kKLo] <= r[kKHi] && r[kKHi] <= r[kLogLength] &&
      r[kJLo] >= 0 && r[kJLo] <= r[kJHi];
  if (!common) return false;
  if (r[kOp] == kOpChunk) {
    const int needs_smem = r[kLogChunk] > r[kLogPerThread] + 5;
    const int smem = 2 * ((1 << r[kLogChunk]) + (1 << r[kLogChunk]) / 32) * 6;
    return r[kJHi] < r[kLogChunk] &&
           (r[kThreads] << r[kLogPerThread]) == (1 << r[kLogChunk]) &&
           r[kThreads] % 32 == 0 && r[kThreads] <= chunk_threads(r[kLogPerThread]) &&
           (r[kBlocksPerRow] << r[kLogChunk]) == length &&
           (!needs_smem || r[kSmemBytes] >= smem) &&
           (r[kSrc] == kSrcInput || r[kSrc] == kSrcScratch) &&
           (r[kDst] == kDstScratch || r[kDst] == kDstOutput);
  }
  if (r[kOp] == kOpStrided) {
    return r[kKLo] == r[kKHi] && r[kKLo] == r[kLogChunk] + r[kLogPerThread] &&
           r[kJLo] >= r[kLogChunk] && r[kJHi] < r[kKLo] &&
           r[kThreads] <= kStridedThreads &&
           static_cast<long>(r[kThreads]) * r[kBlocksPerRow] ==
               (length >> r[kLogPerThread]) &&
           r[kSrc] == kSrcScratch && r[kDst] == kDstScratch;
  }
  return false;
}

}  // namespace

// keys, keys_out: fp32 [rows, P]; payload, payload_out: int32 [rows, P];
// all contiguous and 16-byte aligned, outputs distinct from inputs.
// scratch_keys (fp32) and scratch_index (uint16), [rows, P] each, hold the
// pairs between launches (null for a plan of one launch). `plan` is
// n_launches rows of kFields int32 (ops/bitonic.py::Launch). Issues the
// plan's launches on `stream` in order and returns the first nonzero
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a row
// its kernel cannot do, before any launch; never synchronizes.
extern "C" int salt_bitonic_sort_desc(const void* keys, const void* payload,
                                      void* keys_out, void* payload_out,
                                      void* scratch_keys, void* scratch_index,
                                      int rows, const int32_t* plan,
                                      int n_launches, void* stream) {
  if (rows <= 0) return 0;
  if (plan == nullptr || n_launches <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_launches; ++l) {
    const int32_t* r = plan + l * kFields;
    const bool kernel = r[kOp] == kOpChunk ? chunk_kernel(r[kLogPerThread]) != nullptr
                                           : strided_kernel(r[kLogPerThread]) != nullptr;
    const bool uses_scratch = r[kSrc] == kSrcScratch || r[kDst] == kDstScratch;
    if (!kernel || !row_ok(r, rows) || (uses_scratch && (!scratch_keys || !scratch_index))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Buffers buf{static_cast<const float*>(keys), static_cast<const int32_t*>(payload),
                    static_cast<float*>(keys_out), static_cast<int32_t*>(payload_out),
                    static_cast<float*>(scratch_keys), static_cast<uint16_t*>(scratch_index)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < n_launches; ++l) {
    const int32_t* r = plan + l * kFields;
    const dim3 grid(r[kBlocksPerRow], rows);
    if (r[kOp] == kOpChunk) {
      const ChunkKernel fn = chunk_kernel(r[kLogPerThread]);
      if (r[kSmemBytes] > 0) {
        const cudaError_t err = allow_shared_memory(fn, r[kLogPerThread]);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      fn<<<grid, r[kThreads], r[kSmemBytes], s>>>(buf, r[kLogLength], r[kLogChunk], r[kKLo],
                                                  r[kKHi], r[kJHi], r[kJLo], r[kSrc], r[kDst]);
    } else {
      strided_kernel(r[kLogPerThread])<<<grid, r[kThreads], 0, s>>>(
          buf, r[kLogLength], r[kLogChunk], r[kKLo], r[kJHi], r[kJLo]);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
