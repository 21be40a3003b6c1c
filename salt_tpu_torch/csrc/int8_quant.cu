// Per-row abs-max quantization to s8 for the H100 (sm_90a), plain C
// interface loaded with ctypes by salt_tpu_torch/ops/int8_conv.py.
//
// No TPU kernel: the JAX package's int8 convs are AQT's XLA convolution
// (salt_tpu/models/quant.py:24-34). This is its operand quantizer, for the
// activation of a conv (a row is one image of its NHWC bytes) and for its
// weight (a row is one output channel of [O, KH, KW, C_in / groups]).
//
// What it computes, per row of L values in D (fp32 or bf16), each step
// rounded to D as the JAX package's compiled AQT does (ops/int8_conv.py):
//   absmax = max |x| (1 where it is 0)
//   scale  = D(absmax * f32(1 / 127.5))        (XLA's form of absmax / 127.5)
//   inv    = D(1 / scale), 1 where it is infinite
//   q      = rint(clamp(D(x * inv), -127, 127))  (round half to even)
// and writes q as int8 and scale as fp32. In bf16 each product of two
// bf16 values is exact in fp32, so rounding it to bf16 once is bf16
// arithmetic; the IEEE division (nvcc without fast math) rounded to
// bf16 is the correctly rounded bf16 quotient (24 >= 2 * 8 + 2 bits).
//
// Bound: bytes. A row is read twice (the abs-max, then the values) and
// its int8 values written once: 2 L sizeof(D) + L bytes; the bound counts
// the least the function needs, one read and one write, L sizeof(D) + L.
//
// Design: two launches. Pass 1 gives each block one chunk of one row
// (grid: chunks x rows) and writes the chunk's abs-max to a partial
// buffer; pass 2 (the same grid) reduces the row's partials in its first
// warp, computes the scale and the reciprocal, then quantizes its chunk.
// No atomics and no zeroed buffer; a block of the first chunk writes the
// row's scale. Loads are 16 bytes a thread where the rows allow it (L a
// multiple of 8 and an aligned base), else one value a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// float32(1 / 127.5) = 0x3c008081, the factor XLA puts in place of / 127.5
constexpr float kInvEdge = 0.007843137718737125f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one value rounded to D, as a float
template <bool kBf16>
__device__ __forceinline__ float round_d(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// the values of one 16-byte load: 8 bf16 or 4 fp32
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(uint4 u, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(uint4 u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_max(float v) {
  __shared__ float warps[kThreads / 32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? warps[lane] : 0.f;
  return warp_max(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, float* __restrict__ partial,
              long long len, int chunk, int parts, int vec) {
  const int p = blockIdx.x, r = blockIdx.y;
  const long long lo = (long long)p * chunk;
  const long long hi = lo + chunk < len ? lo + chunk : len;
  const T* row = x + (long long)r * len;
  float m = 0.f;
  if (vec) {
    constexpr int kN = Vec16<T>::kN;
    for (long long i = lo + (long long)threadIdx.x * kN; i < hi;
         i += (long long)kThreads * kN) {
      float v[kN];
      unpack(*reinterpret_cast<const uint4*>(row + i), v, T());
#pragma unroll
      for (int j = 0; j < kN; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      m = fmaxf(m, fabsf(to_float(row[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partial[(long long)r * parts + p] = m;
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, const float* __restrict__ partial,
             int8_t* __restrict__ q, float* __restrict__ scale,
             long long len, int chunk, int parts, int vec) {
  __shared__ float inv_shared;
  const int p = blockIdx.x, r = blockIdx.y;
  if (threadIdx.x < 32) {
    float m = 0.f;
    for (int i = threadIdx.x; i < parts; i += 32)
      m = fmaxf(m, partial[(long long)r * parts + i]);
    m = warp_max(m);
    if (threadIdx.x == 0) {
      const float absmax = m == 0.f ? 1.f : m;
      const float s = round_d<kBf16>(__fmul_rn(absmax, kInvEdge));
      float inv = round_d<kBf16>(__fdiv_rn(1.f, s));
      if (isinf(inv)) inv = 1.f;
      inv_shared = inv;
      if (p == 0) scale[r] = s;
    }
  }
  __syncthreads();
  const float inv = inv_shared;
  const long long lo = (long long)p * chunk;
  const long long hi = lo + chunk < len ? lo + chunk : len;
  const T* row = x + (long long)r * len;
  int8_t* out = q + (long long)r * len;
  if (vec) {
    constexpr int kN = Vec16<T>::kN;
    for (long long i = lo + (long long)threadIdx.x * kN; i < hi;
         i += (long long)kThreads * kN) {
      float v[kN];
      unpack(*reinterpret_cast<const uint4*>(row + i), v, T());
      uint32_t packed[kN / 4];
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) packed[j] = 0;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float y = fminf(fmaxf(round_d<kBf16>(__fmul_rn(v[j], inv)),
                                    -127.f), 127.f);
        packed[j / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(y)
                         << (8 * (j % 4));
      }
      if constexpr (kN == 8) {
        *reinterpret_cast<uint2*>(out + i) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<uint32_t*>(out + i) = packed[0];
      }
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float y = fminf(fmaxf(
          round_d<kBf16>(__fmul_rn(to_float(row[i]), inv)), -127.f), 127.f);
      out[i] = (int8_t)__float2int_rn(y);
    }
  }
}

template <typename T, bool kBf16>
int launch(const T* x, float* partial, int8_t* q, float* scale,
           long long len, int rows, int parts, int chunk, cudaStream_t s) {
  constexpr int kN = Vec16<T>::kN;
  const int vec = len % kN == 0 && chunk % kN == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(parts, rows);
  absmax_kernel<T><<<grid, kThreads, 0, s>>>(x, partial, len, chunk, parts,
                                             vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_kernel<T, kBf16><<<grid, kThreads, 0, s>>>(x, partial, q, scale, len,
                                                   chunk, parts, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [rows, len] (bf16 when in_bf16, else fp32), contiguous; partial
// [rows, parts] fp32 scratch; q [rows, len] int8; scale [rows] fp32.
extern "C" int salt_int8_quant(const void* x, void* partial, void* q,
                               void* scale, long long len, int rows,
                               int parts, int chunk, int in_bf16,
                               void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  if (parts <= 0 || chunk <= 0 || (long long)parts * chunk < len ||
      rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(scale);
  if (in_bf16)
    return launch<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(x),
                                       pp, qq, ss, len, rows, parts, chunk, s);
  return launch<float, false>(static_cast<const float*>(x), pp, qq, ss, len,
                              rows, parts, chunk, s);
}
