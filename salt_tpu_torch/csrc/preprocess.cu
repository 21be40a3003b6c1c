// Fused inference preprocess for the H100 (sm_90a), plain C interface
// loaded with ctypes by salt_tpu_torch/ops/preprocess_kernel.py.
//
// Replaces the TPU kernel salt_tpu/ops/pallas_preprocess.py
// (_kernel :38-64, called through preprocess_inference_pallas :67-89).
//
// What it computes, per image: uint8 [101, 101] -> x / 255 -> edge pad to
// 128 x 128 (top 13, bottom 14, left 14, right 13) -> gray = (x - 0.485)
// / 0.229 -> three channels (gray, ramp, gray * ramp), ramp =
// linspace(0, 1, 128) down the rows. Output is NHWC, [B, 128, 128, 3] in
// bf16 or fp32: the bytes of a [B, 3, 128, 128] tensor in channels_last,
// the layout the first convolution reads.
//
// Bound: pure data movement. Per image it must read 10,201 B and write
// 98,304 B (bf16) = 108,505 B; at 3.35 TB/s that is ~32 ns per image,
// ~1.6 us for a 48-image serve batch (24 images x 2 hflip-TTA passes).
// Arithmetic is a handful of FLOPs per output and never the limit.
//
// Design: one thread per 16-byte chunk of an output row, written with one
// 16-byte store, consecutive threads on consecutive chunks, so every
// warp-wide store is whole 128-byte lines. A row is 384 elements: 48
// chunks of 8 in bf16, 96 of 4 in fp32; element e is pixel e / 3, channel
// e % 3. A block takes 12 KB of output rows of one image (16 rows in
// bf16, 8 in fp32; grid: images x bands, no flat-index division), 384
// threads of 2 chunks each, blockDim apart, so that a 48-image bf16 batch
// is 384 blocks, one wave. The edge pad is a clamp of the source
// coordinates, src[clamp(i - 13)][clamp(j - 14)], so there is no padded
// intermediate. The input is read with byte loads (a view of a batch may
// start at any byte), issued first. While they are in flight the block
// builds two tables in shared memory: the gray value of each of the 256
// byte values and the ramp of each of its rows. Computed per pixel, their
// IEEE divisions (two for a gray value, one for a ramp) set the pace of a
// kernel this short (PERF.md, row 1); a chunk looks up its at most 4
// pixels and its row's ramp and does one multiply for gray * ramp. The
// fp32 arithmetic uses round-to-nearest intrinsics in the order of the
// plain torch version (ops/preprocess.py::preprocess_inference) so nvcc
// cannot contract or reorder it, and a table entry is the value the same
// expression gives per pixel; bf16 rounding is round-to-nearest-even like
// torch's cast.
//
// Switches (-D, for tools/preprocess_ab.py; the defaults are the kernel):
// SALT_PRE_CHUNKS chunks a thread; SALT_PRE_ROWS output rows a block in
// bf16 (half as many in fp32); SALT_PRE_STAGE the band's source rows
// staged in shared memory first; SALT_PRE_LUT 0 the gray values and the
// ramp computed per chunk; SALT_PRE_V1 the earlier one-thread-per-pixel
// kernel with 2- or 4-byte stores; two diagnostics, whose output is wrong
// by design: SALT_PRE_NO_LOADS made-up bytes in place of the loads,
// SALT_PRE_STORES_ONLY the stores with no loads and no arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SALT_PRE_CHUNKS
#define SALT_PRE_CHUNKS 2
#endif
#ifndef SALT_PRE_ROWS
#define SALT_PRE_ROWS 16
#endif
#ifndef SALT_PRE_STAGE
#define SALT_PRE_STAGE 0
#endif
#ifndef SALT_PRE_LUT
#define SALT_PRE_LUT 1
#endif
#ifndef SALT_PRE_V1
#define SALT_PRE_V1 0
#endif
#ifndef SALT_PRE_STORES_ONLY
#define SALT_PRE_STORES_ONLY 0
#endif
#ifndef SALT_PRE_NO_LOADS
#define SALT_PRE_NO_LOADS 0
#endif

namespace {

constexpr int kRaw = 101;
constexpr int kNet = 128;
constexpr int kTop = 13;   // get_crop_pad_sequence(27, 27) = (13, 13, 14, 14)
constexpr int kLeft = 14;
constexpr int kRowElems = kNet * 3;
constexpr int kChunks = SALT_PRE_CHUNKS;
constexpr int kRows16 = SALT_PRE_ROWS;     // output rows a block, bf16
constexpr bool kStage = SALT_PRE_STAGE != 0;
constexpr bool kLut = SALT_PRE_LUT != 0;

// output rows of a block: kRows16 in bf16, half as many in fp32, so that
// a block writes the same bytes (12 KB at 16) and has the same threads
template <typename T>
__host__ __device__ constexpr int block_rows() {
  return kRows16 * 2 / static_cast<int>(sizeof(T));
}
static_assert(kRows16 % 2 == 0 && kNet % kRows16 == 0,
              "a block's rows divide the image in both types");

// threads of a block: its rows of chunks, kChunks chunks each
template <typename T>
__host__ __device__ constexpr int block_threads() {
  return block_rows<T>() * (kRowElems * static_cast<int>(sizeof(T)) / 16) / kChunks;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.linspace(0, 1, 128)[i] as torch computes it on the card: start +
// step * i on the first half, end - step * (steps - 1 - i) on the second
// (torch's CPU linspace rounds 9 of the 128 values one ulp apart).
__device__ __forceinline__ float ramp_at(int i) {
  const float step = __fdiv_rn(1.0f, static_cast<float>(kNet - 1));
  return i < kNet / 2 ? __fmul_rn(step, static_cast<float>(i))
                      : __fsub_rn(1.0f, __fmul_rn(step, static_cast<float>(kNet - 1 - i)));
}

__device__ __forceinline__ float gray_of(uint8_t v) {
  const float x = __fdiv_rn(static_cast<float>(v), 255.0f);
  return __fdiv_rn(__fsub_rn(x, 0.485f), 0.229f);
}

__device__ __forceinline__ int clamp_src(int v) {
  return min(max(v, 0), kRaw - 1);
}

#if SALT_PRE_V1

// One thread per output pixel, its three channels stored one by one.
template <typename T>
__global__ void __launch_bounds__(256)
preprocess_inference_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst, int n_pixels) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= n_pixels) return;
  const int j = idx % kNet;
  const int i = (idx / kNet) % kNet;
  const int b = idx / (kNet * kNet);
  T* out = dst + static_cast<size_t>(idx) * 3;
#if SALT_PRE_STORES_ONLY
  out[0] = out[1] = out[2] = from_float<T>(static_cast<float>(j));
#else
  const float gray = gray_of(src[(b * kRaw + clamp_src(i - kTop)) * kRaw + clamp_src(j - kLeft)]);
  const float ramp = ramp_at(i);
  out[0] = from_float<T>(gray);
  out[1] = from_float<T>(ramp);
  out[2] = from_float<T>(__fmul_rn(gray, ramp));
#endif
}

#else

// The kElems values of the chunk whose first element e0 has e0 % 3 == kR:
// element k is channel (kR + k) % 3 of pixel p0 + (kR + k) / 3, all
// compile-time indices once the loop is unrolled.
template <int kElems, int kR>
__device__ __forceinline__ void chunk_values(const float (&g)[4], float ramp,
                                             float (&v)[kElems]) {
#pragma unroll
  for (int k = 0; k < kElems; ++k) {
    const int q = (kR + k) / 3, c = (kR + k) % 3;
    v[k] = c == 0 ? g[q] : (c == 1 ? ramp : __fmul_rn(g[q], ramp));
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo, .y = hi
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

template <typename T>
__global__ void __launch_bounds__(block_threads<T>())
preprocess_inference_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst) {
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));   // per chunk
  constexpr int kChunksPerRow = kRowElems / kElems;
  constexpr int kThreads = block_threads<T>();
  constexpr int kRows = block_rows<T>();
  // a chunk starting at channel 0-2 spans pixels p0 .. p0 + kPix - 1
  constexpr int kPix = (kElems + 1) / 3 + 1;
  static_assert(kThreads <= 1024 && kThreads % 32 == 0, "a block of whole warps");
  const int i0 = blockIdx.y * kRows;                // first output row
  const size_t image = blockIdx.x;
  uint4* out = reinterpret_cast<uint4*>(dst + (image * kNet + i0) * kRowElems);
#if SALT_PRE_STORES_ONLY
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int chunk = threadIdx.x + k * kThreads;
    out[chunk] = make_uint4(chunk, k, i0, 0);
  }
#else
  __shared__ float gray_lut[256];                   // gray_of(v), v = 0..255
  __shared__ float ramps[kRows];
  __shared__ uint8_t staged[kStage ? kRows * kRaw : 1];
  const int s0 = clamp_src(i0 - kTop);              // first source row
  const uint8_t* rows = src + (image * kRaw + s0) * kRaw;
  // 1. the bytes of this thread's pixels (or the band's source rows) are
  // in flight while the tables are built
  // each chunk's first element in its row, its source row's offset
  int col[kChunks], off[kChunks];
  uint8_t px[kChunks][kPix];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int chunk = threadIdx.x + k * kThreads;   // in the band
    const int r = chunk / kChunksPerRow;            // constant divisor
    col[k] = (chunk - r * kChunksPerRow) * kElems;
    off[k] = (clamp_src(i0 + r - kTop) - s0) * kRaw;
    if constexpr (!kStage) {
#pragma unroll
      for (int q = 0; q < kPix; ++q)
#if SALT_PRE_NO_LOADS
        px[k][q] = static_cast<uint8_t>(off[k] + col[k] + q);
#else
        px[k][q] = rows[off[k] + clamp_src(col[k] / 3 + q - kLeft)];
#endif
    }
  }
  if constexpr (kStage) {
    const int n = (clamp_src(i0 + kRows - 1 - kTop) - s0 + 1) * kRaw;
    for (int t = threadIdx.x; t < n; t += kThreads) staged[t] = rows[t];
  }
  if constexpr (kLut) {
    for (int t = threadIdx.x; t < 256; t += kThreads)
      gray_lut[t] = gray_of(static_cast<uint8_t>(t));
    if (threadIdx.x < kRows) ramps[threadIdx.x] = ramp_at(i0 + threadIdx.x);
  }
  if constexpr (kLut || kStage) __syncthreads();
  // 2. values from the tables, one 16-byte store per chunk
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int chunk = threadIdx.x + k * kThreads;
    const int p0 = col[k] / 3;
    float g[4];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if constexpr (kStage) px[k][q] = staged[off[k] + clamp_src(p0 + q - kLeft)];
      g[q] = kLut ? gray_lut[px[k][q]] : gray_of(px[k][q]);
    }
    const int r = chunk / kChunksPerRow;
    const float ramp = kLut ? ramps[r] : ramp_at(i0 + r);
    float v[kElems];
    switch (col[k] - p0 * 3) {
      case 0: chunk_values<kElems, 0>(g, ramp, v); break;
      case 1: chunk_values<kElems, 1>(g, ramp, v); break;
      default: chunk_values<kElems, 2>(g, ramp, v); break;
    }
    out[chunk] = pack(v);
  }
#endif
}

#endif  // SALT_PRE_V1

template <typename T>
int launch(const uint8_t* src, T* dst, int batch, cudaStream_t stream) {
#if SALT_PRE_V1
  const int n_pixels = batch * kNet * kNet;
  preprocess_inference_kernel<T><<<(n_pixels + 255) / 256, 256, 0, stream>>>(src, dst, n_pixels);
#else
  const dim3 grid(batch, kNet / block_rows<T>());
  preprocess_inference_kernel<T><<<grid, block_threads<T>(), 0, stream>>>(src, dst);
#endif
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: uint8 [batch, 101, 101] contiguous, at any byte offset; dst:
// [batch, 128, 128, 3] contiguous and 16-byte aligned, bf16 when
// out_bf16 != 0 else fp32. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronizes.
extern "C" int salt_preprocess_inference(const void* src, void* dst, int batch,
                                         int out_bf16, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  return out_bf16 ? launch(in, static_cast<__nv_bfloat16*>(dst), batch, s)
                  : launch(in, static_cast<float*>(dst), batch, s);
}
