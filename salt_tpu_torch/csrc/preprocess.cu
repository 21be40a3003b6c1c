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
// Design: one thread per output pixel. The edge pad is a clamp of the
// source coordinates, src[clamp(i - 13)][clamp(j - 14)], so there is no
// padded intermediate and no concatenate/broadcast blocks as in the Pallas
// kernel; each input byte is read from device memory once (neighbouring
// threads of a warp read neighbouring bytes, the clamped border pixels hit
// in cache) and each output element is written once, by consecutive
// threads to consecutive addresses. The fp32 arithmetic uses round-to-
// nearest intrinsics in the order of the plain torch version
// (ops/preprocess.py::preprocess_inference) so nvcc cannot contract or
// reorder it; bf16 rounding is round-to-nearest-even like torch's cast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRaw = 101;
constexpr int kNet = 128;
constexpr int kTop = 13;   // get_crop_pad_sequence(27, 27) = (13, 13, 14, 14)
constexpr int kLeft = 14;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.linspace(0, 1, 128)[i]: start + step * i on the first half,
// end - step * (steps - 1 - i) on the second.
__device__ __forceinline__ float ramp_at(int i) {
  const float step = __fdiv_rn(1.0f, static_cast<float>(kNet - 1));
  return i < kNet / 2 ? __fmul_rn(step, static_cast<float>(i))
                      : __fsub_rn(1.0f, __fmul_rn(step, static_cast<float>(kNet - 1 - i)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
preprocess_inference_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst,
                            int n_pixels) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_pixels) return;
  const int j = idx % kNet;
  const int i = (idx / kNet) % kNet;
  const int b = idx / (kNet * kNet);
  const int si = min(max(i - kTop, 0), kRaw - 1);
  const int sj = min(max(j - kLeft, 0), kRaw - 1);
  const float x = __fdiv_rn(static_cast<float>(src[(b * kRaw + si) * kRaw + sj]), 255.0f);
  const float gray = __fdiv_rn(__fsub_rn(x, 0.485f), 0.229f);
  const float ramp = ramp_at(i);
  T* out = dst + static_cast<size_t>(idx) * 3;
  out[0] = from_float<T>(gray);
  out[1] = from_float<T>(ramp);
  out[2] = from_float<T>(__fmul_rn(gray, ramp));
}

}  // namespace

// src: uint8 [batch, 101, 101] contiguous; dst: [batch, 128, 128, 3]
// contiguous, bf16 when out_bf16 != 0 else fp32. Launches on `stream`
// and returns cudaGetLastError() (0 on success); never synchronizes.
extern "C" int salt_preprocess_inference(const void* src, void* dst, int batch,
                                         int out_bf16, void* stream) {
  const int n_pixels = batch * kNet * kNet;
  if (n_pixels <= 0) return 0;
  const dim3 grid((n_pixels + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_bf16) {
    preprocess_inference_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(dst), n_pixels);
  } else {
    preprocess_inference_kernel<float><<<grid, kThreads, 0, s>>>(
        in, static_cast<float*>(dst), n_pixels);
  }
  return static_cast<int>(cudaGetLastError());
}
