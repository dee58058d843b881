// Shared pieces of the two attention kernels (flash_attention.cu,
// decode_attention.cu): the masking constant, the input-type conversions
// and the warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace attn {

// A finite mask value, as the TPU kernels use: with -inf a fully masked
// tile would give inf - inf = NaN in the running-max correction.
constexpr float kNegInf = -1e30f;
// Floor of the softmax denominator at the end (the TPU kernels' 1e-30).
constexpr float kMinDenom = 1e-30f;
// Largest head dimension the kernels take.
constexpr int kMaxHd = 128;

// Input types: 0 = float32, 1 = bfloat16 (the dtype code of the C entry
// points); decode's K / V also 2 = float8_e4m3fn, 3 = float8_e5m2.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF8E4M3 = 2;
constexpr int kF8E5M2 = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Both fp8 formats widen to f32 exactly (cvt through f16 on sm_90).
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __nv_fp8_e4m3 from_f32<__nv_fp8_e4m3>(float x) {
  return __nv_fp8_e4m3(x);
}
template <>
__device__ __forceinline__ __nv_fp8_e5m2 from_f32<__nv_fp8_e5m2>(float x) {
  return __nv_fp8_e5m2(x);
}

// Max / sum over the `width` lanes of a group that starts at a multiple of
// `width` (xor shuffles stay inside the group).
template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy rows [row0, row0 + rows) of a (n, ...) tensor whose rows are `hd`
// contiguous elements `stride` elements apart into a (rows, ld) f32 tile,
// zero-filling rows at or past n.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t stride, int row0, int rows,
                                          int n, int hd, int ld,
                                          float* __restrict__ dst) {
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int g = row0 + r;
    dst[r * ld + d] =
        g < n ? to_f32(src[static_cast<size_t>(g) * stride + d]) : 0.f;
  }
}

}  // namespace attn
