// Small device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference kernels' mask value

// dtype codes passed from the Python wrappers
enum DType : int { F32 = 0, BF16 = 1, FP8_E4M3 = 2, INT8 = 3 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements in one 16-byte load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 1-byte K/V types are quantized payloads: each stored (head, position)
// vector comes with an f32 scale, value = payload * scale.
template <typename T> struct Quantized { static constexpr bool value = sizeof(T) == 1; };

// One 16-byte load, widened to f32.  The caller guarantees alignment.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 16 fp8-e4m3fn payloads widened to f32.  The conversion operator is
// exact (every e4m3 value is an f32 value; NaN stays NaN, there is no inf).
__device__ __forceinline__ void load16(const __nv_fp8_e4m3* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&x);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(e[i]);
}
// 16 int8 payloads widened (sign-extended) to f32.
__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(e[i]);
}

__device__ __forceinline__ float warp_max(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro
