// Helpers shared by the port's CUDA kernels: f32 <-> storage type, and the
// reference's finite mask value.
#pragma once

#include <cuda_bf16.h>

constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round p to the storage type of v, as p.astype(v.dtype) does
template <typename T> __device__ __forceinline__ float round_as(float x) { return to_f(from_f<T>(x)); }
