// Shared helpers of the repro_torch CUDA kernels: f32 <-> storage-type
// conversion through the CUDA intrinsics, and the dtype codes the Python
// wrappers pass (0 = float32, 1 = bfloat16, 2 = int8 codes, 3 =
// float8_e4m3fn codes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat8E4M3 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// A 1-byte quantization code as f32: exact for every int8 and every
// float8_e4m3fn value (subnormals included; the fp8 path converts through
// the hardware's e4m3 -> f16 conversion, which is exact).
__device__ __forceinline__ float int8_to_f32(uint8_t c) {
  return (float)(int8_t)c;
}
__device__ __forceinline__ float e4m3_to_f32(uint8_t c) {
  __nv_fp8_e4m3 v;
  v.__x = c;
  return static_cast<float>(v);
}

}  // namespace repro_torch
