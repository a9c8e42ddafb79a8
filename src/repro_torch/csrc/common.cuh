// Shared helpers of the port's CUDA kernels: element loads/stores in f32,
// the reference's masking sentinel and the C error-string entry point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

// Masked scores are -1e30, not -inf, as in the reference kernels: a tile
// whose entries are all masked then yields p = exp(0) = 1 for them, which
// the online softmax washes out once a real score raises the running max.
#define REPRO_NEG_INF (-1e30f)

enum ReproDtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
