// What the flash attention kernels on the tensor cores share: the forward
// (csrc/flash_attention.cu, flash_fwd_tc_kernel) and the backward
// (csrc/flash_attention_bwd.cu, flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel).  All three read [batch][heads][rows][D] bf16
// tensors through 4-D TMA maps in [rows][64] boxes (128-byte swizzle, so
// one box is both a K-major operand, rows 128 bytes apart, and an MN-major
// one, 64-wide chunks box-size apart), run their m64 products on wgmma
// (gemm_sm90.cuh) and feed a product's f32 accumulator back as the
// register A of the next one, rounded to bf16 in place.
#pragma once

#include "gemm_sm90.cuh"

namespace flash_tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 64 * 64 * 2;  // one [64 rows][64] bf16 box, bytes

// 2^x (PTX ex2.approx: relative error ~2^-22; results below 2^-126 are 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64, N] += A[64, 16]·B[16, N], A and B both K-major in shared memory
// (N = 64 or 128): S = Q·Kᵀ and its kin.
template <int N>
__device__ __forceinline__ void mma_kk(float (&d)[N / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (N == 128) tc::wgmma_n128<0, 0>(d, a, b, 1);
  else tc::wgmma_n64<0, 0>(d, a, b, 1);
}

// d[64, N] += A[64, 16]·B[16, N], A in registers (an m64 accumulator
// rounded to bf16 by to_a), B MN-major in shared memory: P·V and its kin.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) tc::wgmma_rs_n128(d, a, b);
  else tc::wgmma_rs_n64(d, a, b);
}

// An m64nK accumulator (K a multiple of 16) as wgmma's register A for the
// k16 steps over its columns: step kk's four registers are the pairs
// 8 kk + {0, 2, 4, 6}, each rounded to bf16.
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K / 16][4],
                                     const float (&acc)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// The 4-D map of a bf16 tensor [batch][heads][rows][D] with element strides
// (sb, sh, sr) and a contiguous D, read in boxes of (64, box_rows, 1, 1),
// 128-byte swizzle, zeros past the edges.
inline cudaError_t map_4d(CUtensorMap* map, const void* ptr, int B, int H,
                          int rows, int D, int64_t sb, int64_t sh, int64_t sr,
                          int box_rows) {
  tc::EncodeTiled fn = tc::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || sb % 8 || sh % 8 || sr % 8)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sr) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace flash_tc
