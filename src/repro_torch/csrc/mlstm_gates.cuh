// The mLSTM chunk's gate statistics, shared by the forward
// (mlstm_scan.cu) and the backward (mlstm_scan_bwd.cu) kernels.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

// The chunk's gate statistics, one step a thread (L <= blockDim.x <= 512;
// thread t < L holds i[t] and f_log[t], the others 0): g[t] =
// Σ_{τ<=t} f_log[τ], a[t] = i[t] - g[t], cm[t] = max_{τ<=t} a[τ], by warp
// scans and the warps' totals added in order.  red: 32 floats.  Ends with
// a barrier.
__device__ __forceinline__ void gate_scan(float ig, float fl, int L,
                                          float* g, float* a, float* cm,
                                          float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x = fl;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += red[w];
  x += base;
  const float av = tid < L ? ig - x : -INFINITY;
  float mx = av;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, mx, o);
    if (lane >= o) mx = fmaxf(mx, y);
  }
  if (lane == 31) red[16 + warp] = mx;
  __syncthreads();
  for (int w = 0; w < warp; ++w) mx = fmaxf(mx, red[16 + w]);
  if (tid < L) {
    g[tid] = x;
    a[tid] = av;
    cm[tid] = mx;
  }
  __syncthreads();
}

}  // namespace
