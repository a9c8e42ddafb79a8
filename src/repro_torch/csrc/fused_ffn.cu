// Fused SwiGLU FFN forward for Hopper, sm_90a:
//   y = (silu(x·Wg) ⊙ x·Wu)·Wd,   x [N,D], Wg/Wu [D,F], Wd [F,D].
//
// Replaces: src/repro/kernels/fused_ffn.py:50 _ffn_kernel (reached through
// _forward:71, pallas_call at :74).
//
// What bounds it on this card: at prefill (N in the thousands) the three
// products are O(N*D*F) operations against O((N+F)*D) bytes, so it is bound
// by operations; at decode (N = num_slots, 16) every weight byte is used
// N times only, so it is bound by the bytes of Wg, Wu and Wd.  This first
// version runs the products as f32 FMAs on the CUDA cores (tensor cores,
// wgmma, are for a later version).
//
// What the design does about it: one block owns BR rows (32, 16, 8, or 4
// where D is wide) and a range of F.
// The [BR,D] rows are staged once in shared memory as f32 and reused by
// every F tile; for each 32-wide F tile the block computes the [BR,32]
// hidden tile silu(g)·u (each lane one column, each warp BR/8 rows), parks
// it in shared memory and folds it into an f32 [BR,D] accumulator that
// also lives in shared memory, so the [N,F] hidden never reaches device
// memory.  The TPU grid walked the F blocks in order with a VMEM
// accumulator; here the F walk is a loop inside the block.  When there are
// too few row tiles to fill the card (decode), F is split across blocks:
// each split writes an f32 [N,D] partial to a [splits,N,D] workspace and a
// second small kernel adds the splits in order (deterministic, no atomics).
// Every weight byte is then read by exactly one block at decode.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBF = 32;        // F tile: one column per lane

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

template <typename T, int BR>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ wd,
               T* __restrict__ out, float* __restrict__ ws, int N, int D,
               int F, int f_per_split, int splits) {
  // hidden rows per warp; below 8 rows (wide D: jamba's 4096 takes BR 4)
  // only the first BR warps compute hidden rows, one each
  constexpr int RPW = BR >= 8 ? BR / 8 : 1;
  constexpr int kHiddenWarps = BR / RPW;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [BR][D]
  float* acc = xs + BR * D;     // [BR][D]
  float* hs = acc + BR * D;     // [BR][kBF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BR;
  const int split = blockIdx.y;
  const int f_begin = split * f_per_split;
  const int f_end = min(F, f_begin + f_per_split);

  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    xs[i] = row0 + r < N ? to_f32(x[(int64_t)(row0 + r) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  __syncthreads();

  for (int f0 = f_begin; f0 < f_end; f0 += kBF) {
    // hidden tile: lane -> column f0 + lane, warp -> rows warp*RPW + i
    const int f = f0 + lane;
    float g[RPW], u[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) g[i] = u[i] = 0.f;
    if (warp < kHiddenWarps && f < f_end) {
      const T* pg = wg + f;
      const T* pu = wu + f;
      for (int d = 0; d < D; d += 4) {  // D % 4 == 0 (checked by the wrapper)
        float a[4], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = to_f32(pg[(int64_t)(d + e) * F]);
          b[e] = to_f32(pu[(int64_t)(d + e) * F]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (warp * RPW + i) * D + d);
          g[i] = fmaf(xv.x, a[0], g[i]); u[i] = fmaf(xv.x, b[0], u[i]);
          g[i] = fmaf(xv.y, a[1], g[i]); u[i] = fmaf(xv.y, b[1], u[i]);
          g[i] = fmaf(xv.z, a[2], g[i]); u[i] = fmaf(xv.z, b[2], u[i]);
          g[i] = fmaf(xv.w, a[3], g[i]); u[i] = fmaf(xv.w, b[3], u[i]);
        }
      }
    }
    if (warp < kHiddenWarps) {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        hs[(warp * RPW + i) * kBF + lane] =
            f < f_end ? silu(g[i]) * u[i] : 0.f;
    }
    __syncthreads();

    // fold the hidden tile into the accumulator: thread -> columns d
    const int nf = min(kBF, f_end - f0);
    for (int d = tid; d < D; d += kThreads) {
      float w[kBF];
#pragma unroll
      for (int j = 0; j < kBF; ++j)
        w[j] = j < nf ? to_f32(wd[(int64_t)(f0 + j) * D + d]) : 0.f;
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {
        const float4* h4 = reinterpret_cast<const float4*>(hs + r * kBF);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kBF / 4; ++j) {
          const float4 h = h4[j];
          s = fmaf(h.x, w[4 * j], s);
          s = fmaf(h.y, w[4 * j + 1], s);
          s = fmaf(h.z, w[4 * j + 2], s);
          s = fmaf(h.w, w[4 * j + 3], s);
        }
        acc[r * D + d] += s;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (row0 + r >= N) continue;
    if (splits == 1)
      out[(int64_t)(row0 + r) * D + d] = from_f32<T>(acc[i]);
    else
      ws[((int64_t)split * N + row0 + r) * D + d] = acc[i];
  }
}

// out[i] = sum over splits of ws[s][i], in split order.
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ ws,
                                  T* __restrict__ out, int64_t n, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T, int BR>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* out, float* ws, int N, int D, int F,
                   int f_per_split, int splits, cudaStream_t stream) {
  auto kern = ffn_fwd_kernel<T, BR>;
  const int smem = (2 * BR * D + BR * kBF) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BR - 1) / BR, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), ws, N, D, F, f_per_split, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = (int64_t)N * D;
  const int blocks = (int)std::min<int64_t>((n + 255) / 256, 1024);
  ffn_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, static_cast<T*>(out),
                                                   n, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_br(int br, const void* x, const void* wg, const void* wu,
                        const void* wd, void* out, float* ws, int N, int D,
                        int F, int fps, int splits, cudaStream_t s) {
  switch (br) {
    case 4: return launch<T, 4>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
    case 8: return launch<T, 8>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
    case 16: return launch<T, 16>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
    case 32: return launch<T, 32>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [N,D], wg/wu [D,F], wd [F,D], out [N,D], all contiguous; ws [splits,N,D]
// f32 (unused when splits == 1).  br rows per block, f_per_split a multiple
// of 32.
extern "C" int repro_swiglu_ffn_fwd(const void* x, const void* wg,
                                    const void* wu, const void* wd, void* out,
                                    float* ws, int N, int D, int F, int br,
                                    int f_per_split, int splits, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_br<float>(br, x, wg, wu, wd, out, ws, N, D, F,
                              f_per_split, splits, s);
  if (dtype == kBF16)
    return dispatch_br<__nv_bfloat16>(br, x, wg, wu, wd, out, ws, N, D, F,
                                      f_per_split, splits, s);
  return cudaErrorInvalidValue;
}
