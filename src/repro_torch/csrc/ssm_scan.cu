// Mamba selective scan for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ssm_scan.py:32 _ssm_kernel (reached through
// ssm_chunk_scan:65, pallas_call at :74), the chunk body of
// models/ssm.py::mamba.
//
// What it computes, per batch row b and inner channel d, over the time
// axis in order, from h = h0 (or zero):
//   a_t[n] = exp(dt_t · A[d,n]),  b_t[n] = (dt_t · x_t) · B_t[n],
//   h[n] = a_t[n] · h[n] + b_t[n],  y_t = Σ_n C_t[n] · h[n],
// and the final h.  dt [B,S,Di] and A [Di,N] are f32; x [B,S,Di] and
// B/C [B,S,N] are f32 or bf16 (the activation dtype), read into f32;
// y [B,S,Di] and h [B,Di,N] are f32.
//
// What bounds it on this card: each (b, t, d, n) costs one exp and about
// seven f32 operations, against 10 bytes per (b, t, d) (dt and y in f32,
// x in bf16) and next to nothing for B/C: at N = 16 that is ~13 operations
// per byte, below the f32 SIMT balance (67 TFLOP/s over 3.35 TB/s = 20), so
// the bytes bound it, with the exps (on the special-function units, a
// quarter of the f32 rate) close behind.
//
// What the design does about it: the TPU grid walked (b, Di-block, chunk)
// with the chunk axis sequential, built the [L, dblk, N] gates in VMEM and
// ran a log-depth associative scan over them.  Here one thread owns one
// channel d of one batch row and walks the time axis in order with its N
// states and its row of A in registers (N <= 64): no [S, Di, N] tensor
// exists anywhere, not even in shared memory.  A block is 128 channels of
// one batch row (grid Di/128 x B: 1,024 blocks at a 16 x 1024 prefill of
// Di 8192, on 132 SMs).  Its 128 channels share B_t and C_t, so the block
// stages them for 64 steps at a time in shared memory; dt and x are read
// (8 steps ahead, into registers) and y written coalesced along Di.  The
// time walk has no parallel form here: the parallelism is B x Di.  A
// chunked parallel scan over time and TMA staging are later work
// (PERF.md).
//
// Numerics: the products and the sum of the state update are rounded one
// by one (no contraction to FMA), as the plain version computes them;
// expf is the accurate one (no fast math); y's sum over n is an FMA chain.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // channels of a block: one thread each
constexpr int kTile = 64;      // steps of B_t / C_t staged in shared memory
constexpr int kAhead = 8;      // steps of dt / x loaded ahead into registers

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ x,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout, int S,
                int Di, int N) {
  __shared__ float Bs[kTile * NMAX];
  __shared__ float Cs[kTile * NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < Di;
  const int64_t row0 = (int64_t)b * S;  // row (b, t) of the [B*S, .] views

  float a_row[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool in = live && n < N;
    a_row[n] = in ? A[(int64_t)d * N + n] : 0.f;
    h[n] = (in && h0 != nullptr) ? h0[((int64_t)b * Di + d) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();  // the previous tile's B_t / C_t are consumed
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int tt = i / N, n = i - tt * N;
      const int64_t src = (row0 + t0) * N + i;
      Bs[tt * NMAX + n] = to_f32(Bm[src]);
      Cs[tt * NMAX + n] = to_f32(Cm[src]);
    }
    __syncthreads();
    if (!live) continue;
    for (int s0 = 0; s0 < nt; s0 += kAhead) {
      float dv[kAhead], xv[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool in = s0 + u < nt;
        const int64_t idx = (row0 + t0 + s0 + u) * Di + d;
        dv[u] = in ? dt[idx] : 0.f;
        xv[u] = in ? to_f32(x[idx]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int tt = s0 + u;
        if (tt < nt) {
          const float bx = __fmul_rn(dv[u], xv[u]);
          const float* Bt = Bs + tt * NMAX;
          const float* Ct = Cs + tt * NMAX;
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < NMAX; ++n) {
            if (n < N) {
              const float a = expf(__fmul_rn(dv[u], a_row[n]));
              h[n] = __fadd_rn(__fmul_rn(a, h[n]), __fmul_rn(bx, Bt[n]));
              acc = fmaf(Ct[n], h[n], acc);
            }
          }
          y[(row0 + t0 + tt) * Di + d] = acc;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    if (n < N) hout[((int64_t)b * Di + d) * N + n] = h[n];
}

template <typename T, int NMAX>
cudaError_t launch(const void* dt, const void* Bm, const void* Cm,
                   const void* x, const void* A, const void* h0, void* y,
                   void* h, int Bt, int S, int Di, int N,
                   cudaStream_t stream) {
  dim3 grid((Di + kThreads - 1) / kThreads, Bt);
  ssm_scan_kernel<T, NMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h), S, Di, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* dt, const void* Bm, const void* Cm,
                       const void* x, const void* A, const void* h0, void* y,
                       void* h, int Bt, int S, int Di, int N,
                       cudaStream_t s) {
  if (N <= 8) return launch<T, 8>(dt, Bm, Cm, x, A, h0, y, h, Bt, S, Di, N, s);
  if (N <= 16)
    return launch<T, 16>(dt, Bm, Cm, x, A, h0, y, h, Bt, S, Di, N, s);
  if (N <= 32)
    return launch<T, 32>(dt, Bm, Cm, x, A, h0, y, h, Bt, S, Di, N, s);
  return launch<T, 64>(dt, Bm, Cm, x, A, h0, y, h, Bt, S, Di, N, s);
}

}  // namespace

// dt [Bt,S,Di] f32, B/C [Bt,S,N] and x [Bt,S,Di] of one dtype (f32 or
// bf16), A [Di,N] f32, h0 [Bt,Di,N] f32 or null (zero start); y [Bt,S,Di]
// and h [Bt,Di,N] f32.  All contiguous; 0 < N <= 64, S > 0.
extern "C" int repro_ssm_scan(const void* dt, const void* Bm, const void* Cm,
                              const void* x, const void* A, const void* h0,
                              void* y, void* h, int Bt, int S, int Di, int N,
                              int dtype, void* stream) {
  if (Bt <= 0 || S <= 0 || Di <= 0 || N <= 0 || N > 64 || Bt > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_n<float>(dt, Bm, Cm, x, A, h0, y, h, Bt, S, Di, N, s);
  if (dtype == kBF16)
    return dispatch_n<__nv_bfloat16>(dt, Bm, Cm, x, A, h0, y, h, Bt, S, Di,
                                     N, s);
  return cudaErrorInvalidValue;
}
