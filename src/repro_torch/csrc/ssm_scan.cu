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
// What bounds it on this card: each (b, t, d, n) costs one exp, which the
// special-function units (SFU) compute at 16 a clock an SM: at
// jamba-v0.1-52b's [4,1024,8192] x 16 that is 0.13 ms at 1.98 GHz, above
// the 0.10 ms the 336 MB of dt, x and y take at 3.35 TB/s.  Besides the
// exp an element costs a multiply for its argument, one for b, the FMA of
// the update and the FMA of y, so issuing ~6 instructions an element (one
// warp instruction a clock a scheduler) comes close behind.  In trials
// on an H100 (copies of this kernel, not kept in the repository) the SFU
// was not the limit yet: the kernel ran as fast with the exp replaced by
// an FMA and slower with half the warps an SM, so the latency of each
// step's chain weighs in.
//
// What the design does about it:
//  * A channel's N states are split over kLanes = NMAX / 8 lanes of one
//    warp, 8 states a lane in registers with their row of A (2 lanes at
//    N 16: 2x the threads of one lane a channel).  A lane walks the time
//    axis in order: each state's recurrence stays sequential in time, and
//    a step whose dt is 0 (a pad step, or a step past S) leaves h exactly
//    as it is (a = 2^0 = 1, b = 0), whatever S.
//  * An exp is one multiply and one MUFU ex2: log2(e) is folded into A
//    once a thread (a2 = A·log2 e), so a = ex2.approx(dt·a2).  The state
//    update is one FMA, h = fma(a, h, (dt·x)·B_t[n]), and y's share of a
//    lane an FMA chain over its states.  The lanes' shares of kLanes
//    consecutive steps are reduce-scattered by xor shuffles (halving:
//    lane g ends with step g's sum, in one fixed tree, and stores it), so
//    no atomics and two launches agree bit for bit.
//  * A step's operands (dt, x, B_t, C_t) are loaded from shared memory
//    while the step before computes, and a tile's 32 steps are unrolled.
//  * A block is 64 channels of one batch row (64 · kLanes threads; grid
//    Di/64 x B).  Tiles of kSteps = 32 steps x 64 channels of dt and x
//    come through shared memory by 16-byte cp.async, double-buffered, the
//    next tile in flight while the block computes this one; the 32 rows
//    of B_t and C_t the block's channels share are loaded into registers
//    one tile ahead and stored as f32 (zero past N), so a lane reads its
//    states' B and C with 16-byte loads; y goes out through a
//    double-buffered shared tile in 16-byte stores.  One __syncthreads a
//    tile.  Rows past S are zero-filled: identity steps, not written.
//
// The TPU kernel walked (b, Di-block, chunk) with the chunk axis
// sequential, built the [L, dblk, N] gates in VMEM and ran a log-depth
// associative scan over them; here no [S, Di, N] tensor exists, not even
// in shared memory, and the parallelism is B x Di x N / 8.
//
// Numerics: against the plain version (exp, products and sums each
// rounded), ex2.approx is within 2 ulp of 2^x, the state update is
// contracted to one FMA and y is summed in another order: the kernel
// stays within the reference's 5e-5 (tests/test_torch_jamba.py rehearses
// this arithmetic on the CPU).  ex2.approx.ftz flushes results below
// 2^-126 to zero; such an a multiplies h by less than 1e-38.

#include "common.cuh"

namespace {

constexpr int kStates = 8;     // states of a lane
constexpr int kChannels = 64;  // channels of a block
constexpr int kSteps = 32;     // steps of a staged tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 copies nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

// A lane's kStates floats of a B or C row, in 16-byte loads.
__device__ __forceinline__ void load_row(float (&v)[kStates],
                                         const float* src) {
#pragma unroll
  for (int i = 0; i < kStates; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + i);
    v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
  }
}

// Shared memory of a block, two buffers of each tile.
template <typename T, int NMAX>
struct Tiles {
  float dt[2][kSteps][kChannels];
  T x[2][kSteps][kChannels];
  float B[2][kSteps][NMAX];
  float C[2][kSteps][NMAX];
  float y[2][kSteps][kChannels];
};

// NMAX / 8 lanes a channel, 64 of them a block: 128 registers a thread at
// 512 threads an SM.  KEEP (the training forward) also writes the state
// entering each L-step chunk to hs [Bt, nc, Di, N] (chunk 0's is h0, or
// zero): the starts #12b (csrc/ssm_scan_bwd.cu) rebuilds the states from.
// Without it the code is the serving path's as it was.
template <typename T, int NMAX, bool KEEP>
__global__ void __launch_bounds__(kChannels * NMAX / kStates,
                                  8 * kStates / NMAX)
ssm_scan_kernel(const float* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ x,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout,
                float* __restrict__ hs, int S, int Di, int N, int L) {
  constexpr int kLanes = NMAX / kStates;         // lanes sharing a channel
  constexpr int kThreads = kChannels * kLanes;
  constexpr int kBC = kSteps * NMAX / kThreads;  // B (and C) values a thread
  constexpr int kDtPieces = kChannels / 4;       // 16-byte pieces of a dt row
  constexpr int kXV = 16 / sizeof(T);            // x values of a piece
  constexpr int kXPieces = kChannels / kXV;
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles<T, NMAX>& sm = *reinterpret_cast<Tiles<T, NMAX>*>(smem);

  const int tid = threadIdx.x;
  const int g = tid % kLanes;  // the lane's share of the channel's states
  const int c = tid / kLanes;  // the channel in the block
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool live = d < Di;
  const int b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(b) * S;  // row (b, 0)

  float a2[kStates], h[kStates];
#pragma unroll
  for (int p = 0; p < kStates; ++p) {
    const int n = g * kStates + p;
    const bool in = live && n < N;
    a2[p] = in ? A[static_cast<int64_t>(d) * N + n] * kLog2e : 0.f;
    h[p] = (in && h0 != nullptr)
               ? h0[(static_cast<int64_t>(b) * Di + d) * N + n] : 0.f;
  }

  // dt and x of tile `tile` into buffer `buf`, 16 bytes a copy; pieces
  // past S or Di are zero-filled (Di is a multiple of both piece widths)
  auto stage = [&](int tile, int buf) {
    const int t0 = tile * kSteps;
    for (int i = tid; i < kSteps * kDtPieces; i += kThreads) {
      const int r = i / kDtPieces, cc = (i % kDtPieces) * 4;
      const bool in = t0 + r < S && d0 + cc < Di;
      cp_async16(&sm.dt[buf][r][cc],
                 in ? dt + (row0 + t0 + r) * Di + d0 + cc : dt, in);
    }
    for (int i = tid; i < kSteps * kXPieces; i += kThreads) {
      const int r = i / kXPieces, cc = (i % kXPieces) * kXV;
      const bool in = t0 + r < S && d0 + cc < Di;
      cp_async16(&sm.x[buf][r][cc],
                 in ? x + (row0 + t0 + r) * Di + d0 + cc : x, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // B_t and C_t of tile `tile`: element e of the [kSteps][NMAX] tile is
  // thread tid's k-th, e = tid + k * kThreads (zero past S or N)
  float bn[kBC], cn[kBC];
  auto load_bc = [&](int tile) {
    const int t0 = tile * kSteps;
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int e = tid + k * kThreads, r = e / NMAX, n = e % NMAX;
      const bool in = t0 + r < S && n < N;
      const int64_t src = (row0 + t0 + r) * N + n;
      bn[k] = in ? to_f32(Bm[src]) : 0.f;
      cn[k] = in ? to_f32(Cm[src]) : 0.f;
    }
  };
  auto store_bc = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      (&sm.B[buf][0][0])[tid + k * kThreads] = bn[k];
      (&sm.C[buf][0][0])[tid + k * kThreads] = cn[k];
    }
  };
  // y of tile `tile` from buffer `buf`, 16 bytes a store
  auto flush = [&](int tile, int buf) {
    const int t0 = tile * kSteps;
    for (int i = tid; i < kSteps * kDtPieces; i += kThreads) {
      const int r = i / kDtPieces, cc = (i % kDtPieces) * 4;
      if (t0 + r < S && d0 + cc < Di)
        *reinterpret_cast<float4*>(y + (row0 + t0 + r) * Di + d0 + cc) =
            *reinterpret_cast<const float4*>(&sm.y[buf][r][cc]);
    }
  };

  // the next chunk start to keep, and its chunk (KEEP only)
  int keep_at = 0, kept = 0;
  const int nc = KEEP ? (S + L - 1) / L : 0;

  const int ntiles = (S + kSteps - 1) / kSteps;
  stage(0, 0);
  load_bc(0);
  store_bc(0);
  for (int i = 0; i < ntiles; ++i) {
    const int cur = i & 1, nxt = cur ^ 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile i is in; every thread is past tile i - 1, so buffer nxt (its
    // dt, x, B, C, and y, which the flush below reads) is free
    __syncthreads();
    if (i + 1 < ntiles) {
      stage(i + 1, nxt);
      load_bc(i + 1);
    }
    if (i > 0) flush(i - 1, nxt);
    // the next step's operands load while this step computes
    float dn = sm.dt[cur][0][c], xn = to_f32(sm.x[cur][0][c]);
    float bv1[kStates], cv1[kStates];
    load_row(bv1, &sm.B[cur][0][g * kStates]);
    load_row(cv1, &sm.C[cur][0][g * kStates]);
#pragma unroll
    for (int r = 0; r < kSteps; r += kLanes) {
      float part[kLanes];  // this lane's share of y at steps r .. r+kLanes-1
#pragma unroll
      for (int s = 0; s < kLanes; ++s) {
        if constexpr (KEEP) {
          if (i * kSteps + r + s == keep_at && keep_at < S) {
            const int64_t at = ((static_cast<int64_t>(b) * nc + kept) * Di
                                 + d) * N;
#pragma unroll
            for (int p = 0; p < kStates; ++p) {
              const int n = g * kStates + p;
              if (live && n < N) hs[at + n] = h[p];
            }
            ++kept;
            keep_at += L;
          }
        }
        const float dtv = dn, bx = dtv * xn;
        float bv[kStates], cv[kStates];
#pragma unroll
        for (int p = 0; p < kStates; ++p) bv[p] = bv1[p], cv[p] = cv1[p];
        const int rn = min(r + s + 1, kSteps - 1);
        dn = sm.dt[cur][rn][c];
        xn = to_f32(sm.x[cur][rn][c]);
        load_row(bv1, &sm.B[cur][rn][g * kStates]);
        load_row(cv1, &sm.C[cur][rn][g * kStates]);
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < kStates; ++p) {
          const float a = ex2(dtv * a2[p]);
          h[p] = fmaf(a, h[p], bx * bv[p]);
          acc = fmaf(cv[p], h[p], acc);
        }
        part[s] = acc;
      }
      // reduce-scatter: at mask m a lane keeps the half of its 2m steps
      // that bit m of g picks and adds its partner's share of them
#pragma unroll
      for (int m = kLanes / 2; m >= 1; m /= 2) {
        const bool up = g & m;
#pragma unroll
        for (int j = 0; j < m; ++j) {
          const float keep = up ? part[j + m] : part[j];
          const float send = up ? part[j] : part[j + m];
          part[j] = keep + __shfl_xor_sync(~0u, send, m);
        }
      }
      sm.y[cur][r + g][c] = part[0];
    }
    if (i + 1 < ntiles) store_bc(nxt);
  }
  __syncthreads();
  flush(ntiles - 1, (ntiles - 1) & 1);
#pragma unroll
  for (int p = 0; p < kStates; ++p) {
    const int n = g * kStates + p;
    if (live && n < N)
      hout[(static_cast<int64_t>(b) * Di + d) * N + n] = h[p];
  }
}

template <typename T, int NMAX, bool KEEP>
cudaError_t launch(const void* dt, const void* Bm, const void* Cm,
                   const void* x, const void* A, const void* h0, void* y,
                   void* h, void* hs, int Bt, int S, int Di, int N, int L,
                   cudaStream_t stream) {
  const auto kern = ssm_scan_kernel<T, NMAX, KEEP>;
  const int smem = static_cast<int>(sizeof(Tiles<T, NMAX>));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Di + kChannels - 1) / kChannels, Bt);
  kern<<<grid, kChannels * NMAX / kStates, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h),
      static_cast<float*>(hs), S, Di, N, L);
  return cudaGetLastError();
}

template <typename T, bool KEEP>
cudaError_t dispatch_n(const void* dt, const void* Bm, const void* Cm,
                       const void* x, const void* A, const void* h0, void* y,
                       void* h, void* hs, int Bt, int S, int Di, int N, int L,
                       cudaStream_t s) {
  if (N <= 8)
    return launch<T, 8, KEEP>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N,
                              L, s);
  if (N <= 16)
    return launch<T, 16, KEEP>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N,
                               L, s);
  if (N <= 32)
    return launch<T, 32, KEEP>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N,
                               L, s);
  return launch<T, 64, KEEP>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N, L,
                             s);
}

template <typename T>
cudaError_t dispatch_keep(const void* dt, const void* Bm, const void* Cm,
                          const void* x, const void* A, const void* h0,
                          void* y, void* h, void* hs, int Bt, int S, int Di,
                          int N, int L, cudaStream_t s) {
  if (hs == nullptr)
    return dispatch_n<T, false>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N,
                                L, s);
  return dispatch_n<T, true>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N, L,
                             s);
}

}  // namespace

// dt [Bt,S,Di] f32, B/C [Bt,S,N] and x [Bt,S,Di] of one dtype (f32 or
// bf16), A [Di,N] f32, h0 [Bt,Di,N] f32 or null (zero start); y [Bt,S,Di]
// and h [Bt,Di,N] f32; hs [Bt,ceil(S/L),Di,N] f32, or null (serving: no
// chunk starts kept, L unread).  All contiguous; 0 < N <= 64, S > 0; Di a
// multiple of 8 and dt, x, y 16-byte aligned (their rows are read and
// written in 16-byte pieces).
extern "C" int repro_ssm_scan(const void* dt, const void* Bm, const void* Cm,
                              const void* x, const void* A, const void* h0,
                              void* y, void* h, void* hs, int Bt, int S,
                              int Di, int N, int L, int dtype, void* stream) {
  if (Bt <= 0 || S <= 0 || Di <= 0 || Di % 8 || N <= 0 || N > 64 ||
      Bt > 65535 || (hs != nullptr && L <= 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_keep<float>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt, S, Di, N,
                                L, s);
  if (dtype == kBF16)
    return dispatch_keep<__nv_bfloat16>(dt, Bm, Cm, x, A, h0, y, h, hs, Bt,
                                        S, Di, N, L, s);
  return cudaErrorInvalidValue;
}
