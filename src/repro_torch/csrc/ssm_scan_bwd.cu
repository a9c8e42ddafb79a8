// The backward of the Mamba selective scan (#12b) for Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference has no Pallas backward for its
// scan; it takes jax.grad of the jnp chunk body (src/repro/models/ssm.py:94
// mamba, chunk_step at :120, under jax.checkpoint).  The port's training
// forward runs #12 (csrc/ssm_scan.cu, its KEEP variant), so its backward
// is a kernel too.
//
// What it computes (kernels/ref.py ref_ssm_scan_bwd), per batch row b,
// channel d and state n, with a_t = exp(dt_t·A) and the adjoint
// g_t = C_t·dy_t + a_{t+1}·g_{t+1} walked backward in time from dh:
//   dA      = Σ_{b,t} g_t·h_{t-1}·a_t·dt_t
//   ddt_t   = Σ_n g_t·(h_{t-1}·a_t·A + x_t·B_t)
//   dx_t    = dt_t·Σ_n g_t·B_t
//   dB_t[n] = Σ_d g_t·dt_t·x_t,   dC_t[n] = Σ_d dy_t·h_t
//   dh0     = a_0·g_0
// from the forward's inputs and the states it kept at each L-step chunk
// start (hs [Bt, nc, Di, N]).
//
// What bounds it on this card: at jamba-v0.1-52b's train shape ([8,512,
// 8192] x 16) the bytes each input and output must move once (dt, dy and
// ddt f32, x and dx bf16, the kept starts: ~0.56 GB, 0.166 ms at
// 3.35 TB/s), above one recompute of a_t on the special-function units
// (537 M exps, ~0.13 ms).  A first design: this kernel takes two exps an
// element (one walk to find the segment starts, one to rebuild a
// segment), some forty instructions and a dozen shared-memory accesses,
// so it issues well above either.
//
// The design:
//  * One thread a (channel, state): NMAX lanes (8 or 16) of a warp share
//    a channel, 512 threads a block, 512 / NMAX channels of one batch row
//    (grid Di / channels x Bt).  The block walks the chunks last to first.
//  * Per chunk, a walk forward from the kept start stores the state at
//    every 16-step segment start in shared memory (16 segments: L <= 256);
//    then, segment by segment in reverse, the thread rebuilds the
//    segment's 16 states h_{t-1} and gates a_t in registers, with the
//    forward's own arithmetic (a = ex2.approx(dt·A·log2 e), h = fma(a, h,
//    (dt·x)·B)), and walks them backward carrying g in a register.
//  * A segment's dt, x, dy (16 x channels) and B, C (16 x NMAX) come
//    through shared memory; the next segment's are loaded into registers
//    while this one computes.
//  * ddt and dx sum over the channel's lanes: each lane parks its 16
//    steps' terms in shared memory and one thread a (step, channel) sums
//    the lanes in order (16-byte reads); rows leave in coalesced stores.
//    (A reduce-scatter by xor shuffles did the same in registers at
//    nearly twice the kernel's time: its dependent shuffles stalled every
//    warp of the block at once.)  dB and dC sum over channels: each thread
//    parks its terms in shared memory and one thread a (step, state) sums
//    the block's channels in order, into per-block partials [Bt, blocks,
//    S, N]; dA's per-row partials are [Bt, Di, N].  A second launch
//    (ssm_bwd_sum_kernel) sums the partials over blocks and rows in a
//    fixed order.  No atomics: two launches agree bit for bit.
//
// Numerics: f32 throughout.  The rebuilt states are the forward kernel's
// bits (same operations, same kept starts), so ex2.approx's error (2 ulp
// of 2^x) enters the gradients as it entered y.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSeg = 16;      // steps of a segment
constexpr int kMaxSegs = 16;  // segments of a chunk: L <= 256
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NMAX>
struct Smem {
  static constexpr int kCh = kThreads / NMAX;
  float seg[kMaxSegs][kThreads];  // each thread's state at segment starts
  float dt[kSeg][kCh], x[kSeg][kCh], dy[kSeg][kCh];
  float B[kSeg][NMAX], C[kSeg][NMAX];
  float pB[kSeg][kThreads], pC[kSeg][kThreads];  // dB / dC terms
  float ddt[kSeg][kCh], dx[kSeg][kCh];
  // each lane's ddt and Σ g·B terms, rows padded to 16-byte pieces that
  // a quarter warp reads without bank conflicts
  float q1[kSeg][kCh][NMAX + 4], q2[kSeg][kCh][NMAX + 4];
};

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_bwd_kernel(const float* __restrict__ dt, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ x,
                    const float* __restrict__ A,
                    const float* __restrict__ hs,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh, float* __restrict__ ddt,
                    T* __restrict__ dx, float* __restrict__ dA_part,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dh0, int S, int Di, int N, int L) {
  constexpr int kCh = Smem<NMAX>::kCh;
  constexpr int kPer = kSeg * kCh / kThreads;  // dt / x / dy values a thread
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<NMAX>& sm = *reinterpret_cast<Smem<NMAX>*>(smem);

  const int tid = threadIdx.x;
  const int n = tid % NMAX, c = tid / NMAX;
  const int d0 = blockIdx.x * kCh, d = d0 + c, b = blockIdx.y;
  const bool live = d < Di && n < N;
  const int nc = (S + L - 1) / L;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t at = (static_cast<int64_t>(b) * Di + d) * N + n;  // (b,d,n)
  const float Av = live ? A[static_cast<int64_t>(d) * N + n] : 0.f;
  const float a2 = Av * kLog2e;
  float carry = (live && dh != nullptr) ? dh[at] : 0.f;  // a_{t+1}·g_{t+1}
  float dA_acc = 0.f;

  // rows t0 .. t1-1 of a segment into registers (zero past t1 or Di);
  // dy and C only when `full`
  float rdt[kPer], rx[kPer], rdy[kPer], rB = 0.f, rC = 0.f;
  auto fetch = [&](int t0, int t1, bool full) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads, r = e / kCh, cc = e % kCh;
      const bool in = t0 + r < t1 && d0 + cc < Di;
      const int64_t i = (row0 + t0 + r) * Di + d0 + cc;
      rdt[k] = in ? dt[i] : 0.f;
      rx[k] = in ? to_f32(x[i]) : 0.f;
      rdy[k] = (in && full) ? dy[i] : 0.f;
    }
    if (tid < kSeg * NMAX) {
      const int r = tid / NMAX, nn = tid % NMAX;
      const bool in = t0 + r < t1 && nn < N;
      const int64_t i = (row0 + t0 + r) * N + nn;
      rB = in ? to_f32(Bm[i]) : 0.f;
      rC = (in && full) ? to_f32(Cm[i]) : 0.f;
    }
  };
  auto commit = [&]() {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      (&sm.dt[0][0])[e] = rdt[k];
      (&sm.x[0][0])[e] = rx[k];
      (&sm.dy[0][0])[e] = rdy[k];
    }
    if (tid < kSeg * NMAX) {
      (&sm.B[0][0])[tid] = rB;
      (&sm.C[0][0])[tid] = rC;
    }
  };

  for (int k = nc - 1; k >= 0; --k) {
    const int c0 = k * L, c1 = min(c0 + L, S);
    const int nseg = (c1 - c0 + kSeg - 1) / kSeg;
    float h = live ? hs[((static_cast<int64_t>(b) * nc + k) * Di + d) * N + n]
                   : 0.f;
    // the walk forward: the state at each segment start
    fetch(c0, min(c0 + kSeg, c1), false);
    for (int j = 0; j < nseg; ++j) {
      __syncthreads();  // every thread is done with the staged tiles
      commit();
      __syncthreads();
      sm.seg[j][tid] = h;
      if (j + 1 == nseg) break;
      const int tn = c0 + (j + 1) * kSeg;
      fetch(tn, min(tn + kSeg, c1), false);
#pragma unroll
      for (int s = 0; s < kSeg; ++s) {
        const float dtv = sm.dt[s][c];
        const float a = ex2(dtv * a2);
        h = fmaf(a, h, (dtv * sm.x[s][c]) * sm.B[s][n]);
      }
    }

    // the segments in reverse: rebuild, then walk back
    fetch(c0 + (nseg - 1) * kSeg, c1, true);
    for (int j = nseg - 1; j >= 0; --j) {
      const int t0 = c0 + j * kSeg;
      __syncthreads();  // the last segment's tiles and partials are read
      commit();
      __syncthreads();
      if (j > 0) fetch(t0 - kSeg, t0, true);
      float hp[kSeg], av[kSeg];  // h_{t-1} and a_t of the segment's steps
      float hh = sm.seg[j][tid];
#pragma unroll
      for (int s = 0; s < kSeg; ++s) {
        const float dtv = sm.dt[s][c];
        hp[s] = hh;
        av[s] = ex2(dtv * a2);
        hh = fmaf(av[s], hh, (dtv * sm.x[s][c]) * sm.B[s][n]);
      }
#pragma unroll
      for (int s = kSeg - 1; s >= 0; --s) {
        const float dtv = sm.dt[s][c], xv = sm.x[s][c], dyv = sm.dy[s][c];
        const float bv = sm.B[s][n], cv = sm.C[s][n];
        const float ht = s + 1 < kSeg ? hp[s + 1] : hh;  // h_t
        const float g = fmaf(cv, dyv, carry);
        const float ah = av[s] * hp[s];
        dA_acc = fmaf(g * ah, dtv, dA_acc);
        sm.q1[s][c][n] = g * fmaf(ah, Av, xv * bv);
        sm.q2[s][c][n] = g * bv;
        sm.pB[s][tid] = g * (dtv * xv);
        sm.pC[s][tid] = dyv * ht;
        carry = av[s] * g;
      }
      __syncthreads();
      // dB / dC partials: one thread a (which, step, state) sums the
      // block's channels in order
      for (int e = tid; e < 2 * kSeg * NMAX; e += kThreads) {
        const int which = e / (kSeg * NMAX), s = (e / NMAX) % kSeg;
        const int nn = e % NMAX, t = t0 + s;
        const float* src = which ? &sm.pC[s][nn] : &sm.pB[s][nn];
        float acc = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < kCh; ++cc) acc += src[cc * NMAX];
        if (t < c1 && nn < N) {
          float* dst = which ? dC_part : dB_part;
          dst[((static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * S + t) *
                  N + nn] = acc;
        }
      }
      // ddt and dx: one thread a (which, step, channel) sums the
      // channel's lanes in order
      for (int e = tid; e < 2 * kSeg * kCh; e += kThreads) {
        const int which = e / (kSeg * kCh), s = (e / kCh) % kSeg;
        const int cc = e % kCh;
        const float4* q4 = reinterpret_cast<const float4*>(
            which ? &sm.q2[s][cc][0] : &sm.q1[s][cc][0]);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NMAX / 4; ++k) {
          const float4 v = q4[k];
          acc += v.x + v.y + v.z + v.w;
        }
        if (which)
          sm.dx[s][cc] = sm.dt[s][cc] * acc;
        else
          sm.ddt[s][cc] = acc;
      }
      __syncthreads();
      for (int e = tid; e < kSeg * kCh; e += kThreads) {
        const int s = e / kCh, cc = e % kCh, t = t0 + s;
        if (t < c1 && d0 + cc < Di) {
          const int64_t i = (row0 + t) * Di + d0 + cc;
          ddt[i] = sm.ddt[s][cc];
          dx[i] = from_f32<T>(sm.dx[s][cc]);
        }
      }
    }
  }
  if (live) {
    dA_part[at] = dA_acc;
    if (dh0 != nullptr) dh0[at] = carry;
  }
}

// out[p, m] = Σ_k in[p, k, m], k in order: the blocks' dB / dC partials
// over blocks, dA's over batch rows.
struct SumJob {
  const float* in;
  void* out;
  int P, K;
  int64_t M;
  int bf16;  // out is bf16 (else f32)
};

__global__ void __launch_bounds__(256)
ssm_bwd_sum_kernel(SumJob j0, SumJob j1, SumJob j2) {
  const SumJob j = blockIdx.z == 0 ? j0 : (blockIdx.z == 1 ? j1 : j2);
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int p = blockIdx.y;
  if (p >= j.P || m >= j.M) return;
  const float* src = j.in + static_cast<int64_t>(p) * j.K * j.M + m;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < j.K; ++k) s += src[k * j.M];
  const int64_t o = static_cast<int64_t>(p) * j.M + m;
  if (j.bf16)
    static_cast<__nv_bfloat16*>(j.out)[o] = __float2bfloat16(s);
  else
    static_cast<float*>(j.out)[o] = s;
}

template <typename T, int NMAX>
cudaError_t launch(const void* dt, const void* Bm, const void* Cm,
                   const void* x, const void* A, const void* hs,
                   const void* dy, const void* dh, void* ddt, void* dx,
                   void* dB, void* dC, void* dA, void* dh0, float* work,
                   int Bt, int S, int Di, int N, int L, int out_bf16,
                   cudaStream_t stream) {
  constexpr int kCh = Smem<NMAX>::kCh;
  const auto kern = ssm_scan_bwd_kernel<T, NMAX>;
  const int smem = static_cast<int>(sizeof(Smem<NMAX>));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (Di + kCh - 1) / kCh;
  const int64_t part = static_cast<int64_t>(Bt) * blocks * S * N;
  float* dB_part = work;
  float* dC_part = work + part;
  float* dA_part = work + 2 * part;
  kern<<<dim3(blocks, Bt), kThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const float*>(hs),
      static_cast<const float*>(dy), static_cast<const float*>(dh),
      static_cast<float*>(ddt), static_cast<T*>(dx), dA_part, dB_part,
      dC_part, static_cast<float*>(dh0), S, Di, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t SN = static_cast<int64_t>(S) * N;
  const int64_t DN = static_cast<int64_t>(Di) * N;
  const SumJob jB{dB_part, dB, Bt, blocks, SN, out_bf16};
  const SumJob jC{dC_part, dC, Bt, blocks, SN, out_bf16};
  const SumJob jA{dA_part, dA, 1, Bt, DN, 0};
  const int64_t widest = std::max(SN, DN);
  ssm_bwd_sum_kernel<<<dim3(static_cast<unsigned>((widest + 255) / 256), Bt,
                            3),
                       256, 0, stream>>>(jB, jC, jA);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* dt, const void* Bm, const void* Cm,
                       const void* x, const void* A, const void* hs,
                       const void* dy, const void* dh, void* ddt, void* dx,
                       void* dB, void* dC, void* dA, void* dh0, float* work,
                       int Bt, int S, int Di, int N, int L, int out_bf16,
                       cudaStream_t s) {
  if (N <= 8)
    return launch<T, 8>(dt, Bm, Cm, x, A, hs, dy, dh, ddt, dx, dB, dC, dA,
                        dh0, work, Bt, S, Di, N, L, out_bf16, s);
  return launch<T, 16>(dt, Bm, Cm, x, A, hs, dy, dh, ddt, dx, dB, dC, dA,
                       dh0, work, Bt, S, Di, N, L, out_bf16, s);
}

}  // namespace

// dt [Bt,S,Di] f32; B/C [Bt,S,N] and x [Bt,S,Di] of one dtype (f32 or
// bf16); A [Di,N] f32; hs [Bt,ceil(S/L),Di,N] f32 (the forward's kept
// chunk starts); dy [Bt,S,Di] f32; dh [Bt,Di,N] f32 or null (zero).
// Writes ddt [Bt,S,Di] f32, dx [Bt,S,Di] and dB/dC [Bt,S,N] in x's dtype,
// dA [Di,N] f32 and, unless null, dh0 [Bt,Di,N] f32.  work: f32 scratch
// of 2·Bt·blocks·S·N + Bt·Di·N values, blocks = ceil(Di / (512 / NMAX)),
// NMAX = 8 for N <= 8, else 16.  All contiguous; 0 < N <= 16,
// 0 < L <= 256.
extern "C" int repro_ssm_scan_bwd(const void* dt, const void* Bm,
                                  const void* Cm, const void* x,
                                  const void* A, const void* hs,
                                  const void* dy, const void* dh, void* ddt,
                                  void* dx, void* dB, void* dC, void* dA,
                                  void* dh0, void* work, int Bt, int S,
                                  int Di, int N, int L, int dtype,
                                  void* stream) {
  if (Bt <= 0 || Bt > 65535 || S <= 0 || Di <= 0 || N <= 0 || N > 16 ||
      L <= 0 || L > kSeg * kMaxSegs)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == kF32)
    return dispatch_n<float>(dt, Bm, Cm, x, A, hs, dy, dh, ddt, dx, dB, dC,
                             dA, dh0, w, Bt, S, Di, N, L, 0, s);
  if (dtype == kBF16)
    return dispatch_n<__nv_bfloat16>(dt, Bm, Cm, x, A, hs, dy, dh, ddt, dx,
                                     dB, dC, dA, dh0, w, Bt, S, Di, N, L, 1,
                                     s);
  return cudaErrorInvalidValue;
}
