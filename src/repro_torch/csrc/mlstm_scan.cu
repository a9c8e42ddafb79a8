// Chunkwise-parallel mLSTM scan for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/mlstm_scan.py:21 _mlstm_kernel (reached
// through mlstm_scan:70, pallas_call at :81), the chunk math of
// models/ssm.py::_mlstm_chunk.
//
// What it computes, per (batch, head), chunk by chunk from the carry
// (C [dh,dh], n [dh], m): g = cumsum(f_log), a = i - g,
// M_t = max(m, max_{s<=t} a_s); causal scores q_t·k_s weighted by
// e^{a_s - M_t}; y_t = (Σ_s w·(q_t·k_s) v_s + e^{m - M_t} q_t·Cᵀ) /
// max(|Σ_s w·(q_t·k_s) + e^{m - M_t} q_t·n|, 1); then
// C' = Σ_s e^{a_s - M_L} v_s k_sᵀ + e^{m - M_L} C, n' likewise,
// m' = g_L + M_L.  The carry starts at zero (C = 0, n = 0, m = -inf) or at
// a given state, and the final (C, n, m) is written out (the model's
// prefill keeps it as the decode state).
//
// What bounds it on this card: per (b, h) the function does O(S·L·dh +
// S·dh²) operations on O(S·dh) bytes; at xlstm-125m's widths (dh 384,
// chunk 256) that is ~100 f32 operations per byte, above the f32 SIMT
// balance (67 TFLOP/s over 3.35 TB/s = 20), so operations bound it.
//
// What the design does about it, and what it does not do yet: the TPU
// grid walked (b, h, chunk) in order with C in VMEM.  Here C per (b, h)
// is dh² f32 (590 KB at dh 384) and one [L,L] score block 262 KB, both
// beyond a block's 227 KB, so one block owns (b, h, a 64-row tile of C's
// v axis) and walks the chunks in order.  Its rows of C are exclusive to
// it, so the output buffer itself holds the carry between chunks (read
// and rewritten once per chunk, from L2).  Scores are built in 64 x 64
// tiles over 32-wide pieces of dh staged in shared memory, 4 x 4 outputs
// a thread, in f32 on the CUDA cores.  Each block recomputes the score
// tiles and the denominator (and keeps its own copy of n) for its v tile:
// dh / 64 = 6 times the score work at dh 384, the price of needing no
// exchange between blocks.  Tensor cores, TMA/cp.async staging and
// sharing the scores across v tiles are later work (PERF.md).
//
// Numerics follow the TPU kernel in f32: exp(-inf - M) = 0 on the first
// chunk (no (-inf) - (-inf) arises: M is finite), pad steps at i = -1e30
// weigh e^{-1e30} = 0, and expf is the accurate one (no fast math).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 64;         // rows of a query, key or C tile
constexpr int kDK = 32;        // width of one staged piece of the dh axis
constexpr int kP = kDK + 1;    // padded row of a staged piece
constexpr int kPP = kT + 1;    // padded row of the score tile

// acc[i][j] += Σ_d A[ty + 16i][d] · B[tx + 16j][d] over d < depth, for the
// first a_rows rows of A and b_rows rows of B (row strides lda, ldb), in
// 32-wide pieces staged in As / Bs.  Rows past a_rows / b_rows add 0.
__device__ __forceinline__ void gemm_nt(float (&acc)[4][4], const float* A,
                                        int lda, int a_rows, const float* B,
                                        int ldb, int b_rows, int depth,
                                        float* As, float* Bs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int d0 = 0; d0 < depth; d0 += kDK) {
    __syncthreads();  // the previous piece (or caller's use) is consumed
    for (int idx = tid; idx < kT * kDK; idx += kThreads) {
      const int r = idx / kDK, d = idx - r * kDK;
      const bool in = d0 + d < depth;
      As[r * kP + d] = (r < a_rows && in) ? A[(int64_t)r * lda + d0 + d] : 0.f;
      Bs[r * kP + d] = (r < b_rows && in) ? B[(int64_t)r * ldb + d0 + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kDK; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * kP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * kP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fl, const float* __restrict__ n0,
                  const float* __restrict__ m0, float* __restrict__ y,
                  float* __restrict__ C, float* __restrict__ n_out,
                  float* __restrict__ m_out, int H, int S, int dh, int L) {
  extern __shared__ float smem[];
  float* As = smem;              // [kT][kP] staged rows of q
  float* Bs = As + kT * kP;      // [kT][kP] staged rows of k or of C
  float* Ps = Bs + kT * kP;      // [kT][kPP] weighted scores; wc·v rows
  float* Vs = Ps + kT * kPP;     // [kT][kT] v tile; k tile (carry update)
  float* ns = Vs + kT * kT;      // [dh] this block's copy of n
  float* gs = ns + dh;           // [L] g = cumsum(f_log) of the chunk
  float* as = gs + L;            // [L] a = i - g, then wc = e^{a - M_L}
  float* Ms = as + L;            // [L] row stabilizers M
  float* dens = Ms + L;          // [kT] max(|den|, 1) of a query tile
  float* mprev = dens + kT;      // [1] the carry's m

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int v0 = blockIdx.x * kT;
  const int vrows = min(kT, dh - v0);
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * S * dh;
  const float* kb = k + bh * S * dh;
  const float* vb = v + bh * S * dh;
  const float* ib = ig + bh * S;
  const float* fb = fl + bh * S;
  float* yb = y + bh * S * dh;
  float* Cb = C + bh * dh * dh + (int64_t)v0 * dh;  // this block's C rows
  const bool has_init = n0 != nullptr;

  for (int i = tid; i < dh; i += kThreads)
    ns[i] = has_init ? n0[bh * dh + i] : 0.f;
  if (tid == 0) mprev[0] = has_init ? m0[bh] : -INFINITY;

  for (int c0 = 0; c0 < S; c0 += L) {
    // chunk statistics: gates staged by all threads, then one thread runs
    // the cumulative sum and max in order
    __syncthreads();
    for (int t = tid; t < L; t += kThreads) {
      gs[t] = fb[c0 + t];
      as[t] = ib[c0 + t];
    }
    __syncthreads();
    if (tid == 0) {
      float g = 0.f, cm = -INFINITY;
      const float mp = mprev[0];
      for (int t = 0; t < L; ++t) {
        g += gs[t];
        const float a = as[t] - g;
        cm = fmaxf(cm, a);
        gs[t] = g;
        as[t] = a;
        Ms[t] = fmaxf(cm, mp);
      }
    }
    __syncthreads();
    const float m_prev = mprev[0];
    const bool carry = has_init || c0 > 0;  // else C and n are zero

    for (int t0 = 0; t0 < L; t0 += kT) {
      const int tq = min(kT, L - t0);
      const float* qt = qb + (int64_t)(c0 + t0) * dh;
      float acc[4][4] = {};
      float dsum = 0.f;  // thread tid < kT: row tid's sum of weighted scores
      for (int s0 = 0; s0 <= t0; s0 += kT) {  // key tiles up to the diagonal
        const int tk = min(kT, L - s0);
        float sc[4][4] = {};
        gemm_nt(sc, qt, dh, tq, kb + (int64_t)(c0 + s0) * dh, dh, tk, dh, As,
                Bs);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ty + 16 * i, c = tx + 16 * j;
            const int t = t0 + r, s = s0 + c;
            float p = 0.f;
            if (r < tq && c < tk && s <= t) p = sc[i][j] * expf(as[s] - Ms[t]);
            Ps[r * kPP + c] = p;
          }
        for (int idx = tid; idx < kT * kT; idx += kThreads) {
          const int r = idx / kT, c = idx - r * kT;
          Vs[idx] = (r < tk && c < vrows)
                        ? vb[(int64_t)(c0 + s0 + r) * dh + v0 + c]
                        : 0.f;
        }
        __syncthreads();
        if (tid < kT) {
          float s = 0.f;
          for (int c = 0; c < kT; ++c) s += Ps[tid * kPP + c];
          dsum += s;
        }
#pragma unroll 8
        for (int s = 0; s < kT; ++s) {
          float p[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPP + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = Vs[s * kT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
        }
        __syncthreads();
      }

      float qn = 0.f;  // thread tid < tq: q_row · n
      if (carry) {
        float qc[4][4] = {};
        gemm_nt(qc, qt, dh, tq, Cb, dh, vrows, dh, As, Bs);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          const float inter = r < tq ? expf(m_prev - Ms[t0 + r]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += inter * qc[i][j];
        }
        if (tid < tq) {
          const float* qr = qt + (int64_t)tid * dh;
          for (int d = 0; d < dh; ++d) qn = fmaf(qr[d], ns[d], qn);
        }
      }
      if (tid < kT) {
        float d = dsum;
        if (carry && tid < tq) d += expf(m_prev - Ms[t0 + tid]) * qn;
        dens[tid] = fmaxf(fabsf(d), 1.f);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          if (r < tq && c < vrows)
            yb[(int64_t)(c0 + t0 + r) * dh + v0 + c] = acc[i][j] / dens[r];
        }
      __syncthreads();
    }

    // carry update: C rows [v0, v0 + vrows) and this block's n
    const float M_L = Ms[L - 1], g_L = gs[L - 1];
    const float decay = carry ? expf(m_prev - M_L) : 0.f;
    for (int t = tid; t < L; t += kThreads) as[t] = expf(as[t] - M_L);
    for (int k0 = 0; k0 < dh; k0 += kT) {
      const int kc = min(kT, dh - k0);
      float cacc[4][4] = {};
      float nacc = 0.f;  // thread tid < kc: Σ_s wc_s k_s[k0 + tid]
      for (int s0 = 0; s0 < L; s0 += kT) {
        const int tk = min(kT, L - s0);
        __syncthreads();  // wc written; the previous tiles are consumed
        for (int idx = tid; idx < kT * kT; idx += kThreads) {
          const int r = idx / kT, c = idx - r * kT;
          const int64_t row = (int64_t)(c0 + s0 + r) * dh;
          Ps[r * kPP + c] =
              (r < tk && c < vrows) ? as[s0 + r] * vb[row + v0 + c] : 0.f;
          Vs[idx] = (r < tk && c < kc) ? kb[row + k0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int s = 0; s < kT; ++s) {
          float w[4], kk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = Ps[s * kPP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) kk[j] = Vs[s * kT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cacc[i][j] = fmaf(w[i], kk[j], cacc[i][j]);
        }
        if (tid < kc)
          for (int s = 0; s < tk; ++s) nacc = fmaf(as[s0 + s], Vs[s * kT + tid], nacc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          if (r < vrows && c < kc) {
            float* cp = Cb + (int64_t)r * dh + k0 + c;
            *cp = carry ? decay * *cp + cacc[i][j] : cacc[i][j];
          }
        }
      if (tid < kc) ns[k0 + tid] = carry ? decay * ns[k0 + tid] + nacc : nacc;
    }
    __syncthreads();
    if (tid == 0) mprev[0] = g_L + M_L;
  }

  __syncthreads();
  if (blockIdx.x == 0) {  // n and m are the same in every v tile's block
    for (int i = tid; i < dh; i += kThreads) n_out[bh * dh + i] = ns[i];
    if (tid == 0) m_out[bh] = mprev[0];
  }
}

}  // namespace

// q/k/v/y [B,H,S,dh] f32 (k pre-scaled by dh^-0.5); ig/fl [B,H,S] f32
// (f_log already log-sigmoid); S % L == 0.  C [B,H,dh,dh], n [B,H,dh],
// m [B,H] receive the final carry.  With n0/m0 non-null the carry starts
// from (C, n0, m0), C holding the initial state on entry; with n0 = m0 =
// null it starts at zero and C's contents are ignored.  All contiguous.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* ig, const void* fl,
                                const void* n0, const void* m0, void* y,
                                void* C, void* n, void* m, int B, int H,
                                int S, int dh, int L, void* stream) {
  if ((n0 == nullptr) != (m0 == nullptr) || L <= 0 || S % L != 0)
    return cudaErrorInvalidValue;
  const int smem =
      (2 * kT * kP + kT * kPP + kT * kT + dh + 3 * L + kT + 1) *
      (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dh + kT - 1) / kT, H, B);
  mlstm_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fl), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<float*>(y),
      static_cast<float*>(C), static_cast<float*>(n), static_cast<float*>(m),
      H, S, dh, L);
  return cudaGetLastError();
}
