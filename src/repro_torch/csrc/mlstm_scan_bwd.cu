// The chunkwise mLSTM scan's backward for Hopper, sm_90a: five kernels,
// the products in f32 on the CUDA cores.
//
// Replaces no TPU kernel.  The reference has no Pallas backward for its
// mLSTM kernel (src/repro/kernels/mlstm_scan.py:21 _mlstm_kernel): its
// training differentiates the jnp chunk math (models/ssm.py::_mlstm_chunk
// under lax.scan) by jax.grad.  The port's forward is a CUDA kernel
// (mlstm_scan.cu), which autograd cannot see through, so its backward is
// written by hand; kernels/ref.py (ref_mlstm_scan_bwd and its passes)
// states the same formulas in plain PyTorch.
//
// What it computes, per (batch, head) and chunk, from the forward's
// inputs, y, the signed denominators d_t and the carry (C0, n0, m0)
// entering every chunk, given dy and the grads (dC1, dn1, dm1) of the
// carry leaving it; with M_t = max(m0, cummax a), W_ts = e^{a_s - M_t} on
// s <= t, S = q·kᵀ, P = W ⊙ S, dnum_t = dy_t / max(|d_t|, 1) and dd_t =
// -(dy_t·y_t) / |d_t| · sign(d_t) where |d_t| > 1 (else 0):
//   dP = dnum·vᵀ + dd (on s <= t), dv = Pᵀ·dnum, dq = (dP ⊙ W)·k,
//   dk = (dP ⊙ W)ᵀ·q, da_s = Σ_t dP_ts P_ts;
//   the carry in, ι_t = e^{m0 - M_t}: dq += ι (C0ᵀ dnum + dd n0),
//   dC0 = decay·dC1 + Σ_t ι_t dnum_t q_tᵀ, dn0 = decay·dn1 + Σ_t ι_t dd_t q_t;
//   the carry out, wc_s = e^{a_s - M_L}: dk_s += wc_s (dC1ᵀ v_s + dn1),
//   dv_s += wc_s dC1 k_s;
//   then the gates: da, dm0 and the stabilizer's grads routed to the
//   argmax of max(m0, cummax a), di = da, df_log the reverse cumsum of
//   -da (+ dm1 at the chunk's end).
//
// The stabilizer's own grad dM_t (through W and ι) is taken in closed
// form, -(dy_t·y_t) where |d_t| <= 1 and exactly 0 where the clamp is
// inactive (|d_t| > 1, where y does not depend on M_t and the reference's
// dM is rounding noise): see kernels/ref.py.
//
// The five kernels, in stream order (one wrapper call, one launch count):
// * mlstm_bwd_rows_kernel, a warp a row: rden = 1 / max(|d|, 1), dd and
//   the row's dM, from dy·y.
// * mlstm_bwd_carry_kernel, one block per (b, h, [64 v x 128 k] tile of
//   dC), walks the chunks in reverse, the tile of dC in registers, and
//   writes the grad of the carry leaving every chunk but the last (the
//   forward's carry kernel walked them forward); per chunk also the
//   tile's share of <dC1, C0> + dn1·n0 (the decay's grad).
// * mlstm_bwd_keys_kernel, one block per (b, h, chunk, 64-row key tile,
//   128-column tile of dk / dv), all chunks in parallel: rebuilds the
//   [64 x 64] tiles of S and dP over the whole dh, as the flash backward
//   recomputes its scores, and accumulates dk, dv, the carry-out terms
//   and the per-step sums da_s (the keys' grads need no atomics).
// * mlstm_bwd_queries_kernel, one block per (b, h, chunk, 64-row query
//   tile, 128-column tile of dq): dq and the carry-in term with its share
//   of dm0.
// * mlstm_bwd_gates_kernel, one block per (b, h): the short sequential
//   pass over [S] scalars, chunks in reverse (the dm chain), the argmax
//   routing and the reverse cumsum.
//
// What bounds it on this card: per (b, h) and chunk, O(L²·dh) operations
// for the five score-sized products and O(L·dh²) for the four carry
// products, on O(L·dh) bytes in and out and the dh² carries: at xlstm-125m's
// widths (dh 384, chunk 256) ~110 operations a byte, so the operations
// bound it at the f32 rate.  This first design runs them on the CUDA
// cores in f32 (a 4 x 4 or 4 x 8 register tile a thread over 32-deep
// pieces staged in shared memory), rebuilds S and dP once per 128-column
// tile of the output, and reads every tile synchronously: simple and
// exact to f32, not fast (wgmma / TMA is later work).  Every sum has a
// fixed order: two launches give the same bits.

#include "common.cuh"
#include "mlstm_gates.cuh"

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads over a tile
constexpr int kTile = 64;         // rows of a tile (keys, queries, v of dC)
constexpr int kCols = 128;        // output columns of a block
constexpr int kPiece = 32;        // depth of one staged piece
constexpr int kMaxL = 256;        // the chunk limit: one gate a thread
constexpr int kLd64 = kTile + 4;  // a staged row of 64 floats
constexpr int kLd128 = kCols + 4;

struct BwdArgs {
  // the forward's inputs [B,H,S,dh] x3, [B,H,S] x2; y, dy [B,H,S,dh]; d
  const float *q, *k, *v, *ig, *fl, *y, *dy, *d;
  const float *C0, *n0, *m0;  // the given state, or all null
  const float *Cs, *ns, *ms;  // carries entering chunks 1..nc-1
  const float *dC, *dn, *dm;  // the final carry's grads, or null
  float *rden, *dd, *dM;      // [B,H,S] row scalars
  float *dCs, *dns;  // grads of the carries leaving chunks 0..nc-2
  float *dC0, *dn0, *dm0;  // the state's grads, or null
  float* ddp;    // [B,H,nc,ntA] tile shares of <dC1, C0> + dn1·n0
  float *dq, *dk, *dv;  // [B,H,S,dh]
  float* dA;     // [B,H,S] Σ_t dP_ts P_ts
  float *dwcp, *interp;  // [B,H,S,ncol] column-tile shares
  float *di, *df;  // [B,H,S]
  int H, S, dh, L, nc, ncol, ntA;
};

__device__ __forceinline__ float entry_m(const BwdArgs& p, int64_t bh,
                                         int c) {
  return c > 0 ? p.ms[bh * (p.nc - 1) + c - 1]
               : (p.m0 != nullptr ? p.m0[bh] : -INFINITY);
}
__device__ __forceinline__ const float* entry_C(const BwdArgs& p, int64_t bh,
                                                int c) {
  const int64_t dd2 = (int64_t)p.dh * p.dh;
  return c > 0 ? p.Cs + (bh * (p.nc - 1) + c - 1) * dd2
               : (p.C0 != nullptr ? p.C0 + bh * dd2 : nullptr);
}
__device__ __forceinline__ const float* entry_n(const BwdArgs& p, int64_t bh,
                                                int c) {
  return c > 0 ? p.ns + (bh * (p.nc - 1) + c - 1) * p.dh
               : (p.n0 != nullptr ? p.n0 + bh * p.dh : nullptr);
}

// The chunk's g, a, cummax a and M = max(cm, m0) into shared memory (one
// step a thread); starts and ends with a barrier.
__device__ __forceinline__ void chunk_gates(const BwdArgs& p, int64_t bh,
                                            int c, float m0, float* gs,
                                            float* as, float* cs, float* Ms,
                                            float* red) {
  const int tid = threadIdx.x, L = p.L;
  const int64_t idx = bh * p.S + (int64_t)c * L + tid;
  __syncthreads();  // red and the arrays are free
  gate_scan(tid < L ? p.ig[idx] : 0.f, tid < L ? p.fl[idx] : 0.f, L, gs, as,
            cs, red);
  if (tid < L) Ms[tid] = fmaxf(cs[tid], m0);
  __syncthreads();
}

// dst[k][r] = src[r·ld + k0 + k] for r < NROW, k < kPiece (a row-major
// [rows x depth] operand staged depth-major); zero where r >= rvalid or
// k0 + k >= kvalid (kvalid a multiple of 4).
template <int NROW>
__device__ __forceinline__ void stage_t(float* dst, int ldd, const float* src,
                                        int64_t ld, int rvalid, int k0,
                                        int kvalid) {
  constexpr int kq = kPiece / 4;
  for (int i = threadIdx.x; i < NROW * kq; i += kThreads) {
    const int r = i / kq, c = (i - r * kq) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rvalid && k0 + c < kvalid)
      x = *reinterpret_cast<const float4*>(src + r * ld + k0 + c);
    dst[c * ldd + r] = x.x;
    dst[(c + 1) * ldd + r] = x.y;
    dst[(c + 2) * ldd + r] = x.z;
    dst[(c + 3) * ldd + r] = x.w;
  }
}

// dst[k][n] = src[k·ld + n0 + n] (· scale[k] where scale is non-null) for
// k < kPiece, n < NCOL (a row-major [depth x cols] operand as it lies);
// zero where k >= kvalid or n0 + n >= nvalid (a multiple of 4).
template <int NCOL>
__device__ __forceinline__ void stage_n(float* dst, int ldd, const float* src,
                                        int64_t ld, int kvalid, int n0,
                                        int nvalid, const float* scale) {
  constexpr int nq = NCOL / 4;
  for (int i = threadIdx.x; i < kPiece * nq; i += kThreads) {
    const int kk = i / nq, c = (i - kk * nq) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kk < kvalid && n0 + c < nvalid) {
      x = *reinterpret_cast<const float4*>(src + kk * ld + n0 + c);
      if (scale != nullptr) {
        const float s = scale[kk];
        x.x *= s;
        x.y *= s;
        x.z *= s;
        x.w *= s;
      }
    }
    *reinterpret_cast<float4*>(dst + kk * ldd + c) = x;
  }
}

// Column of a thread's j-th accumulator in a 64-wide (NJ 4) or 128-wide
// (NJ 8) tile: 4 consecutive columns per 64, so a row of B is read as
// 16-byte loads on distinct banks.
__device__ __forceinline__ int col_of(int j) {
  return (j & 3) + 4 * (threadIdx.x & 15) + 64 * (j >> 2);
}

// acc[i][j] += Σ_k A[k][4ty + i] · B[k][col_of(j)] over one staged piece.
template <int NJ>
__device__ __forceinline__ void fma_piece(float (&acc)[4][NJ], const float* A,
                                          int lda, const float* B, int ldb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < kPiece; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(A + k * lda + 4 * ty);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[NJ];
#pragma unroll
    for (int h = 0; h < NJ / 4; ++h) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(B + k * ldb + 64 * h + 4 * tx);
      b[4 * h] = b4.x;
      b[4 * h + 1] = b4.y;
      b[4 * h + 2] = b4.z;
      b[4 * h + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Sum over the 16 threads of a tile row (tx), in a fixed order.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Write a thread's [4 x 8] tile at rows r0 + 4ty + i (< rvalid), columns
// n0 + col_of(j) (< dh) of a row-major [rows x dh] matrix.
__device__ __forceinline__ void store_tile(float* dst, int64_t dh,
                                           const float (&acc)[4][8], int r0,
                                           int rvalid, int n0, int nvalid) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rvalid) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + col_of(4 * h);
      if (c < nvalid)
        *reinterpret_cast<float4*>(dst + (r0 + r) * dh + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_rows_kernel(const BwdArgs p, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* yr = p.y + row * p.dh;
  const float* dyr = p.dy + row * p.dh;
  float s = 0.f;
  for (int e = 4 * lane; e < p.dh; e += 128) {
    const float4 a = *reinterpret_cast<const float4*>(yr + e);
    const float4 b = *reinterpret_cast<const float4*>(dyr + e);
    s = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, s))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const float d = p.d[row], ad = fabsf(d);
    const float r = 1.f / fmaxf(ad, 1.f);
    const bool big = ad > 1.f;
    p.rden[row] = r;
    p.dd[row] = big ? (d > 0.f ? -s * r : s * r) : 0.f;
    p.dM[row] = big ? 0.f : -s;
  }
}

// Shared floats of mlstm_bwd_carry_kernel.
constexpr int kCarrySmem = kPiece * kLd64 + kPiece * kLd128 + 4 * kMaxL +
                           2 * (kMaxL + kPiece) + 64;

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_carry_kernel(const BwdArgs p) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [kPiece][kLd64] w1·dy
  float* Bs = As + kPiece * kLd64;              // [kPiece][kLd128] q
  float* gs = Bs + kPiece * kLd128;             // [kMaxL] g
  float* as = gs + kMaxL;                       // [kMaxL] a
  float* cs = as + kMaxL;                       // [kMaxL] cummax a
  float* Ms = cs + kMaxL;                       // [kMaxL] M_t
  float* w1 = Ms + kMaxL;   // [kMaxL + kPiece] ι_t rden_t, 0 past L
  float* w2 = w1 + kMaxL + kPiece;  // [kMaxL + kPiece] ι_t dd_t
  float* red = w2 + kMaxL + kPiece;  // [32] gate_scan's
  float* red2 = red + 32;            // [32] the decay share's

  const int tid = threadIdx.x, ty = tid >> 4, lane = tid & 31;
  const int dh = p.dh, L = p.L, nc = p.nc;
  const int v0 = blockIdx.x * kTile, k0 = blockIdx.y * kCols;
  const int64_t bh = blockIdx.z, dd2 = (int64_t)dh * dh;
  const bool own_n = blockIdx.x == 0 && tid < kCols && k0 + tid < dh;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;

  // the tile of the grad of the carry leaving the current chunk
  float G[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = v0 + 4 * ty + i, c = k0 + col_of(j);
      G[i][j] = p.dC != nullptr && r < dh && c < dh
                    ? p.dC[bh * dd2 + r * dh + c]
                    : 0.f;
    }
  float gn = own_n && p.dn != nullptr ? p.dn[bh * dh + k0 + tid] : 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const float m0 = entry_m(p, bh, c);
    chunk_gates(p, bh, c, m0, gs, as, cs, Ms, red);
    const bool finite = m0 > -INFINITY;
    const float decay = finite ? expf(m0 - Ms[L - 1]) : 0.f;
    const int64_t row0 = bh * p.S + (int64_t)c * L;
    for (int t = tid; t < kMaxL + kPiece; t += kThreads) {
      const float io = finite && t < L ? expf(m0 - Ms[t]) : 0.f;
      w1[t] = t < L ? io * p.rden[row0 + t] : 0.f;
      w2[t] = t < L ? io * p.dd[row0 + t] : 0.f;
    }
    // this tile's share of <dC1, C0> + dn1·n0
    const float* Cc = entry_C(p, bh, c);
    const float* nc0 = entry_n(p, bh, c);
    float part = 0.f;
    if (Cc != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = v0 + 4 * ty + i, cc = k0 + col_of(j);
          if (r < dh && cc < dh) part = fmaf(G[i][j], Cc[r * dh + cc], part);
        }
      if (own_n) part = fmaf(gn, nc0[k0 + tid], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red2[tid >> 5] = part;
    __syncthreads();  // red2, w1 and w2 visible
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red2[w];
      p.ddp[(bh * nc + c) * p.ntA + tile] = s;
    }

    // Σ_t (ι_t rden_t dy_t[v]) q_t[k] over the chunk's steps
    float acc[4][8] = {};
    float gacc = 0.f;
    const float* dyb = p.dy + row0 * dh;
    const float* qb = p.q + row0 * dh;
    for (int t0 = 0; t0 < L; t0 += kPiece) {
      __syncthreads();
      stage_n<kTile>(As, kLd64, dyb + (int64_t)t0 * dh, dh, L - t0, v0, dh,
                     w1 + t0);
      stage_n<kCols>(Bs, kLd128, qb + (int64_t)t0 * dh, dh, L - t0, k0, dh,
                     nullptr);
      __syncthreads();
      fma_piece<8>(acc, As, kLd64, Bs, kLd128);
      if (own_n)
#pragma unroll 8
        for (int s = 0; s < kPiece; ++s)
          gacc = fmaf(w2[t0 + s], Bs[s * kLd128 + tid], gacc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) G[i][j] = fmaf(decay, G[i][j], acc[i][j]);
    gn = fmaf(decay, gn, gacc);
    float* dst = c > 0 ? p.dCs + (bh * (nc - 1) + c - 1) * dd2
                       : (p.dC0 != nullptr ? p.dC0 + bh * dd2 : nullptr);
    if (dst != nullptr) store_tile(dst, dh, G, v0, dh - v0, k0, dh);
    float* ndst = c > 0 ? p.dns + (bh * (nc - 1) + c - 1) * dh
                        : (p.dn0 != nullptr ? p.dn0 + bh * dh : nullptr);
    if (own_n && ndst != nullptr) ndst[k0 + tid] = gn;
  }
}

// Shared floats of the keys and queries kernels.
constexpr int kChunkSmem = 4 * kPiece * kLd64 + 2 * kTile * kLd64 +
                           2 * kPiece * kLd128 + 6 * kMaxL + 32 + kCols;

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_keys_kernel(const BwdArgs p) {
  extern __shared__ float4 smem4[];
  float* A0 = reinterpret_cast<float*>(smem4);  // [kPiece][kLd64] pieces
  float* B0 = A0 + kPiece * kLd64;
  float* A1 = B0 + kPiece * kLd64;
  float* B1 = A1 + kPiece * kLd64;
  float* Pt = B1 + kPiece * kLd64;   // [kTile t][kLd64] P_ts rden_t
  float* dSt = Pt + kTile * kLd64;   // [kTile t][kLd64] dS_ts
  float* N0 = dSt + kTile * kLd64;   // [kPiece][kLd128]
  float* N1 = N0 + kPiece * kLd128;
  float* gs = N1 + kPiece * kLd128;  // [kMaxL] x 6
  float* as = gs + kMaxL;
  float* cs = as + kMaxL;
  float* Ms = cs + kMaxL;
  float* rd = Ms + kMaxL;
  float* ddv = rd + kMaxL;
  float* red = ddv + kMaxL;  // [32]
  float* gnv = red + 32;     // [kCols] dn1 of the block's columns

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int dh = p.dh, L = p.L, nc = p.nc;
  const int n0 = blockIdx.x * kCols;
  const int s0 = blockIdx.y * kTile, sq = min(kTile, L - s0);
  const int c = blockIdx.z % nc;
  const int64_t bh = blockIdx.z / nc;
  const int64_t row0 = bh * p.S + (int64_t)c * L;
  const float* qb = p.q + row0 * dh;
  const float* kb = p.k + row0 * dh;
  const float* vb = p.v + row0 * dh;
  const float* dyb = p.dy + row0 * dh;
  const float m0 = entry_m(p, bh, c);
  if (tid < L) {
    rd[tid] = p.rden[row0 + tid];
    ddv[tid] = p.dd[row0 + tid];
  }
  chunk_gates(p, bh, c, m0, gs, as, cs, Ms, red);

  float dk[4][8] = {}, dv[4][8] = {}, dA[4] = {};
  const int nt = (L + kTile - 1) / kTile;
  for (int tt = blockIdx.y; tt < nt; ++tt) {
    const int t0 = tt * kTile, tq = min(kTile, L - t0);
    // S_st = k_s·q_t and D_st = v_s·dy_t over the whole dh
    float aS[4][4] = {}, aD[4][4] = {};
    for (int d0 = 0; d0 < dh; d0 += kPiece) {
      __syncthreads();
      stage_t<kTile>(A0, kLd64, kb + (int64_t)s0 * dh, dh, sq, d0, dh);
      stage_t<kTile>(B0, kLd64, qb + (int64_t)t0 * dh, dh, tq, d0, dh);
      stage_t<kTile>(A1, kLd64, vb + (int64_t)s0 * dh, dh, sq, d0, dh);
      stage_t<kTile>(B1, kLd64, dyb + (int64_t)t0 * dh, dh, tq, d0, dh);
      __syncthreads();
      fma_piece<4>(aS, A0, kLd64, B0, kLd64);
      fma_piece<4>(aD, A1, kLd64, B1, kLd64);
    }
    // P, dP = rden_t D + dd_t, dS = dP ⊙ W on s <= t; da_s += Σ_t dP P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = 4 * ty + i, tl = col_of(j), s = s0 + sl, t = t0 + tl;
        float pr = 0.f, ds = 0.f;
        if (sl < sq && tl < tq && s <= t) {
          const float w = expf(as[s] - Ms[t]);
          const float pv = w * aS[i][j];
          const float dp = fmaf(rd[t], aD[i][j], ddv[t]);
          dA[i] = fmaf(dp, pv, dA[i]);
          pr = pv * rd[t];
          ds = dp * w;
        }
        Pt[tl * kLd64 + sl] = pr;
        dSt[tl * kLd64 + sl] = ds;
      }
    // dv_s += Σ_t P_ts rden_t dy_t, dk_s += Σ_t dS_ts q_t on the columns
    for (int k0 = 0; k0 < tq; k0 += kPiece) {
      __syncthreads();  // Pt / dSt written, N0 / N1 free
      stage_n<kCols>(N0, kLd128, dyb + (int64_t)(t0 + k0) * dh, dh, tq - k0,
                     n0, dh, nullptr);
      stage_n<kCols>(N1, kLd128, qb + (int64_t)(t0 + k0) * dh, dh, tq - k0,
                     n0, dh, nullptr);
      __syncthreads();
      fma_piece<8>(dv, Pt + k0 * kLd64, kLd64, N0, kLd128);
      fma_piece<8>(dk, dSt + k0 * kLd64, kLd64, N1, kLd128);
    }
  }

  // the carry out: dk_s += wc_s (dC1ᵀ v_s + dn1), dv_s += wc_s dC1 k_s,
  // and dwc_s = k_s·(dC1ᵀ v_s + dn1) on the block's columns
  const int64_t dd2 = (int64_t)dh * dh;
  const float* G1 = c + 1 < nc ? p.dCs + (bh * (nc - 1) + c) * dd2
                               : (p.dC != nullptr ? p.dC + bh * dd2 : nullptr);
  const float* g1n = c + 1 < nc ? p.dns + (bh * (nc - 1) + c) * dh
                                : (p.dn != nullptr ? p.dn + bh * dh : nullptr);
  float dwc[4] = {};
  if (G1 != nullptr) {
    if (tid < kCols) gnv[tid] = n0 + tid < dh ? g1n[n0 + tid] : 0.f;
    float wc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wc[i] = 4 * ty + i < sq ? expf(as[s0 + 4 * ty + i] - Ms[L - 1]) : 0.f;
    float X[4][8] = {};
    for (int d0 = 0; d0 < dh; d0 += kPiece) {
      __syncthreads();
      stage_t<kTile>(A0, kLd64, vb + (int64_t)s0 * dh, dh, sq, d0, dh);
      stage_n<kCols>(N0, kLd128, G1 + (int64_t)d0 * dh, dh, dh - d0, n0, dh,
                     nullptr);
      __syncthreads();
      fma_piece<8>(X, A0, kLd64, N0, kLd128);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + col_of(j);
        if (sl < sq && n < dh) {
          const float x = X[i][j] + gnv[col_of(j)];
          dk[i][j] = fmaf(wc[i], x, dk[i][j]);
          dwc[i] = fmaf(kb[(int64_t)(s0 + sl) * dh + n], x, dwc[i]);
        }
      }
    }
    float Y[4][8] = {};
    for (int d0 = 0; d0 < dh; d0 += kPiece) {
      __syncthreads();
      stage_t<kTile>(A0, kLd64, kb + (int64_t)s0 * dh, dh, sq, d0, dh);
      stage_t<kCols>(N0, kLd128, G1 + (int64_t)n0 * dh, dh, dh - n0, d0, dh);
      __syncthreads();
      fma_piece<8>(Y, A0, kLd64, N0, kLd128);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dv[i][j] = fmaf(wc[i], Y[i][j], dv[i][j]);
  }

  store_tile(p.dk + row0 * dh, dh, dk, s0, sq, n0, dh);
  store_tile(p.dv + row0 * dh, dh, dv, s0, sq, n0, dh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = row_sum(dA[i]), w = row_sum(dwc[i]);
    const int sl = 4 * ty + i;
    if (tx == 0 && sl < sq) {
      if (blockIdx.x == 0) p.dA[row0 + s0 + sl] = a;
      p.dwcp[(row0 + s0 + sl) * p.ncol + blockIdx.x] = w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_queries_kernel(const BwdArgs p) {
  extern __shared__ float4 smem4[];
  float* A0 = reinterpret_cast<float*>(smem4);  // [kPiece][kLd64] pieces
  float* B0 = A0 + kPiece * kLd64;
  float* A1 = B0 + kPiece * kLd64;
  float* B1 = A1 + kPiece * kLd64;
  float* dSs = B1 + kPiece * kLd64;  // [kTile s][kLd64] dS_ts
  float* N0 = dSs + 2 * kTile * kLd64;  // [kPiece][kLd128]
  float* gs = N0 + 2 * kPiece * kLd128;  // [kMaxL] x 6
  float* as = gs + kMaxL;
  float* cs = as + kMaxL;
  float* Ms = cs + kMaxL;
  float* rd = Ms + kMaxL;
  float* ddv = rd + kMaxL;
  float* red = ddv + kMaxL;  // [32]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int dh = p.dh, L = p.L, nc = p.nc;
  const int n0 = blockIdx.x * kCols;
  const int t0 = blockIdx.y * kTile, tq = min(kTile, L - t0);
  const int c = blockIdx.z % nc;
  const int64_t bh = blockIdx.z / nc;
  const int64_t row0 = bh * p.S + (int64_t)c * L;
  const float* qb = p.q + row0 * dh;
  const float* kb = p.k + row0 * dh;
  const float* vb = p.v + row0 * dh;
  const float* dyb = p.dy + row0 * dh;
  const float m0 = entry_m(p, bh, c);
  if (tid < L) {
    rd[tid] = p.rden[row0 + tid];
    ddv[tid] = p.dd[row0 + tid];
  }
  chunk_gates(p, bh, c, m0, gs, as, cs, Ms, red);

  float dq[4][8] = {};
  for (int st = 0; st <= (int)blockIdx.y; ++st) {
    const int s0 = st * kTile, sq = min(kTile, L - s0);
    // S_ts = q_t·k_s and D_ts = dy_t·v_s over the whole dh
    float aS[4][4] = {}, aD[4][4] = {};
    for (int d0 = 0; d0 < dh; d0 += kPiece) {
      __syncthreads();
      stage_t<kTile>(A0, kLd64, qb + (int64_t)t0 * dh, dh, tq, d0, dh);
      stage_t<kTile>(B0, kLd64, kb + (int64_t)s0 * dh, dh, sq, d0, dh);
      stage_t<kTile>(A1, kLd64, dyb + (int64_t)t0 * dh, dh, tq, d0, dh);
      stage_t<kTile>(B1, kLd64, vb + (int64_t)s0 * dh, dh, sq, d0, dh);
      __syncthreads();
      fma_piece<4>(aS, A0, kLd64, B0, kLd64);
      fma_piece<4>(aD, A1, kLd64, B1, kLd64);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tl = 4 * ty + i, sl = col_of(j), t = t0 + tl, s = s0 + sl;
        float ds = 0.f;
        if (tl < tq && sl < sq && s <= t)
          ds = fmaf(rd[t], aD[i][j], ddv[t]) * expf(as[s] - Ms[t]);
        dSs[sl * kLd64 + tl] = ds;
      }
    // dq_t += Σ_s dS_ts k_s on the columns
    for (int k0 = 0; k0 < sq; k0 += kPiece) {
      __syncthreads();
      stage_n<kCols>(N0, kLd128, kb + (int64_t)(s0 + k0) * dh, dh, sq - k0,
                     n0, dh, nullptr);
      __syncthreads();
      fma_piece<8>(dq, dSs + k0 * kLd64, kLd64, N0, kLd128);
    }
  }

  // the carry in: dq_t += ι_t (rden_t C0ᵀ dy_t + dd_t n0), and its share
  // of dm0, q_t·(that)
  float inter[4] = {};
  const float* Cc = entry_C(p, bh, c);
  if (Cc != nullptr && m0 > -INFINITY) {
    const float* nc0 = entry_n(p, bh, c);
    float Z[4][8] = {};
    for (int d0 = 0; d0 < dh; d0 += kPiece) {
      __syncthreads();
      stage_t<kTile>(A0, kLd64, dyb + (int64_t)t0 * dh, dh, tq, d0, dh);
      stage_n<kCols>(N0, kLd128, Cc + (int64_t)d0 * dh, dh, dh - d0, n0, dh,
                     nullptr);
      __syncthreads();
      fma_piece<8>(Z, A0, kLd64, N0, kLd128);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = 4 * ty + i;
      if (tl >= tq) continue;
      const int t = t0 + tl;
      const float io = expf(m0 - Ms[t]);
      const float a1 = io * rd[t], a2 = io * ddv[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + col_of(j);
        if (n < dh) {
          const float x = fmaf(a1, Z[i][j], a2 * nc0[n]);
          dq[i][j] += x;
          inter[i] = fmaf(qb[(int64_t)t * dh + n], x, inter[i]);
        }
      }
    }
  }
  store_tile(p.dq + row0 * dh, dh, dq, t0, tq, n0, dh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = row_sum(inter[i]);
    const int tl = 4 * ty + i;
    if (tx == 0 && tl < tq)
      p.interp[(row0 + t0 + tl) * p.ncol + blockIdx.x] = x;
  }
}

// Shared floats of mlstm_bwd_gates_kernel.
constexpr int kGatesSmem = 9 * kMaxL + 32 + 4;

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gates_kernel(const BwdArgs p) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);  // [kMaxL] x 9
  float* as = gs + kMaxL;
  float* cs = as + kMaxL;
  float* Ms = cs + kMaxL;
  float* da = Ms + kMaxL;    // da_s
  float* wd = da + kMaxL;    // wc_s dwc_s
  float* dMs = wd + kMaxL;   // dM_t
  float* it = dMs + kMaxL;   // inter_t
  float* dfv = it + kMaxL;   // df_s
  float* red = dfv + kMaxL;  // [32]
  float* carry = red + 32;   // [1] the next dm1

  const int tid = threadIdx.x, L = p.L, nc = p.nc;
  const int64_t bh = blockIdx.x;
  float dm1 = p.dm != nullptr ? p.dm[bh] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float m0 = entry_m(p, bh, c);
    chunk_gates(p, bh, c, m0, gs, as, cs, Ms, red);
    const float ML = Ms[L - 1];
    const bool finite = m0 > -INFINITY;
    const float decay = finite ? expf(m0 - ML) : 0.f;
    const int64_t row0 = bh * p.S + (int64_t)c * L;
    if (tid < L) {
      const int64_t r = row0 + tid;
      float w = 0.f, x = 0.f;
      for (int j = 0; j < p.ncol; ++j) {
        w += p.dwcp[r * p.ncol + j];
        x += p.interp[r * p.ncol + j];
      }
      w *= expf(as[tid] - ML);
      wd[tid] = w;
      da[tid] = p.dA[r] + w;
      dMs[tid] = p.dM[r];
      it[tid] = x;
    }
    __syncthreads();
    if (tid == 0) {
      float ddec = 0.f, swd = 0.f, sit = 0.f;
      for (int j = 0; j < p.ntA; ++j) ddec += p.ddp[(bh * nc + c) * p.ntA + j];
      for (int t = 0; t < L; ++t) {
        swd += wd[t];
        sit += it[t];
      }
      dMs[L - 1] += dm1 - swd - decay * ddec;
      float dm0 = finite ? sit + decay * ddec : 0.f;
      // each dM_t to m0 or to the argmax of a_{<=t} (the last on a tie,
      // as torch.cummax), half each where m0 ties the running max
      float best = -INFINITY;
      int arg = 0;
      for (int t = 0; t < L; ++t) {
        if (as[t] >= best) {
          best = as[t];
          arg = t;
        }
        const float x = dMs[t];
        if (m0 > best) {
          dm0 += x;
        } else if (best > m0) {
          da[arg] += x;
        } else {
          dm0 += 0.5f * x;
          da[arg] += 0.5f * x;
        }
      }
      // df_s = Σ_{t >= s} dg_t, dg_t = -da_t (+ dm1 at the chunk's end)
      float run = dm1;
      for (int t = L - 1; t >= 0; --t) {
        run -= da[t];
        dfv[t] = run;
      }
      carry[0] = dm0;
    }
    __syncthreads();
    if (tid < L) {
      p.di[row0 + tid] = da[tid];
      p.df[row0 + tid] = dfv[tid];
    }
    dm1 = carry[0];
  }
  if (tid == 0 && p.dm0 != nullptr) p.dm0[bh] = dm1;
}

}  // namespace

// The backward of repro_mlstm_scan (mlstm_scan.cu): all tensors f32,
// contiguous, q/k/v/y/dy/C0/Cs/dC 16-byte aligned, dh % 4 == 0,
// 0 < L <= 256, S % L == 0, nc = S / L.  Inputs: q, k, v, ig, fl, y and
// dy [B,H,S,(dh)]; d [B,H,S] (the forward's denominators); the state C0,
// n0, m0 (all null for a scan from zero); Cs [B,H,nc-1,dh,dh], ns, ms
// (the forward's kept carries; null when nc == 1); dC, dn (both null or
// both given) and dm (or null), the final carry's grads.  Scratch: rden,
// dd, dM [B,H,S]; dCs [B,H,nc-1,dh,dh], dns (null when nc == 1); ddp
// [B,H,nc,ntA]; dA [B,H,S]; dwcp, interp [B,H,S,ncol].  Outputs: dq, dk,
// dv [B,H,S,dh]; di, df [B,H,S]; dC0, dn0, dm0 (or null), the state's
// grads.  ncol = ceil(dh / 128), ntA = ceil(dh / 64) · ncol.
extern "C" int repro_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fl, const void* y, const void* dy, const void* d,
    const void* C0, const void* n0, const void* m0, const void* Cs,
    const void* ns, const void* ms, const void* dC, const void* dn,
    const void* dm, void* rden, void* dd, void* dM, void* dCs, void* dns,
    void* dC0, void* dn0, void* dm0, void* ddp, void* dq, void* dk, void* dv,
    void* dA, void* dwcp, void* interp, void* di, void* df, int B, int H,
    int S, int dh, int L, void* stream) {
  const bool init = C0 != nullptr;
  const int nc = L > 0 ? S / L : 0;
  if ((n0 != nullptr) != init || (m0 != nullptr) != init ||
      (dn != nullptr) != (dC != nullptr) || L <= 0 || L > kMaxL ||
      S % L != 0 || dh <= 0 || dh % 4 != 0 ||
      (nc > 1 && (Cs == nullptr || ns == nullptr || ms == nullptr ||
                  dCs == nullptr || dns == nullptr)))
    return cudaErrorInvalidValue;
  const int ncol = (dh + kCols - 1) / kCols;
  const int nvt = (dh + kTile - 1) / kTile;
  BwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.ig = static_cast<const float*>(ig);
  a.fl = static_cast<const float*>(fl);
  a.y = static_cast<const float*>(y);
  a.dy = static_cast<const float*>(dy);
  a.d = static_cast<const float*>(d);
  a.C0 = static_cast<const float*>(C0);
  a.n0 = static_cast<const float*>(n0);
  a.m0 = static_cast<const float*>(m0);
  a.Cs = static_cast<const float*>(Cs);
  a.ns = static_cast<const float*>(ns);
  a.ms = static_cast<const float*>(ms);
  a.dC = static_cast<const float*>(dC);
  a.dn = static_cast<const float*>(dn);
  a.dm = static_cast<const float*>(dm);
  a.rden = static_cast<float*>(rden);
  a.dd = static_cast<float*>(dd);
  a.dM = static_cast<float*>(dM);
  a.dCs = static_cast<float*>(dCs);
  a.dns = static_cast<float*>(dns);
  a.dC0 = static_cast<float*>(dC0);
  a.dn0 = static_cast<float*>(dn0);
  a.dm0 = static_cast<float*>(dm0);
  a.ddp = static_cast<float*>(ddp);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dA = static_cast<float*>(dA);
  a.dwcp = static_cast<float*>(dwcp);
  a.interp = static_cast<float*>(interp);
  a.di = static_cast<float*>(di);
  a.df = static_cast<float*>(df);
  a.H = H;
  a.S = S;
  a.dh = dh;
  a.L = L;
  a.nc = nc;
  a.ncol = ncol;
  a.ntA = nvt * ncol;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int carry_smem = kCarrySmem * (int)sizeof(float);
  const int chunk_smem = kChunkSmem * (int)sizeof(float);
  const int gates_smem = kGatesSmem * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_carry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      carry_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_keys_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               chunk_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_queries_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               chunk_smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)B * H * S;
  const int row_blocks = (int)((rows + kThreads / 32 - 1) / (kThreads / 32));
  mlstm_bwd_rows_kernel<<<row_blocks, kThreads, 0, st>>>(a, rows);
  mlstm_bwd_carry_kernel<<<dim3(nvt, ncol, B * H), kThreads, carry_smem,
                           st>>>(a);
  const dim3 chunk_grid(ncol, (L + kTile - 1) / kTile, B * H * nc);
  mlstm_bwd_keys_kernel<<<chunk_grid, kThreads, chunk_smem, st>>>(a);
  mlstm_bwd_queries_kernel<<<chunk_grid, kThreads, chunk_smem, st>>>(a);
  mlstm_bwd_gates_kernel<<<B * H, kThreads, gates_smem, st>>>(a);
  return cudaGetLastError();
}
