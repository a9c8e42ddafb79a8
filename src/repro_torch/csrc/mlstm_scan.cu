// Chunkwise-parallel mLSTM scan for Hopper, sm_90a: two kernels, the
// products in 3xTF32 on the tensor cores.
//
// Replaces: src/repro/kernels/mlstm_scan.py:21 _mlstm_kernel (reached
// through mlstm_scan:70, pallas_call at :81), the chunk math of
// models/ssm.py::_mlstm_chunk scanned over the chunks.
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
// S·dh²) operations on O(S·dh) bytes.  At xlstm-125m's widths (dh 384,
// chunk 256) that is ~100 operations per byte: above the f32 SIMT balance
// (67 TFLOP/s over 3.35 TB/s = 20) and below the TF32 tensor cores' (148),
// so the bytes bound it once the products run on the tensor cores.
//
// The design, the two levels of tiling of TFLA (Beck et al., "Tiled Flash
// Linear Attention", arXiv:2503.14376):
//
// * mlstm_carry_kernel, one block per (b, h, [64 v x 128 k] tile of C),
//   walks the chunks in order.  Per chunk it takes the gate statistics by
//   warp scans (g, a, the chunk's own maximum A_c = max_s a_s), builds the
//   chunk's own state ΔC = Σ_s e^{a_s - A_c} v_s k_sᵀ (and Δn in the blocks
//   of v tile 0) over 32-step pieces, and folds it into the carry it keeps
//   in registers: M_L = max(m, A_c), C = e^{A_c - M_L} ΔC + e^{m - M_L} C.
//   ΔC needs no m, so no product waits on the scalar chain.  It writes the
//   carry after every chunk but the last to a scratch (nc - 1 carries of
//   dh² f32 a (b, h)) and the last as the final state.  Building the
//   chunk states in parallel and folding them in a second pass would
//   write and read every ΔC once more; here ΔC never goes to memory.
// * mlstm_out_kernel, one block of 16 warps per (b, h, chunk, 64-row q
//   tile), all chunks in parallel from their entry carries: the causal
//   scores q·kᵀ of the tile are built once over the whole dh (up to
//   [64 x 256] in registers), weighted by e^{a_s - M_t} into a P tile in
//   shared memory with its row sums, then for each 384-wide v tile
//   y = (e^{m - M_t} q·Cᵀ + P·V) / max(|d|, 1).  It is launched as the
//   carry kernel's programmatic dependent: its blocks of chunk 0, which
//   need no carry, are dispatched first and run on the SMs the carry
//   kernel's last blocks leave idle; the others wait for that grid.
//
// Every product runs on mma.sync.m16n8k8 with tf32 operands split as
// hi = rna(x), lo = x - hi truncated to tf32, and summed lo·hi + hi·lo +
// hi·hi in f32 (one TF32 product misses the reference's 2e-4).  mma.sync
// reads its fragments from shared memory with scalar loads, so K-major
// tiles (q, k and C rows for q·kᵀ and q·Cᵀ; P for P·V) and MN-major tiles
// (V for P·V; v and k for ΔC, whose depth is the step s) are read as they
// lie: rows padded to 4 (mod 32) floats when K-major and 8 (mod 32) when
// MN-major keep the 32 lanes on 32 banks.  Tiles are staged by 16-byte
// cp.async in 32-deep pieces, two buffers, the next piece in flight under
// the current one's products.  q·n and Δn are f32 sums on the CUDA cores.
// No atomics: every sum has a fixed order, so two launches give the same
// bits.
//
// Numerics follow the TPU kernel in f32: exp(-inf - M) = 0 on the first
// chunk, pad steps at i = -1e30 weigh e^{-1e30} = 0, and expf is the
// accurate one (no fast math).

#include "common.cuh"
#include "mlstm_gates.cuh"

namespace {

constexpr int kThreads = 256;     // carry kernel: 8 warps, 2 x 4
constexpr int kOutThreads = 512;  // output kernel: 16 warps, 2 x 8
constexpr int kRows = 64;      // rows of an output tile: q rows, C's v rows
constexpr int kCols = 128;     // columns of a C tile
constexpr int kVT = 384;       // columns of a y tile: 48 a warp, 6 n8 tiles
constexpr int kPiece = 32;     // depth of one staged piece
constexpr int kMaxL = 256;     // the chunk limit: one gate a thread
constexpr int kLdK = kPiece + 4;    // K-major piece row, 4 (mod 32)
constexpr int kLdRows = kRows + 8;  // MN-major row of 64, 8 (mod 32)
constexpr int kLdCols = kCols + 8;  // MN-major row of 128, 8 (mod 32)
constexpr int kLdVT = kVT + 8;      // MN-major row of 384, 8 (mod 32)

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 copies nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [0, nrow) x floats [0, W) of a row-major matrix (row stride
// ld) into dst (row stride lds); row r is read if r < rvalid, float c if
// c < cvalid (a multiple of 4), the rest is zero-filled.
template <int W>
__device__ __forceinline__ void stage(float* dst, int lds, const float* src,
                                      int64_t ld, int nrow, int rvalid,
                                      int cvalid) {
  constexpr int kVec = W / 4;
  for (int i = threadIdx.x; i < nrow * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i - r * kVec) * 4;
    const bool in = r < rvalid && c < cvalid;
    cp_async16(dst + r * lds + c, in ? src + r * ld + c : src, in);
  }
}

// x = hi + lo to ~21 bits, both tf32 bit patterns (the low 13 bits zero):
// hi = x rounded to nearest, ties away (cvt.rna's rounding, by an integer
// add on the magnitude bits: two integer ops where cvt is slower), lo =
// x - hi (exact in f32) truncated.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// d[16x8] += a[16x8] b[8x8], tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[i][j] (16 x 8 tiles at rows m0 + 16i, columns n0 + 8j, for
// j < nt) += A[m, k] B[k, n] over the kPiece-deep staged piece, in 3xTF32.
// A(m, k) = AK ? a[m·lda + k] : a[k·lda + m] (K-major or MN-major), B(k, n)
// = BK ? b[n·ldb + k] : b[k·ldb + n]; with kScale, A(m, k) is multiplied
// by scale[k] first (in f32, before the split).
template <int MT, int NT, bool AK, bool BK, bool kScale>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* a, int lda, int m0,
                                         const float* b, int ldb, int n0,
                                         int nt, const float* scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < kPiece; k0 += 8) {
    const int c0 = k0 + t, c1 = c0 + 4;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = m0 + 16 * i + g, r1 = r0 + 8;
      float x[4];
      x[0] = AK ? a[r0 * lda + c0] : a[c0 * lda + r0];
      x[1] = AK ? a[r1 * lda + c0] : a[c0 * lda + r1];
      x[2] = AK ? a[r0 * lda + c1] : a[c1 * lda + r0];
      x[3] = AK ? a[r1 * lda + c1] : a[c1 * lda + r1];
      if (kScale) {
        const float s0 = scale[c0], s1 = scale[c1];
        x[0] *= s0;
        x[1] *= s0;
        x[2] *= s1;
        x[3] *= s1;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], ah[i][e], al[i][e]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int n = n0 + 8 * j + g;
        const float y0 = BK ? b[n * ldb + c0] : b[c0 * ldb + n];
        const float y1 = BK ? b[n * ldb + c1] : b[c1 * ldb + n];
        uint32_t bh0, bl0, bh1, bl1;
        split(y0, bh0, bl0);
        split(y1, bh1, bl1);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_tf32(acc[i][j], al[i], bh0, bh1);
          mma_tf32(acc[i][j], ah[i], bl0, bl1);
          mma_tf32(acc[i][j], ah[i], bh0, bh1);
        }
      }
    }
  }
}

struct Args {
  const float *q, *k, *v, *ig, *fl;  // [B,H,S,dh] x3, [B,H,S] x2
  const float *C0, *n0, *m0;         // the initial carry, or all null
  float *Cs, *ns, *ms;  // carries after chunks 0..nc-2 [B,H,nc-1,...]
  float *y, *C, *n, *m;  // outputs: y [B,H,S,dh], the final carry
  float* d;  // [B,H,S] the signed denominators, for the backward, or null
  int H, S, dh, L, nc;
};

// Shared floats of mlstm_carry_kernel.
constexpr int kCarrySmem =
    2 * kPiece * kLdRows + 2 * kPiece * kLdCols + 3 * kMaxL + kMaxL +
    kPiece + 32;

__global__ void __launch_bounds__(kThreads)
mlstm_carry_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // [2][kPiece][kLdRows] v
  float* ks = vs + 2 * kPiece * kLdRows;        // [2][kPiece][kLdCols] k
  float* gs = ks + 2 * kPiece * kLdCols;        // [kMaxL] g
  float* as = gs + kMaxL;                       // [kMaxL] a
  float* cs = as + kMaxL;                       // [kMaxL] cummax a
  float* ws = cs + kMaxL;  // [kMaxL + kPiece] e^{a - A_c}, 0 past L
  float* red = ws + kMaxL + kPiece;             // [32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int dh = p.dh, L = p.L, nc = p.nc;
  const int v0 = blockIdx.x * kRows, k0 = blockIdx.y * kCols;
  const int64_t bh = blockIdx.z;
  const float* kb = p.k + bh * p.S * dh;
  const float* vb = p.v + bh * p.S * dh;
  const float* ib = p.ig + bh * p.S;
  const float* fb = p.fl + bh * p.S;
  const bool init = p.C0 != nullptr;
  const bool own_n = blockIdx.x == 0 && tid < kCols && k0 + tid < dh;
  const int np = (L + kPiece - 1) / kPiece;
  // the output kernel may start once every block of this grid has: its
  // blocks of chunk 0 need nothing from here and fill the SMs this grid's
  // last blocks leave idle (the others wait for the whole grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the carry's tile in the accumulator layout: row v0 + 32wm + 16i + g
  // (+8 for e >= 2), column k0 + 32wn + 8j + 2t (+1 for odd e)
  float carry[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = v0 + 32 * wm + 16 * i + g + 8 * (e >> 1);
        const int c = k0 + 32 * wn + 8 * j + 2 * t + (e & 1);
        carry[i][j][e] = (init && r < dh && c < dh)
                             ? p.C0[(bh * dh + r) * dh + c]
                             : 0.f;
      }
  float ncar = own_n && init ? p.n0[bh * dh + k0 + tid] : 0.f;
  float m_prev = init ? p.m0[bh] : -INFINITY;
  // the next chunk's gates, loaded a chunk ahead of their scan
  float i_next = tid < L ? ib[tid] : 0.f, f_next = tid < L ? fb[tid] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t row0 = (int64_t)c * L;
    const float i_cur = i_next, f_cur = f_next;
    if (c + 1 < nc && tid < L) {
      i_next = ib[row0 + L + tid];
      f_next = fb[row0 + L + tid];
    }
    auto issue = [&](int pc, int buf) {
      const int s0 = pc * kPiece, rows = min(kPiece, L - s0);
      const int64_t off = (row0 + s0) * dh;
      stage<kRows>(vs + buf * kPiece * kLdRows, kLdRows, vb + off + v0, dh,
                   kPiece, rows, dh - v0);
      stage<kCols>(ks + buf * kPiece * kLdCols, kLdCols, kb + off + k0, dh,
                   kPiece, rows, dh - k0);
      cp_async_commit();
    };
    issue(0, 0);  // the previous chunk's last barrier freed both buffers
    gate_scan(i_cur, f_cur, L, gs, as, cs, red);
    const float A = cs[L - 1], gL = gs[L - 1];
    for (int s = tid; s < np * kPiece; s += kThreads)
      ws[s] = s < L ? expf(as[s] - A) : 0.f;
    const float M = fmaxf(m_prev, A);
    const float up = expf(A - M), decay = expf(m_prev - M);

    float acc[2][4][4] = {};
    float dn = 0.f;
    for (int pc = 0; pc < np; ++pc) {
      if (pc + 1 < np) {
        issue(pc + 1, (pc + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the piece (and ws) visible to every warp
      const float* vp = vs + (pc & 1) * kPiece * kLdRows;
      const float* kp = ks + (pc & 1) * kPiece * kLdCols;
      const float* wp = ws + pc * kPiece;
      // ΔC[v, k] += Σ_s (w_s v_s[v]) k_s[k]: A = vᵀ and B = k, both MN-major
      warp_mma<2, 4, false, false, true>(acc, vp, kLdRows, 32 * wm, kp,
                                         kLdCols, 32 * wn, 4, wp);
      if (own_n)
#pragma unroll 8
        for (int s = 0; s < kPiece; ++s)
          dn = fmaf(wp[s], kp[s * kLdCols + tid], dn);
      __syncthreads();  // the buffer is free for the piece after next
    }

    // fold ΔC into the carry and write it: the entry carry of chunk c + 1,
    // or the final state
    float* dst = c + 1 < nc ? p.Cs + (bh * (nc - 1) + c) * dh * dh
                            : p.C + bh * dh * dh;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* cr = &carry[i][j][2 * h];
          cr[0] = up * acc[i][j][2 * h] + decay * cr[0];
          cr[1] = up * acc[i][j][2 * h + 1] + decay * cr[1];
          const int r = v0 + 32 * wm + 16 * i + g + 8 * h;
          const int col = k0 + 32 * wn + 8 * j + 2 * t;
          if (r < dh && col < dh)  // dh % 4 == 0: col + 1 < dh too
            *reinterpret_cast<float2*>(dst + (int64_t)r * dh + col) =
                make_float2(cr[0], cr[1]);
        }
    if (own_n) {
      ncar = up * dn + decay * ncar;
      (c + 1 < nc ? p.ns + (bh * (nc - 1) + c) * dh : p.n + bh * dh)[k0 + tid] =
          ncar;
    }
    m_prev = gL + M;
    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
      *(c + 1 < nc ? p.ms + bh * (nc - 1) + c : p.m + bh) = m_prev;
  }
}

// Shared floats of mlstm_out_kernel for a chunk of L (Lp = L rounded up
// to kPiece): the P tile, two stage buffers, gate statistics, row values.
__host__ __device__ constexpr int out_stage_floats(int Lp) {
  return (kRows + Lp) * kLdK > (kRows + kVT) * kLdK
             ? (kRows + Lp) * kLdK
             : (kRows + kVT) * kLdK;  // >= kPiece * kLdVT as well
}
__host__ __device__ constexpr int out_smem_floats(int Lp) {
  return kRows * (Lp + 4) + 2 * out_stage_floats(Lp) + 3 * kMaxL +
         12 * kRows + 32;
}

__global__ void __launch_bounds__(kOutThreads, 1)
mlstm_out_kernel(const Args p) {
  const int dh = p.dh, L = p.L, nc = p.nc;
  const int Lp = (L + kPiece - 1) / kPiece * kPiece, ldp = Lp + 4;
  const int sf = out_stage_floats(Lp);
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);  // [kRows][ldp] P
  float* st = ps + kRows * ldp;                 // [2][sf] stage buffers
  float* gs = st + 2 * sf;                      // [kMaxL] g
  float* as = gs + kMaxL;                       // [kMaxL] a
  float* cs = as + kMaxL;                       // [kMaxL] cummax a
  float* Ms = cs + kMaxL;                       // [kRows] M_t
  float* inter = Ms + kRows;                    // [kRows] e^{m - M_t}
  float* qn = inter + kRows;                    // [kRows] q_t·n
  float* den = qn + kRows;                      // [kRows] max(|d_t|, 1)
  float* rsum = den + kRows;                    // [kRows][8] P row sums
  float* red = rsum + 8 * kRows;                // [32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * kRows, tq = min(kRows, L - t0);
  const int c = blockIdx.z;  // slowest: chunk 0's blocks are dispatched first
  const int64_t bh = blockIdx.y;
  const int nkeys = t0 + tq;                                // keys s < nkeys
  const int nkp = (nkeys + kPiece - 1) / kPiece * kPiece;  // <= Lp
  // the score product: warp wn takes keys [8 ntw wn, 8 ntw (wn + 1)),
  // ntk of its n8 tiles below nkp
  const int ntw = (nkp + 63) / 64;
  const int ntk = max(0, min(ntw, (nkp - 8 * ntw * wn) / 8));
  const int64_t row0 = (int64_t)c * L;
  const float* qb = p.q + (bh * p.S + row0 + t0) * dh;  // the q tile
  const float* kb = p.k + (bh * p.S + row0) * dh;       // the chunk's k
  const float* vb = p.v + (bh * p.S + row0) * dh;       // the chunk's v
  float* yb = p.y + (bh * p.S + row0 + t0) * dh;
  // chunks after the first read the carry kernel's scratch: wait for that
  // grid (launched before this one, which may start early); chunk 0's
  // blocks wait at their end, so this grid never completes before it
  if (c > 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const bool carry = c > 0 || p.C0 != nullptr;  // else C = 0, n = 0
  const float* Cin = c > 0 ? p.Cs + (bh * (nc - 1) + c - 1) * dh * dh
                           : (p.C0 ? p.C0 + bh * dh * dh : nullptr);
  const float* nin = c > 0 ? p.ns + (bh * (nc - 1) + c - 1) * dh
                           : (p.n0 ? p.n0 + bh * dh : nullptr);
  const float m_prev = c > 0 ? p.ms[bh * (nc - 1) + c - 1]
                             : (p.m0 ? p.m0[bh] : -INFINITY);
  const int nd = (dh + kPiece - 1) / kPiece;

  // 1. scores S = Q·Kᵀ over the whole dh, once: Q [64 x dh] and the keys
  //    s < nkp [nkp x dh], both K-major; q·n beside them on the CUDA cores
  auto issue_s = [&](int d, int buf) {
    float* qs = st + buf * sf;
    const int d0 = d * kPiece;
    stage<kPiece>(qs, kLdK, qb + d0, dh, kRows, tq, dh - d0);
    stage<kPiece>(qs + kRows * kLdK, kLdK, kb + d0, dh, nkp, nkeys, dh - d0);
    cp_async_commit();
  };
  issue_s(0, 0);
  gate_scan(tid < L ? p.ig[bh * p.S + row0 + tid] : 0.f,
            tid < L ? p.fl[bh * p.S + row0 + tid] : 0.f, L, gs, as, cs, red);
  if (tid < kRows) {
    const float M = tid < tq ? fmaxf(m_prev, cs[t0 + tid]) : 0.f;
    Ms[tid] = M;
    inter[tid] = carry && tid < tq ? expf(m_prev - M) : 0.f;
  }
  float sc[2][4][4] = {};
  float qnp = 0.f;  // row tid / 4 of q · n over the quarter tid % 4 of a piece
  const bool qn_thread = carry && tid < 4 * kRows;
  for (int d = 0; d < nd; ++d) {
    if (d + 1 < nd) {
      issue_s(d + 1, (d + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = st + (d & 1) * sf;
    warp_mma<2, 4, true, true, false>(sc, qs, kLdK, 32 * wm,
                                      qs + kRows * kLdK, kLdK,
                                      wn * 8 * ntw, ntk, nullptr);
    if (qn_thread) {
      const int r = tid >> 2, part = (tid & 3) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int dd = d * kPiece + part + e;
        if (dd < dh) qnp = fmaf(qs[r * kLdK + part + e], nin[dd], qnp);
      }
    }
    __syncthreads();
  }

  // 2. P = S ⊙ e^{a_s - M_t} on s <= t, 0 elsewhere, into shared memory,
  //    and its row sums: the quad's lanes, then the 8 column warps in order
  float part[2][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ntk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * wm + 16 * i + g + 8 * (e >> 1);
          const int s = wn * 8 * ntw + 8 * j + 2 * t + (e & 1);
          float pv = 0.f;
          if (r < tq && s <= t0 + r) pv = sc[i][j][e] * expf(as[s] - Ms[r]);
          ps[r * ldp + s] = pv;
          part[i][e >> 1] += pv;
        }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = part[i][h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0) rsum[(32 * wm + 16 * i + g + 8 * h) * 8 + wn] = x;
    }
  if (tid < 4 * kRows) {  // whole warps
    qnp += __shfl_xor_sync(0xffffffffu, qnp, 1);
    qnp += __shfl_xor_sync(0xffffffffu, qnp, 2);
    if ((tid & 3) == 0) qn[tid >> 2] = qnp;
  }
  __syncthreads();
  if (tid < kRows) {
    const float* rs = rsum + tid * 8;
    float d = 0.f;
    for (int w = 0; w < 8; ++w) d += rs[w];
    den[tid] = fmaxf(fabsf(d + inter[tid] * qn[tid]), 1.f);
    if (p.d != nullptr && tid < tq)
      p.d[bh * p.S + row0 + t0 + tid] = d + inter[tid] * qn[tid];
  }
  // den is read after the barriers of the loops below

  // 3. per 384-wide v tile (one at xlstm-125m's dh): e^{m - M_t} q·Cᵀ (Q
  //    and C rows K-major), then + P·V (P K-major, V MN-major), divided by
  //    den; warp wn takes columns [48 wn, 48 wn + 48) of the tile, ntv of
  //    its n8 tiles inside dh
  for (int v0 = 0; v0 < dh; v0 += kVT) {
    const int ntv = max(0, min(6, (dh - v0 - 48 * wn + 7) / 8));
    float acc[2][6][4] = {};
    if (carry) {
      auto issue_c = [&](int d, int buf) {
        float* qs = st + buf * sf;
        const int d0 = d * kPiece;
        stage<kPiece>(qs, kLdK, qb + d0, dh, kRows, tq, dh - d0);
        stage<kPiece>(qs + kRows * kLdK, kLdK, Cin + (int64_t)v0 * dh + d0,
                      dh, kVT, dh - v0, dh - d0);
        cp_async_commit();
      };
      issue_c(0, 0);
      for (int d = 0; d < nd; ++d) {
        if (d + 1 < nd) {
          issue_c(d + 1, (d + 1) & 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* qs = st + (d & 1) * sf;
        warp_mma<2, 6, true, true, false>(acc, qs, kLdK, 32 * wm,
                                          qs + kRows * kLdK, kLdK, 48 * wn,
                                          ntv, nullptr);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = inter[32 * wm + 16 * i + g + 8 * (e >> 1)];
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[i][j][e] *= w;
        }
    }
    auto issue_v = [&](int pc, int buf) {
      const int s0 = pc * kPiece;
      stage<kVT>(st + buf * sf, kLdVT, vb + (int64_t)s0 * dh + v0, dh,
                 kPiece, nkeys - s0, dh - v0);
      cp_async_commit();
    };
    const int npv = nkp / kPiece;
    issue_v(0, 0);
    for (int pc = 0; pc < npv; ++pc) {
      if (pc + 1 < npv) {
        issue_v(pc + 1, (pc + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      warp_mma<2, 6, true, false, false>(acc, ps + pc * kPiece, ldp, 32 * wm,
                                         st + (pc & 1) * sf, kLdVT, 48 * wn,
                                         ntv, nullptr);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * i + g + 8 * h;
        if (r >= tq) continue;
        const float dr = den[r];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int col = v0 + 48 * wn + 8 * j + 2 * t;
          if (col < dh)
            *reinterpret_cast<float2*>(yb + (int64_t)r * dh + col) =
                make_float2(acc[i][j][2 * h] / dr, acc[i][j][2 * h + 1] / dr);
        }
      }
  }
  if (c == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace

// q/k/v/y [B,H,S,dh] f32 (k pre-scaled by dh^-0.5); ig/fl [B,H,S] f32
// (f_log already log-sigmoid); 0 < L <= 256, S % L == 0, dh % 4 == 0.
// C [B,H,dh,dh], n [B,H,dh], m [B,H] receive the final carry; d [B,H,S],
// where non-null, the denominators before the clamp (what the backward
// reads beside the carries in Cs, ns, ms).  With C0,
// n0, m0 non-null the carry starts from them; with all three null it
// starts at zero.  Cs [B,H,nc-1,dh,dh], ns [B,H,nc-1,dh], ms [B,H,nc-1]
// (nc = S / L; null when nc == 1) are scratch for the carries between
// chunks.  All contiguous; q, k, v, C0 and Cs 16-byte aligned.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* ig, const void* fl,
                                const void* C0, const void* n0,
                                const void* m0, void* y, void* C, void* n,
                                void* m, void* Cs, void* ns, void* ms,
                                void* d, int B,
                                int H, int S, int dh, int L, void* stream) {
  const bool init = C0 != nullptr;
  if ((n0 != nullptr) != init || (m0 != nullptr) != init || L <= 0 ||
      L > kMaxL || S % L != 0 || dh <= 0 || dh % 4 != 0 ||
      (S / L > 1 && (Cs == nullptr || ns == nullptr || ms == nullptr)))
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q),  static_cast<const float*>(k),
         static_cast<const float*>(v),  static_cast<const float*>(ig),
         static_cast<const float*>(fl), static_cast<const float*>(C0),
         static_cast<const float*>(n0), static_cast<const float*>(m0),
         static_cast<float*>(Cs),       static_cast<float*>(ns),
         static_cast<float*>(ms),       static_cast<float*>(y),
         static_cast<float*>(C),        static_cast<float*>(n),
         static_cast<float*>(m),        static_cast<float*>(d),
         H,
         S,                             dh,
         L,                             S / L};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int carry_smem = kCarrySmem * (int)sizeof(float);
  const int Lp = (L + kPiece - 1) / kPiece * kPiece;
  const int out_smem = out_smem_floats(Lp) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_carry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      carry_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem);
  if (err != cudaSuccess) return err;
  const dim3 carry_grid((dh + kRows - 1) / kRows, (dh + kCols - 1) / kCols,
                        B * H);
  mlstm_carry_kernel<<<carry_grid, kThreads, carry_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // launched as the carry kernel's programmatic dependent (see the kernels)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((L + kRows - 1) / kRows, B * H, S / L);
  cfg.blockDim = dim3(kOutThreads);
  cfg.dynamicSmemBytes = out_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlstm_out_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
