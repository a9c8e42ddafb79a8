// Flash attention backward (training) for Hopper, sm_90a: two kernels.
//
// Replaces: src/repro/kernels/flash_attention.py:145 _bwd_dq_kernel and
// :180 _bwd_dkv_kernel (both reached through _backward:224, pallas_calls at
// :237 and :257; wired by the custom_vjp _flash_bwd:293).
//
// The flash-attention-2 backward: the softmax p is recomputed tile by tile
// as exp(s - lse) from the forward's f32 lse residual, with masked entries
// (past the causal diagonal, before the sliding window, keys past T, rows
// past S) given p = 0, and
//   dP = dO·Vᵀ,  dS = p ⊙ (dP − δ),  δ = rowsum(dO ⊙ O),
//   dQ = dS·K·scale,  dK = dSᵀ·(Q·scale),  dV = pᵀ·dO.
// Neither kernel materializes the [S,T] matrix.
//
// What bounds it on this card: at training lengths the five [S,T]x[T,D]-
// sized products are O(S*T*D) operations against O((S+T)*D) bytes, so it
// is bound by operations, which only the tensor cores (wgmma, 989 TFLOP/s
// in bf16 against 67 TFLOP/s of f32 FMAs) come near.
//
// What the design does about it.  Both routes keep two kernels: dq runs
// first and writes δ (the TPU code computed δ in jnp outside its kernels),
// dkv runs second and reads it.  The dkv block loops over the G = H/Hkv q
// heads of its kv head (the TPU reference repeats K/V to H heads and lets
// autodiff of the repeat sum the per-head dK/dV in the working dtype) and
// sums dK/dV in f32 registers, writing them once: deterministic, no
// atomics, no [B,H,T,D] buffer.  The sum over the group is in f32 where
// the reference's is in the working dtype; the two differ only below f32.
// Both kernels walk only the tiles the forward visited (the causal
// diagonal and the window bound the loops).  The TPU grid ran the inner
// tiles in order with VMEM accumulators; here the inner walk is a loop
// inside the block.
//
// * bf16 at head dims 64 and 128 (every model path on the card) runs on
//   the tensor cores, over the forward's pieces (flash_tc.cuh: 4-D TMA
//   maps over the strided views, 128-byte swizzle, an mbarrier ring, one
//   producer warp and one consumer warpgroup a block).
//   flash_bwd_dq_tc_kernel: one block per (64-row q tile, head, batch),
//   the heaviest causal tiles first.  Q and dO are loaded once; K/V tiles
//   of 64 keys stream through up to four stages.  δ comes from 16-byte
//   loads of O and dO rows before the first product.  Per tile, S = Q·Kᵀ
//   and dP = dO·Vᵀ (all operands K-major), p = exp2(s·scale·log2e −
//   lse·log2e) masked, dS = p ⊙ (dP − δ) in f32, packed to bf16 in place
//   as register A, and dQ += dS·K with K read MN-major from the same
//   tile.  flash_bwd_dkv_tc_kernel: one block per (64-key tile, kv head,
//   batch), the first (heaviest causal) key tiles first; K/V loaded once,
//   (Q, dO) tile pairs streamed in (q head, q tile) order with their 64
//   lse and δ values (plain loads by the producer warp: a [B,H,S] row is
//   only 4-byte aligned).  Per tile, with M = keys, Sᵀ = K·Qᵀ, dPᵀ =
//   V·dOᵀ, Pᵀ and dSᵀ as above, and dV += Pᵀ·dO, dK += dSᵀ·Q on register
//   A with dO and Q MN-major.  Rows past S and keys past T (zero-filled by
//   TMA) are masked explicitly.  At head dim 128 dkv runs one block an SM
//   (dK and dV take 128 registers a thread).  The numerics are the
//   standard Hopper backward's: P and dS rounded to bf16 for their
//   products, dQ and dK scaled in f32 at the end.
// * f32 (the parity checks) and bf16 at head dims 16, 32 and 256 run the
//   first SIMT version: the same walks on the CUDA cores, f32 tiles in
//   padded shared memory, one block per (batch, q head, q tile) or
//   (batch, kv head, key tile) of 256 threads.  A tile is 64 rows / keys,
//   and 32 at head dim 256 (gemma-2b): there four f32 [64][257] tiles
//   would need 263 KB of shared memory, past the 227 KB a block may use;
//   at 32 they take 132 KB (dq) and 140 KB (dkv, with P, dS and the row
//   statistics), and dK / dV are 32 f32 registers a thread each.  One
//   block an SM at D 256.  What bounds it there is the CUDA cores' f32
//   rate (67 TFLOP/s against the tensor cores' 989 in bf16): a
//   tensor-core D 256 backward, two consumer warpgroups splitting D, is
//   later work.

#include "common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads

// q rows / keys a tile: 64, and 32 at head dim 256, where four f32
// [64][257] tiles would take 263 KB of shared memory, past the 227 KB a
// block may use (at 32 they take 132-140 KB).
template <int D>
constexpr int kSimtTile = D > 128 ? 32 : 64;

// Six tensors' (batch, head, row) strides in elements, passed by value.
struct Strides {
  int64_t v[18];
};

template <int BT, int D>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V [BT][D+1], dS [BT][BT+1]
  return 4 * BT * (D + 1) + BT * (BT + 1);
}

template <int BT, int D>
constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO [BT][D+1], P and dS [BT keys][BT+1 q], lse and delta [BT]
  return 4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT;
}

__device__ __forceinline__ bool attended(int qp, int kp, int S, int Tk,
                                         int causal, int window) {
  if (qp >= S || kp >= Tk) return false;
  if (!causal) return true;
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// Loads a [BT][D] tile of rows r0.. from base (row stride rs) into smem
// (row stride D+1) as f32, times mul; rows at or past n are zero.
template <typename T, int BT, int D>
__device__ __forceinline__ void stage(float* dst, const T* base, int64_t rs,
                                      int r0, int n, float mul) {
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n) x = to_f32(base[(int64_t)(r0 + r) * rs + d]) * mul;
    dst[r * (D + 1) + d] = x;
  }
}

// Thread (ty, tx) of the 16 x 16 owns rows ty*R .. ty*R+R-1 of a tile and
// columns tx + 16j (R = BT / 16 of each).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int H,
                    int group, int S, int Tk, const Strides sv,
                    int causal, int window, float scale) {
  constexpr int BT = kSimtTile<D>;
  constexpr int R = BT / 16;
  constexpr int DP = D + 1;
  constexpr int PS = BT + 1;
  constexpr int DC = D / 16;
  const int64_t* st = sv.v;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * DP;
  float* Ks = dOs + BT * DP;
  float* Vs = Ks + BT * DP;
  float* dSs = Vs + BT * DP;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int hk = h / group;
  // strides (elements): q, k, v, o, dO, dQ, each (b, h, row)
  const T* qb = q + b * st[0] + h * st[1];
  const T* kb = k + b * st[3] + hk * st[4];
  const T* vb = v + b * st[6] + hk * st[7];
  const T* ob = o + b * st[9] + h * st[10];
  const T* db = dout + b * st[12] + h * st[13];

  stage<T, BT, D>(Qs, qb, st[2], q0, S, scale);
  stage<T, BT, D>(dOs, db, st[14], q0, S, 1.f);
  stage<T, BT, D>(Ks, ob, st[11], q0, S, 1.f);  // O, for delta only
  __syncthreads();

  // delta = rowsum(dO ⊙ O) for this thread's R rows (16 lanes per row)
  const int64_t row_base = ((int64_t)b * H + h) * S;
  float lse_r[R], delta_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      acc = fmaf(dOs[r * DP + tx + 16 * j], Ks[r * DP + tx + 16 * j], acc);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off, 16);
    const bool in = q0 + r < S;
    delta_r[i] = in ? acc : 0.f;
    lse_r[i] = in ? lse[row_base + q0 + r] : 0.f;
    if (in && tx == 0) delta[row_base + q0 + r] = acc;
  }

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int n_tiles = (Tk + BT - 1) / BT;
  int t_begin = 0, t_end = n_tiles;
  if (causal) {
    const int last_q = min(q0 + BT - 1, S - 1);
    t_end = min(n_tiles, last_q / BT + 1);
    if (window > 0) t_begin = max(0, q0 - window + 1) / BT;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // previous tile's K/V/dS (and O) fully consumed
    stage<T, BT, D>(Ks, kb, st[5], k0, Tk, 1.f);
    stage<T, BT, D>(Vs, vb, st[8], k0, Tk, 1.f);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty * R + i) * DP + d];
        dov[i] = dOs[(ty * R + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = attended(qp, kp, S, Tk, causal, window)
                            ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * R + i) * PS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float kk[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kk[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ds = dSs[(ty * R + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty * R + i;
    if (r >= S) continue;
    T* row = dq + b * st[15] + h * st[16] + (int64_t)r * st[17];
#pragma unroll
    for (int j = 0; j < DC; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int group, int S, int Tk,
                     const Strides sv, int causal, int window,
                     float scale) {
  constexpr int BT = kSimtTile<D>;
  constexpr int R = BT / 16;
  constexpr int DP = D + 1;
  constexpr int PS = BT + 1;
  constexpr int DC = D / 16;
  const int64_t* st = sv.v;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * DP;
  float* Qs = Vs + BT * DP;
  float* dOs = Qs + BT * DP;
  float* Ps = dOs + BT * DP;   // [key][q]
  float* dSs = Ps + BT * PS;   // [key][q]
  float* lse_s = dSs + BT * PS;
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  // strides (elements): q, k, v, dO, dK, dV, each (b, h, row)
  stage<T, BT, D>(Ks, k + b * st[3] + hk * st[4], st[5], k0, Tk, 1.f);
  stage<T, BT, D>(Vs, v + b * st[6] + hk * st[7], st[8], k0, Tk, 1.f);

  float dka[R][DC], dva[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  // q tiles that can see a key of this tile: from the causal diagonal to
  // the window's last row (all of S without a causal mask).
  const int n_qt = (S + BT - 1) / BT;
  int i_begin = 0, i_end = n_qt;
  if (causal) {
    i_begin = min(n_qt, k0 / BT);
    if (window > 0) {
      const int last_k = min(k0 + BT - 1, Tk - 1);
      i_end = min(n_qt, (last_k + window - 1) / BT + 1);
    }
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * st[0] + h * st[1];
    const T* db = dout + b * st[9] + h * st[10];
    const int64_t row_base = ((int64_t)b * H + h) * S;
    for (int it = i_begin; it < i_end; ++it) {
      const int q0 = it * BT;
      __syncthreads();  // previous tile's Q/dO/P/dS fully consumed
      stage<T, BT, D>(Qs, qb, st[2], q0, S, scale);
      stage<T, BT, D>(dOs, db, st[11], q0, S, 1.f);
      if (tid < BT) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s[i][j]: key ty*R+i against q row tx+16j
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], qv[R], dov[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(ty * R + i) * DP + d];
          vv[i] = Vs[(ty * R + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          dov[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qr = tx + 16 * j;
          const float p = attended(q0 + qr, kp, S, Tk, causal, window)
                              ? expf(s[i][j] - lse_s[qr]) : 0.f;
          Ps[(ty * R + i) * PS + qr] = p;
          dSs[(ty * R + i) * PS + qr] = p * (dp[i][j] - delta_s[qr]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        float dov[DC], qv[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dov[j] = dOs[c * DP + tx + 16 * j];
          qv[j] = Qs[c * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = Ps[(ty * R + i) * PS + c];
          const float ds = dSs[(ty * R + i) * PS + c];
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dva[i][j] = fmaf(p, dov[j], dva[i][j]);
            dka[i][j] = fmaf(ds, qv[j], dka[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty * R + i;
    if (r >= Tk) continue;
    T* krow = dk + b * st[12] + hk * st[13] + (int64_t)r * st[14];
    T* vrow = dv + b * st[15] + hk * st[16] + (int64_t)r * st[17];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      krow[tx + 16 * j] = from_f32<T>(dka[i][j]);
      vrow[tx + 16 * j] = from_f32<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int B, int H, int Hkv, int S,
                      int Tk, const int64_t* st, int causal, int window,
                      cudaStream_t stream) {
  constexpr int BT = kSimtTile<D>;
  auto kern = flash_bwd_dq_kernel<T, D>;
  Strides sv;
  for (int i = 0; i < 18; ++i) sv.v[i] = st[i];
  const size_t smem = dq_smem_floats<BT, D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H,
      H / Hkv, S, Tk, sv, causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int S, int Tk, const int64_t* st, int causal,
                       int window, cudaStream_t stream) {
  constexpr int BT = kSimtTile<D>;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  Strides sv;
  for (int i = 0; i < 18; ++i) sv.v[i] = st[i];
  const size_t smem = dkv_smem_floats<BT, D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + BT - 1) / BT, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, S, Tk, sv,
      causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

// -- bf16 on the tensor cores -------------------------------------------------

namespace bwd_tc {

using flash_tc::exp2_approx;
using flash_tc::kChunk;
using flash_tc::kLog2e;

constexpr int kB = 64;         // q rows / keys of a block, and of a stage
constexpr int kThreads = 160;  // one consumer warpgroup, one producer warp

// A kernel keeps two [64][D] tiles for its whole walk (dq: Q and dO; dkv:
// K and V) and streams two a stage (dq: K and V; dkv: Q and dO, with the
// stage's 64 lse and δ values, whose room dq leaves unused), as many
// stages (up to 4) as kBlocksPerSM blocks an SM leave room for.
template <int D, int kBlocksPerSM>
struct Tiles {
  static constexpr int kTile = kB * D * 2;
  static constexpr int kStageBytes = 2 * kTile;
  static constexpr int kStat = 2 * kB * 4;
  static constexpr int kBudget =
      (kBlocksPerSM == 1 ? tc::kSmemBlock
                         : tc::kSmemSM / kBlocksPerSM - 1024) -
      tc::kSmemSlack - 2 * kTile;
  static constexpr int kFit = kBudget / (kStageBytes + kStat);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 2 * kTile + kStages * (kStageBytes + kStat) +
                               1024;
  static_assert(kStages >= 2, "two stages do not fit");
};

// dkv at head dim 128 holds dK and dV (128 f32 registers a thread) beside
// Sᵀ and dPᵀ (64): one block an SM leaves it 255 registers.
template <int D>
constexpr int kDkvBlocks = D == 64 ? 2 : 1;

struct Params {
  CUtensorMap q, k, v, dout;  // (D, rows, heads, batch), boxes (64, 64, 1, 1)
  const __nv_bfloat16* o;     // dq: the rows of O and dO that δ reads
  const __nv_bfloat16* dob;
  const float* lse;           // [B, H, S]
  float* delta;               // [B, H, S]: the dq kernel writes it
  __nv_bfloat16* out0;        // dQ (dq) or dK (dkv)
  __nv_bfloat16* out1;        // dV (dkv)
  int64_t st[12];             // (b, h, row) element strides: O, dO, out0, out1
  int B, H, group, S, T, causal, window;
  float scale;                // D^-0.5
};

// The m64 accumulator rows of consumer thread l: r and r + 8 (see
// tc::for_each_pair), from the block's first row row0.
__device__ __forceinline__ int acc_row(int row0, int l) {
  return row0 + 16 * (l / 32) + (l % 32) / 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tc_kernel(const __grid_constant__ Params p) {
  using Tl = Tiles<D, 2>;
  constexpr int DC = D / 64, kStages = Tl::kStages;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qfull;
  const uint32_t qs = tc::smem_u32(tc::stage_memory());
  const uint32_t dos = qs + Tl::kTile, ks = dos + Tl::kTile;
  const uint32_t full0 = tc::smem_u32(full), empty0 = tc::smem_u32(empty);
  const uint32_t qbar = tc::smem_u32(&qfull);

  const int tid = threadIdx.x, warp = tid / 32;
  const int n_qt = (p.S + kB - 1) / kB;
  const int bh = blockIdx.x % (p.B * p.H);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (p.B * p.H)) *
                 kB;  // the last (heaviest causal) q tiles first
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;

  // the K/V tiles the forward visited: from the window's first tile to
  // the diagonal's last (all of T without a causal mask)
  const int n_kt = (p.T + kB - 1) / kB;
  int t_begin = 0, t_end = n_kt;
  if (p.causal) {
    t_end = min(n_kt, min(q0 + kB - 1, p.S - 1) / kB + 1);
    if (p.window > 0) t_begin = max(0, q0 - p.window + 1) / kB;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full0 + 8 * s, 1);
      tc::mbar_init(empty0 + 8 * s, 128);
    }
    tc::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer: one thread issues every load
    if (tid % 32 == 0) {
      tc::mbar_expect_tx(qbar, 2 * Tl::kTile);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tc::tma_load_4d(qs + c * kChunk, &p.q, qbar, 64 * c, q0, h, b);
        tc::tma_load_4d(dos + c * kChunk, &p.dout, qbar, 64 * c, q0, h, b);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int t = t_begin; t < t_end; ++t) {
        tc::mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s;
        tc::mbar_expect_tx(bar, Tl::kStageBytes);
        const uint32_t st = ks + s * Tl::kStageBytes;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tc::tma_load_4d(st + c * kChunk, &p.k, bar, 64 * c, t * kB, hk, b);
          tc::tma_load_4d(st + Tl::kTile + c * kChunk, &p.v, bar, 64 * c,
                          t * kB, hk, b);
        }
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // the consumer warpgroup: q rows r and r + 8 of the tile
  const int l = tid, r = acc_row(q0, l), c0 = 2 * (l % 4);
  const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.S;

  // δ = rowsum(dO ⊙ O) of rows r and r + 8, written for the dkv kernel:
  // the four threads of a row each sum a quarter of it (16-byte loads;
  // the bf16 products summed in f32, as the plain version does), while
  // the producer's first loads land
  float dl[2], l2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = r + 8 * hh;
    float acc = 0.f;
    if (qp < p.S) {
      const int d0 = (l % 4) * (D / 4);
      const uint4* orow = reinterpret_cast<const uint4*>(
          p.o + b * p.st[0] + h * p.st[1] + qp * p.st[2] + d0);
      const uint4* drow = reinterpret_cast<const uint4*>(
          p.dob + b * p.st[3] + h * p.st[4] + qp * p.st[5] + d0);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 ov = orow[i], dv = drow[i];
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]);
          const float2 g = __bfloat1622float2(d2[e]);
          acc = fmaf(a.x, g.x, acc);
          acc = fmaf(a.y, g.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[hh] = acc;
    l2[hh] = qp < p.S ? p.lse[row0 + qp] * kLog2e : 0.f;
    if (l % 4 == 0 && qp < p.S) p.delta[row0 + qp] = acc;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float c = p.scale * kLog2e;

  tc::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int t = t_begin; t < t_end; ++t) {
    tc::mbar_wait(full0 + 8 * s, ph);
    const uint32_t st = ks + s * Tl::kStageBytes;
    // S = Q·Kᵀ and dP = dO·Vᵀ, every operand K-major
    float sc[kB / 2], dp[kB / 2];
#pragma unroll
    for (int i = 0; i < kB / 2; ++i) sc[i] = dp[i] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cc = kk / 4, off = (kk % 4) * 32;
      flash_tc::mma_kk<kB>(sc, tc::desc(qs + cc * kChunk + off, 16, 1024),
                           tc::desc(st + cc * kChunk + off, 16, 1024));
      flash_tc::mma_kk<kB>(
          dp, tc::desc(dos + cc * kChunk + off, 16, 1024),
          tc::desc(st + Tl::kTile + cc * kChunk + off, 16, 1024));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();

    // p = exp(s·scale − lse), 0 where the forward masked (rows past S,
    // which TMA zero-filled, included); dS = p ⊙ (dP − δ) in f32
    const int k0 = t * kB;
    const bool masked =
        q0 + kB > p.S || k0 + kB > p.T ||
        (p.causal && (k0 + kB - 1 > q0 ||
                      (p.window > 0 && k0 <= q0 + kB - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          float pv = exp2_approx(fmaf(sc[i], c, -l2[hh]));
          if (masked && !attended(r + 8 * hh, k0 + 8 * j + c0 + e, p.S,
                                  p.T, p.causal, p.window))
            pv = 0.f;
          dp[i] = pv * (dp[i] - dl[hh]);
        }

    // dQ += dS·K: dS in bf16 as register A, K an MN-major B (64-wide D
    // chunks 8 KB apart, 8-key groups 1 KB apart, k16 steps 2 KB)
    uint32_t da[kB / 16][4];
    flash_tc::to_a<kB>(da, dp);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk)
      flash_tc::mma_rs<D>(dq, da[kk],
                          tc::desc(st + kk * 2048, kB * 128, 1024));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::mbar_arrive(empty0 + 8 * s);
    if (++s == kStages) { s = 0; ph ^= 1; }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = r + 8 * hh;
    if (qp >= p.S) continue;
    __nv_bfloat16* row = p.out0 + b * p.st[6] + h * p.st[7] + qp * p.st[8];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      tc::store_bf16x2(row, 8 * j + c0, dq[4 * j + 2 * hh] * p.scale,
                       dq[4 * j + 2 * hh + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kDkvBlocks<D>)
flash_bwd_dkv_tc_kernel(const __grid_constant__ Params p) {
  using Tl = Tiles<D, kDkvBlocks<D>>;
  constexpr int DC = D / 64, kStages = Tl::kStages;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kvfull;
  uint8_t* const smem = tc::stage_memory();
  const uint32_t ks = tc::smem_u32(smem), vs = ks + Tl::kTile;
  const uint32_t qs0 = vs + Tl::kTile;  // stage s: Q, then dO
  // stage s's lse·log2(e) and δ rows: stat[s][0][64], stat[s][1][64]
  float* const stat = reinterpret_cast<float*>(
      smem + 2 * Tl::kTile + kStages * Tl::kStageBytes);
  const uint32_t full0 = tc::smem_u32(full), empty0 = tc::smem_u32(empty);
  const uint32_t kvbar = tc::smem_u32(&kvfull);

  const int tid = threadIdx.x, warp = tid / 32;
  const int Hkv = p.H / p.group;
  const int bh = blockIdx.x % (p.B * Hkv);
  const int k0 = static_cast<int>(blockIdx.x) / (p.B * Hkv) *
                 kB;  // the first (heaviest causal) key tiles first
  const int b = bh / Hkv, hk = bh % Hkv;

  // q tiles that can see a key of this tile: from the causal diagonal to
  // the window's last row (all of S without a causal mask)
  const int n_qt = (p.S + kB - 1) / kB;
  int i_begin = 0, i_end = n_qt;
  if (p.causal) {
    i_begin = min(n_qt, k0 / kB);
    if (p.window > 0)
      i_end = min(n_qt, (min(k0 + kB - 1, p.T - 1) + p.window - 1) / kB + 1);
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival with its bytes, then the producer warp's
      // 32 lanes' once their lse and δ stores are done
      tc::mbar_init(full0 + 8 * s, 33);
      tc::mbar_init(empty0 + 8 * s, 128);
    }
    tc::mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    const int lane = tid % 32;
    if (lane == 0) {
      tc::mbar_expect_tx(kvbar, 2 * Tl::kTile);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tc::tma_load_4d(ks + c * kChunk, &p.k, kvbar, 64 * c, k0, hk, b);
        tc::tma_load_4d(vs + c * kChunk, &p.v, kvbar, 64 * c, k0, hk, b);
      }
    }
    int s = 0;
    uint32_t ph = 0;
    for (int g = 0; g < p.group; ++g) {
      const int h = hk * p.group + g;
      const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.S;
      for (int it = i_begin; it < i_end; ++it) {
        const int q0 = it * kB;
        tc::mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s;
        if (lane == 0) {
          tc::mbar_expect_tx(bar, Tl::kStageBytes);
          const uint32_t st = qs0 + s * Tl::kStageBytes;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            tc::tma_load_4d(st + c * kChunk, &p.q, bar, 64 * c, q0, h, b);
            tc::tma_load_4d(st + Tl::kTile + c * kChunk, &p.dout, bar,
                            64 * c, q0, h, b);
          }
        }
        // lse and δ rows start wherever S puts them (4-byte aligned
        // only): plain loads, 0 past S
        float* sst = stat + s * 2 * kB;
#pragma unroll
        for (int i = lane; i < kB; i += 32) {
          const int qp = q0 + i;
          sst[i] = qp < p.S ? p.lse[row0 + qp] * kLog2e : 0.f;
          sst[kB + i] = qp < p.S ? p.delta[row0 + qp] : 0.f;
        }
        tc::mbar_arrive(bar);
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // the consumer warpgroup: keys kr and kr + 8 of the tile (M = keys)
  const int l = tid, kr = acc_row(k0, l), c0 = 2 * (l % 4);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float c = p.scale * kLog2e;

  tc::mbar_wait(kvbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int g = 0; g < p.group; ++g) {
    for (int it = i_begin; it < i_end; ++it) {
      const int q0 = it * kB;
      tc::mbar_wait(full0 + 8 * s, ph);
      const uint32_t st = qs0 + s * Tl::kStageBytes;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, every operand K-major
      float sc[kB / 2], dp[kB / 2];
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) sc[i] = dp[i] = 0.f;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cc = kk / 4, off = (kk % 4) * 32;
        flash_tc::mma_kk<kB>(sc, tc::desc(ks + cc * kChunk + off, 16, 1024),
                             tc::desc(st + cc * kChunk + off, 16, 1024));
        flash_tc::mma_kk<kB>(
            dp, tc::desc(vs + cc * kChunk + off, 16, 1024),
            tc::desc(st + Tl::kTile + cc * kChunk + off, 16, 1024));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();

      // Pᵀ = exp(Sᵀ·scale − lse[col]), 0 where the forward masked (q rows
      // past S, zero-filled by TMA and read with lse 0, included);
      // dSᵀ = Pᵀ ⊙ (dPᵀ − δ[col]) in f32
      const float* sst = stat + s * 2 * kB;
      const bool masked =
          q0 + kB > p.S || k0 + kB > p.T ||
          (p.causal && (k0 + kB - 1 > q0 ||
                        (p.window > 0 && k0 <= q0 + kB - 1 - p.window)));
#pragma unroll
      for (int j = 0; j < kB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + c0 + e;
          const float lq = sst[col], dl = sst[kB + col];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * j + 2 * hh + e;
            float pv = exp2_approx(fmaf(sc[i], c, -lq));
            if (masked && !attended(q0 + col, kr + 8 * hh, p.S, p.T,
                                    p.causal, p.window))
              pv = 0.f;
            sc[i] = pv;
            dp[i] = pv * (dp[i] - dl);
          }
        }

      // dV += Pᵀ·dO and dK += dSᵀ·Q: Pᵀ and dSᵀ in bf16 as register A,
      // dO and Q MN-major B over the tiles the first products read K-major
      uint32_t pa[kB / 16][4], da[kB / 16][4];
      flash_tc::to_a<kB>(pa, sc);
      flash_tc::to_a<kB>(da, dp);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) {
        flash_tc::mma_rs<D>(
            dv, pa[kk], tc::desc(st + Tl::kTile + kk * 2048, kB * 128, 1024));
        flash_tc::mma_rs<D>(dk, da[kk],
                            tc::desc(st + kk * 2048, kB * 128, 1024));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::mbar_arrive(empty0 + 8 * s);
      if (++s == kStages) { s = 0; ph ^= 1; }
    }
  }

  // dK·scale and dV, summed over the group in f32, rounded to bf16 once
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kp = kr + 8 * hh;
    if (kp >= p.T) continue;
    __nv_bfloat16* krow =
        p.out0 + b * p.st[6] + hk * p.st[7] + kp * p.st[8];
    __nv_bfloat16* vrow =
        p.out1 + b * p.st[9] + hk * p.st[10] + kp * p.st[11];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      tc::store_bf16x2(krow, 8 * j + c0, dk[4 * j + 2 * hh] * p.scale,
                       dk[4 * j + 2 * hh + 1] * p.scale);
      tc::store_bf16x2(vrow, 8 * j + c0, dv[4 * j + 2 * hh],
                       dv[4 * j + 2 * hh + 1]);
    }
  }
}

// 16-byte loads of a bf16 [batch][heads][rows][D] tensor's rows
bool rows_16b(const void* ptr, const int64_t* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

template <class Kern>
cudaError_t start(Kern kern, const Params& p, int smem, int blocks,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params params(int B, int H, int Hkv, int S, int T, int D, int causal,
              int window) {
  Params p{};
  p.B = B;
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.T = T;
  p.causal = causal;
  p.window = window;
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  return p;
}

// st: (b, h, row) of q, k, v, o, dO, dQ
template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int B, int H, int Hkv, int S,
                      int T, const int64_t* st, int causal, int window,
                      cudaStream_t stream) {
  Params p = params(B, H, Hkv, S, T, D, causal, window);
  cudaError_t err;
  if ((err = flash_tc::map_4d(&p.q, q, B, H, S, D, st[0], st[1], st[2],
                              kB)) != cudaSuccess ||
      (err = flash_tc::map_4d(&p.k, k, B, Hkv, T, D, st[3], st[4], st[5],
                              kB)) != cudaSuccess ||
      (err = flash_tc::map_4d(&p.v, v, B, Hkv, T, D, st[6], st[7], st[8],
                              kB)) != cudaSuccess ||
      (err = flash_tc::map_4d(&p.dout, dout, B, H, S, D, st[12], st[13],
                              st[14], kB)) != cudaSuccess)
    return err;
  if (!rows_16b(o, st + 9) || !rows_16b(dout, st + 12))
    return cudaErrorMisalignedAddress;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dob = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  for (int i = 0; i < 9; ++i) p.st[i] = st[9 + i];  // O, dO, dQ
  return start(flash_bwd_dq_tc_kernel<D>, p, Tiles<D, 2>::kSmem,
               (S + kB - 1) / kB * B * H, stream);
}

// st: (b, h, row) of q, k, v, dO, dK, dV
template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int S, int T,
                       const int64_t* st, int causal, int window,
                       cudaStream_t stream) {
  Params p = params(B, H, Hkv, S, T, D, causal, window);
  cudaError_t err;
  if ((err = flash_tc::map_4d(&p.q, q, B, H, S, D, st[0], st[1], st[2],
                              kB)) != cudaSuccess ||
      (err = flash_tc::map_4d(&p.k, k, B, Hkv, T, D, st[3], st[4], st[5],
                              kB)) != cudaSuccess ||
      (err = flash_tc::map_4d(&p.v, v, B, Hkv, T, D, st[6], st[7], st[8],
                              kB)) != cudaSuccess ||
      (err = flash_tc::map_4d(&p.dout, dout, B, H, S, D, st[9], st[10],
                              st[11], kB)) != cudaSuccess)
    return err;
  p.lse = lse;
  p.delta = const_cast<float*>(delta);
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  for (int i = 0; i < 6; ++i) p.st[6 + i] = st[12 + i];  // dK, dV
  return start(flash_bwd_dkv_tc_kernel<D>, p,
               Tiles<D, kDkvBlocks<D>>::kSmem, (T + kB - 1) / kB * B * Hkv,
               stream);
}

}  // namespace bwd_tc

// f32 at head dims 16-256; bf16 at 16, 32 and 256 (at 64 and 128 it
// takes the tensor-core entries below).
#define REPRO_DISPATCH_D(dtype_, D_, F32, BF16) \
  if (dtype_ == kF32) {                         \
    switch (D_) {                               \
      case 16: return F32(16);                  \
      case 32: return F32(32);                  \
      case 64: return F32(64);                  \
      case 128: return F32(128);                \
      case 256: return F32(256);                \
    }                                           \
  } else if (dtype_ == kBF16) {                 \
    switch (D_) {                               \
      case 16: return BF16(16);                 \
      case 32: return BF16(32);                 \
      case 256: return BF16(256);               \
    }                                           \
  }                                             \
  return cudaErrorInvalidValue;

}  // namespace

// strides: 18 int64, (b, h, row) of q, k, v, o, dO, dQ in elements (host
// memory).  delta [B,H,S] f32 is written.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int B, int H,
    int Hkv, int S, int Tk, int D, const int64_t* strides, int causal,
    int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL_F32(Dv) launch_dq<float, Dv>(q, k, v, o, dout, lse, delta, dq, \
    B, H, Hkv, S, Tk, strides, causal, window, s)
#define CALL_BF16(Dv) launch_dq<__nv_bfloat16, Dv>(q, k, v, o, dout, lse, \
    delta, dq, B, H, Hkv, S, Tk, strides, causal, window, s)
  REPRO_DISPATCH_D(dtype, D, CALL_F32, CALL_BF16)
#undef CALL_F32
#undef CALL_BF16
}

// strides: 18 int64, (b, h, row) of q, k, v, dO, dK, dV in elements (host
// memory).  delta is the dq kernel's output.
extern "C" int repro_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int S, int Tk, int D, const int64_t* strides, int causal,
    int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL_F32(Dv) launch_dkv<float, Dv>(q, k, v, dout, lse, delta, dk, \
    dv, B, H, Hkv, S, Tk, strides, causal, window, s)
#define CALL_BF16(Dv) launch_dkv<__nv_bfloat16, Dv>(q, k, v, dout, lse, \
    delta, dk, dv, B, H, Hkv, S, Tk, strides, causal, window, s)
  REPRO_DISPATCH_D(dtype, D, CALL_F32, CALL_BF16)
#undef CALL_F32
#undef CALL_BF16
}

// bf16 on the tensor cores, head dim 64 or 128: as the SIMT entries above,
// without the dtype; q, k, v, o and dO 16-byte aligned with every stride a
// multiple of 8 elements (TMA, and 16-byte loads of O and dO for delta).
extern "C" int repro_flash_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int B, int H,
    int Hkv, int S, int Tk, int D, const int64_t* strides, int causal,
    int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bwd_tc::launch_dq<64>(q, k, v, o, dout, lse, delta, dq, B, H, Hkv,
                                 S, Tk, strides, causal, window, s);
  if (D == 128)
    return bwd_tc::launch_dq<128>(q, k, v, o, dout, lse, delta, dq, B, H,
                                  Hkv, S, Tk, strides, causal, window, s);
  return cudaErrorInvalidValue;
}

extern "C" int repro_flash_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int S, int Tk, int D, const int64_t* strides, int causal,
    int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bwd_tc::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  Hkv, S, Tk, strides, causal, window, s);
  if (D == 128)
    return bwd_tc::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Hkv, S, Tk, strides, causal, window, s);
  return cudaErrorInvalidValue;
}
