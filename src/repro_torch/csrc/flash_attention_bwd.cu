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
// is bound by operations.  This first version runs them as f32 FMAs on the
// CUDA cores (tensor cores, wgmma, are for a later version).
//
// What the design does about it:
// * dq kernel: one block per (batch, q head, 64-row q tile), as the
//   forward.  It first computes δ for its rows from dO and O (the TPU code
//   computed δ in jnp outside its kernels) and writes it for the dkv
//   kernel, then streams 64-key K/V tiles through shared memory over the
//   tiles the forward visited (the causal diagonal and the window bound
//   the loop), keeping dQ in registers.
// * dkv kernel: one block per (batch, kv head, 64-key tile).  The TPU
//   reference repeats K/V to H heads and lets autodiff of the repeat sum
//   the per-head dK/dV in the working dtype; here the block loops over the
//   G = H/Hkv q heads of its kv head and over the q tiles from the causal
//   diagonal to the window's last row, accumulating dK/dV in f32 registers
//   and writing them once: deterministic, no atomics, no [B,H,T,D] buffer.
//   The sum over the group is in f32 where the reference's is in the
//   working dtype; the two differ only below f32.
// The TPU grid ran the inner tiles in order with VMEM accumulators; here
// the inner walk is a loop inside the block.

#include "common.cuh"

namespace {

constexpr int kB = 64;         // q rows / keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads

// Six tensors' (batch, head, row) strides in elements, passed by value.
struct Strides {
  int64_t v[18];
};

template <int D>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V [64][D+1], dS [64][65]
  return 4 * kB * (D + 1) + kB * (kB + 1);
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO [64][D+1], P and dS [64 keys][65 q], lse and delta [64]
  return 4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

__device__ __forceinline__ bool attended(int qp, int kp, int S, int Tk,
                                         int causal, int window) {
  if (qp >= S || kp >= Tk) return false;
  if (!causal) return true;
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// Loads a [64][D] tile of rows r0.. from base (row stride rs) into smem
// (row stride D+1) as f32, times mul; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* base, int64_t rs,
                                      int r0, int n, float mul) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n) x = to_f32(base[(int64_t)(r0 + r) * rs + d]) * mul;
    dst[r * (D + 1) + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int H,
                    int group, int S, int Tk, const Strides sv,
                    int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PS = kB + 1;
  constexpr int DC = D / 16;
  const int64_t* st = sv.v;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * DP;
  float* Ks = dOs + kB * DP;
  float* Vs = Ks + kB * DP;
  float* dSs = Vs + kB * DP;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int hk = h / group;
  // strides (elements): q, k, v, o, dO, dQ, each (b, h, row)
  const T* qb = q + b * st[0] + h * st[1];
  const T* kb = k + b * st[3] + hk * st[4];
  const T* vb = v + b * st[6] + hk * st[7];
  const T* ob = o + b * st[9] + h * st[10];
  const T* db = dout + b * st[12] + h * st[13];

  stage<T, D>(Qs, qb, st[2], q0, S, scale);
  stage<T, D>(dOs, db, st[14], q0, S, 1.f);
  stage<T, D>(Ks, ob, st[11], q0, S, 1.f);  // O, for delta only
  __syncthreads();

  // delta = rowsum(dO ⊙ O) for this thread's 4 rows (16 lanes per row)
  const int64_t row_base = ((int64_t)b * H + h) * S;
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
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

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int n_tiles = (Tk + kB - 1) / kB;
  int t_begin = 0, t_end = n_tiles;
  if (causal) {
    const int last_q = min(q0 + kB - 1, S - 1);
    t_end = min(n_tiles, last_q / kB + 1);
    if (window > 0) t_begin = max(0, q0 - window + 1) / kB;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // previous tile's K/V/dS (and O) fully consumed
    stage<T, D>(Ks, kb, st[5], k0, Tk, 1.f);
    stage<T, D>(Vs, vb, st[8], k0, Tk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * DP + d];
        dov[i] = dOs[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = attended(qp, kp, S, Tk, causal, window)
                            ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float kk[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kk[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
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
  constexpr int DP = D + 1;
  constexpr int PS = kB + 1;
  constexpr int DC = D / 16;
  const int64_t* st = sv.v;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * DP;
  float* Qs = Vs + kB * DP;
  float* dOs = Qs + kB * DP;
  float* Ps = dOs + kB * DP;   // [key][q]
  float* dSs = Ps + kB * PS;   // [key][q]
  float* lse_s = dSs + kB * PS;
  float* delta_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  // strides (elements): q, k, v, dO, dK, dV, each (b, h, row)
  stage<T, D>(Ks, k + b * st[3] + hk * st[4], st[5], k0, Tk, 1.f);
  stage<T, D>(Vs, v + b * st[6] + hk * st[7], st[8], k0, Tk, 1.f);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  // q tiles that can see a key of this tile: from the causal diagonal to
  // the window's last row (all of S without a causal mask).
  const int n_qt = (S + kB - 1) / kB;
  int i_begin = 0, i_end = n_qt;
  if (causal) {
    i_begin = min(n_qt, k0 / kB);
    if (window > 0) {
      const int last_k = min(k0 + kB - 1, Tk - 1);
      i_end = min(n_qt, (last_k + window - 1) / kB + 1);
    }
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * st[0] + h * st[1];
    const T* db = dout + b * st[9] + h * st[10];
    const int64_t row_base = ((int64_t)b * H + h) * S;
    for (int it = i_begin; it < i_end; ++it) {
      const int q0 = it * kB;
      __syncthreads();  // previous tile's Q/dO/P/dS fully consumed
      stage<T, D>(Qs, qb, st[2], q0, S, scale);
      stage<T, D>(dOs, db, st[11], q0, S, 1.f);
      if (tid < kB) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s[i][j]: key ty*4+i against q row tx+16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * DP + d];
          vv[i] = Vs[(ty * 4 + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          dov[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const float p = attended(q0 + qr, kp, S, Tk, causal, window)
                              ? expf(s[i][j] - lse_s[qr]) : 0.f;
          Ps[(ty * 4 + i) * PS + qr] = p;
          dSs[(ty * 4 + i) * PS + qr] = p * (dp[i][j] - delta_s[qr]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kB; ++c) {
        float dov[DC], qv[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dov[j] = dOs[c * DP + tx + 16 * j];
          qv[j] = Qs[c * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty * 4 + i) * PS + c];
          const float ds = dSs[(ty * 4 + i) * PS + c];
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
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
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
  auto kern = flash_bwd_dq_kernel<T, D>;
  Strides sv;
  for (int i = 0; i < 18; ++i) sv.v[i] = st[i];
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kB - 1) / kB, H, B);
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
  auto kern = flash_bwd_dkv_kernel<T, D>;
  Strides sv;
  for (int i = 0; i < 18; ++i) sv.v[i] = st[i];
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + kB - 1) / kB, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, S, Tk, sv,
      causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

#define REPRO_DISPATCH_D(D_, CALL) \
  switch (D_) {                    \
    case 16: return CALL(16);      \
    case 32: return CALL(32);      \
    case 64: return CALL(64);      \
    case 128: return CALL(128);    \
  }                                \
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
  if (dtype == kF32) { REPRO_DISPATCH_D(D, CALL_F32) }
  if (dtype == kBF16) { REPRO_DISPATCH_D(D, CALL_BF16) }
#undef CALL_F32
#undef CALL_BF16
  return cudaErrorInvalidValue;
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
  if (dtype == kF32) { REPRO_DISPATCH_D(D, CALL_F32) }
  if (dtype == kBF16) { REPRO_DISPATCH_D(D, CALL_BF16) }
#undef CALL_F32
#undef CALL_BF16
  return cudaErrorInvalidValue;
}
