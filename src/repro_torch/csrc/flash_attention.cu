// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:67 _attn_kernel (reached
// through _forward:112, pallas_call at :120).
//
// What bounds it on this card: at prefill lengths the work is the two
// [S,T]x[T,D] products, O(S*T*D) operations against O((S+T)*D) bytes, so
// it is bound by operations.  This first version runs them as f32 FMAs on
// the CUDA cores (the tensor cores, wgmma, are for a later version), so
// the f32 SIMT rate is its real ceiling.
//
// What the design does about it: one block per (batch, head, 64-row q
// tile); the [64,T] score matrix never leaves the SM.  K/V stream through
// shared memory in 64-key tiles, every q row of the block reuses each
// staged tile, each thread keeps a 4x4 score tile and a 4x(D/16) output
// tile in registers, and tiles past the causal diagonal or before the
// sliding window are never loaded (the TPU kernel's fori_loop bounds).
// The TPU grid ran the q tiles in order with VMEM scratch; here the tiles
// are independent blocks and the KV walk is a loop inside the block.
//
// Numerics follow the TPU kernel: q is pre-scaled by D^-0.5, masked scores
// are -1e30, l is clamped at 1e-30, lse = m + log(l) and 0 where l == 0.
// Keys past T are excluded outright (p = 0), rows past S are not stored.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // keys per staged tile
constexpr int kThreads = 256; // 16 x 16: ty picks 4 rows, tx 4 keys / D/16 dims

template <int D>
constexpr size_t smem_floats() {
  // Q [BQ][D+1], K [BK][D+1], V [BK][D], P [BQ][BK+1]
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int group, int S, int Tk,
                 int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss,
                 int64_t osb, int64_t osh, int64_t oss,
                 int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int DC = D / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < S) x = to_f32(qb[(int64_t)(q0 + r) * qss + d]) * scale;
    Qs[r * DP + d] = x;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // KV tiles this q tile can see: from the window's first tile to the
  // diagonal's last (all of T without a causal mask).
  const int n_tiles = (Tk + kBK - 1) / kBK;
  int t_begin = 0, t_end = n_tiles;
  if (causal) {
    int last_q = min(q0 + kBQ - 1, S - 1);
    t_end = min(n_tiles, last_q / kBK + 1);
    if (window > 0) t_begin = max(0, q0 - window + 1) / kBK;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's K/V/P fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Tk) {
        kx = to_f32(kb[(int64_t)(k0 + c) * kss + d]);
        vx = to_f32(vb[(int64_t)(k0 + c) * vss + d]);
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Tk) {
          s[i][j] = -INFINITY;
        } else if (causal && (kp > qp || (window > 0 && kp <= qp - window))) {
          s[i][j] = REPRO_NEG_INF;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off, 16);
      m[i] = m_new;
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + b * osb + h * osh + (int64_t)r * oss;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0)
      lse[((int64_t)b * H + h) * S + r] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : 0.f;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int S, int Tk,
                   const int64_t* st, int causal, int window,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, S, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int Hkv, int S,
                       int Tk, const int64_t* st, int causal, int window,
                       cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: q(b,h,s) k(b,h,t) v(b,h,t) o(b,h,s), in elements.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int B, int H, int Hkv, int S, int Tk,
                                         int D, const int64_t* strides,
                                         int causal, int window, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k, v, o, lse, B, H, Hkv, S, Tk, strides,
                             causal, window, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv, S, Tk,
                                     strides, causal, window, s);
  return cudaErrorInvalidValue;
}
