// Single-token GQA flash-decode attention for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py:28 _decode_kernel (reached
// through decode_attention:72, pallas_call at :90).
//
// What bounds it on this card: one query token per head against a [T]
// cache does O(T*D) operations per O(T*D) bytes of K and V, far below the
// card's operations-per-byte balance, so it is bound by the bytes of the
// K/V cache.
//
// What the design does about it: one block per (batch row, kv head) walks
// the cache in 64-entry tiles with an f32 online softmax, so the [T] score
// vector never leaves the SM; each K/V tile is read from device memory once
// and shared by all G = H/KV q heads of the kv head (the TPU kernel's [G,D]
// tile).  The TPU grid ran the T blocks in order with VMEM scratch carrying
// (m, l, acc); here the T walk is a loop inside the block.  B*KV blocks
// under-fill 132 SMs at serving batch sizes: splitting T across blocks with
// a combine pass is the planned next step, not done here.
//
// Numerics follow the TPU kernel: q is pre-scaled by D^-0.5, an entry is
// attended iff kv_pos >= 0 && kv_pos <= pos (&& kv_pos > pos - window), a
// masked score is -1e30 (so a row with nothing valid averages V uniformly,
// as the reference does), and l is clamped at 1e-30.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBT = 64;        // cache entries per tile
constexpr int kMaxOut = 8;     // G*D outputs per thread (G*D <= 1024)

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_pos,
              const int* __restrict__ pos, T* __restrict__ out, int H,
              int KV, int T_len, int D, int window, float scale) {
  const int G = H / KV;
  const int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [G][D]
  float* Ks = Qs + G * D;        // [kBT][D+1]
  float* Vs = Ks + kBT * DP;     // [kBT][D]
  float* Ss = Vs + kBT * D;      // [G][kBT]
  float* Ms = Ss + G * kBT;      // [G] running max
  float* Ls = Ms + G;            // [G] running sum
  float* Cs = Ls + G;            // [G] this tile's correction

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, kvh = blockIdx.x;
  const int p = pos[b];

  const T* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const int64_t row_stride = (int64_t)KV * D;  // between cache entries
  const T* kb = k + (int64_t)b * T_len * row_stride + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * T_len * row_stride + (int64_t)kvh * D;
  const int* pb = kv_pos + (int64_t)b * T_len;

  for (int t0 = 0; t0 < T_len; t0 += kBT) {
    __syncthreads();  // previous tile's K/V/S fully consumed, Qs/Ms ready
    for (int i = tid; i < kBT * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      float kx = 0.f, vx = 0.f;
      if (t0 + c < T_len) {
        kx = to_f32(kb[(t0 + c) * row_stride + d]);
        vx = to_f32(vb[(t0 + c) * row_stride + d]);
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < G * kBT; i += kThreads) {
      const int g = i / kBT, c = i - g * kBT;
      float s;
      if (t0 + c >= T_len) {
        s = -INFINITY;  // past the cache: not an entry at all
      } else {
        const int kp = pb[t0 + c];
        const bool valid = kp >= 0 && kp <= p && (window <= 0 || kp > p - window);
        if (valid) {
          const float* qg = Qs + g * D;
          const float* kc = Ks + c * DP;
          s = 0.f;
          for (int d = 0; d < D; ++d) s = fmaf(qg[d], kc[d], s);
        } else {
          s = REPRO_NEG_INF;
        }
      }
      Ss[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per q head
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < kBT; c += 32) mx = fmaxf(mx, Ss[g * kBT + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.f;
      for (int c = lane; c < kBT; c += 32) {
        const float e = expf(Ss[g * kBT + c] - m_new);
        Ss[g * kBT + c] = e;
        ps += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ms[g] = m_new;
        Ls[g] = Ls[g] * corr + ps;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int i = tid + j * kThreads;
      if (i < G * D) {
        const int g = i / D, d = i - g * D;
        const float* pg = Ss + g * kBT;
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < kBT; ++c) s = fmaf(pg[c], Vs[c * D + d], s);
        acc[j] = acc[j] * Cs[g] + s;
      }
    }
  }

  T* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * D;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * D) ob[i] = from_f32<T>(acc[j] / fmaxf(Ls[i / D], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_pos, const int* pos, void* out, int B, int H,
                   int KV, int T_len, int D, int window, cudaStream_t stream) {
  const int G = H / KV;
  const int smem =
      (G * D + kBT * (D + 1) + kBT * D + G * kBT + 3 * G) * (int)sizeof(float);
  auto kern = decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, pos, static_cast<T*>(out), H, KV,
      T_len, D, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

// q [B,H,D]; k/v [B,T,KV,D]; kv_pos [B,T] int32 (-1 = empty); pos [B] int32;
// out [B,H,D]; all contiguous.  H % KV == 0, (H/KV)*D <= 1024.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_pos,
                                      const void* pos, void* out, int B, int H,
                                      int KV, int T_len, int D, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kF32)
    return launch<float>(q, k, v, kp, p, out, B, H, KV, T_len, D, window, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, kp, p, out, B, H, KV, T_len, D,
                                 window, s);
  return cudaErrorInvalidValue;
}
