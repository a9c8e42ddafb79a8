// Single-token GQA decode attention over a paged KV pool, for Hopper sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py:75 _paged_kernel (reached
// through paged_decode_attention:111, pallas_call at :147): pools in the
// working dtype, repro_paged_decode_attention; and :92 _paged_q8_kernel
// (paged_decode_attention_q8:157, pallas_call at :200): int8 pools,
// repro_paged_decode_attention_q8.
//
// What bounds them on this card: one query token per head against a chain
// of pool blocks does 4*H*D operations per valid entry for 2*KV*D elements
// of K and V, far below the card's operations-per-byte balance, so they
// are bound by the bytes of the blocks the chains reach (int8 pools: a
// quarter of f32's).
//
// f32 / bf16 pools (#8): the split-KV flash-decode of split_decode.cuh.
// The TPU kernel scalar-prefetched the table and walked it as the minor
// grid axis, one (slot, kv head) at a time; here the walk is split over
// whole table columns (a split is a run of pool blocks), each block holds
// its slot's table row in shared memory, gathers only the tiles that hold
// a valid entry, a kv head's [bs, D] rows of each pool block at a time, in
// 16-byte cp.async pieces, and the last split of each (slot, kv head) to
// finish combines the splits' f32 partials.  The cache policy below is the
// whole of what is paged about it: entry t of the walk is offset t % bs of
// pool block table[b, t / bs], and the walk ends at the first NULL column
// after column 0 (chains are contiguous, so such columns are the chain's
// unused tail: the reference's NULL tiles add exactly 0 once a valid entry
// has been seen, and column 0 always holds position 0); a slot with no
// valid entry averages V over the chain's entries, as the walk of the
// first version did.
//
// int8 pools (#9, paged_kernel<QT, int8_t>, still the first version): one
// block per (slot, kv head) walks its table row in tiles of up to 64
// entries (several pool blocks of the chain at once), dequantizes each
// tile in registers by the block's per-(block, kv head) f32 scale while it
// is staged in shared memory as f32 for all G = H/KV q heads of the kv
// head, and folds it into an f32 online softmax (m, l, acc);
// full-precision K/V never exists in device memory.  Under-filling 132 SMs
// (16 slots x 4 kv heads = 64 blocks), it can take #8's design by a cache
// policy that dequantizes.
//
// Numerics follow the TPU kernels: q is pre-scaled by D^-0.5, an entry is
// attended iff kv_pos >= 0 && kv_pos <= pos, a masked score is -1e30 with m
// starting at -inf, and l is clamped at 1e-30.

#include <type_traits>

#include "common.cuh"
#include "split_decode.cuh"

// Beside common.cuh's overloads, in the same (global) scope so that one
// unqualified call finds all of them.
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kTargetTile = 64;   // entries per tile (whole pool blocks)
constexpr int kMaxOut = 8;        // G*D outputs per thread (G*D <= 1024)
constexpr int kNull = 0;          // NULL_BLOCK: unused table entries

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pool,
             const PT* __restrict__ v_pool, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ pos_pool, const int* __restrict__ table,
             const int* __restrict__ pos, QT* __restrict__ out, int H, int KV,
             int D, int bs, int M, int tile, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int G = H / KV;
  const int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [G][D]
  float* Ks = Qs + G * D;         // [tile][D+1]
  float* Vs = Ks + tile * DP;     // [tile][D]
  float* Ss = Vs + tile * D;      // [G][tile]
  float* Ms = Ss + G * tile;      // [G] running max
  float* Ls = Ms + G;             // [G] running sum
  float* Cs = Ls + G;             // [G] this tile's correction
  int* Ts = reinterpret_cast<int*>(Cs + G);  // [M] this slot's table row
  int* Ps = Ts + M;                          // [tile] entry positions
  __shared__ int n_cols;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, h = blockIdx.x;
  const int p = pos[b];

  const QT* qb = q + ((int64_t)b * H + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }
  for (int j = tid; j < M; j += kThreads) Ts[j] = table[(int64_t)b * M + j];
  if (tid == 0) n_cols = M;
  __syncthreads();
  for (int j = tid + 1; j < M; j += kThreads)
    if (Ts[j] == kNull) atomicMin(&n_cols, j);
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();
  const int E = n_cols * bs;  // entries of the chain, column 0 always walked

  for (int t0 = 0; t0 < E; t0 += tile) {
    __syncthreads();  // previous tile's K/V/S fully consumed
    for (int i = tid; i < tile * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int t = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < E) {
        const int col = t / bs, off = t - col * bs;
        const int64_t bid = Ts[col];
        const int64_t idx = ((bid * bs + off) * KV + h) * D + d;
        kx = to_f32(k_pool[idx]);
        vx = to_f32(v_pool[idx]);
        if constexpr (kQuant) {
          kx *= k_scale[bid * KV + h];
          vx *= v_scale[bid * KV + h];
        }
        if (d == 0) Ps[c] = pos_pool[bid * bs + off];
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < G * tile; i += kThreads) {
      const int g = i / tile, c = i - g * tile;
      float s;
      if (t0 + c >= E) {
        s = -INFINITY;  // past the chain: not an entry at all
      } else {
        const int kp = Ps[c];
        if (kp >= 0 && kp <= p) {
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
      for (int c = lane; c < tile; c += 32) mx = fmaxf(mx, Ss[g * tile + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.f;
      for (int c = lane; c < tile; c += 32) {
        const float e = expf(Ss[g * tile + c] - m_new);
        Ss[g * tile + c] = e;
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
        const float* pg = Ss + g * tile;
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < tile; ++c) s = fmaf(pg[c], Vs[c * D + d], s);
        acc[j] = acc[j] * Cs[g] + s;
      }
    }
  }

  QT* ob = out + ((int64_t)b * H + (int64_t)h * G) * D;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * D) ob[i] = from_f32<QT>(acc[j] / fmaxf(Ls[i / D], 1e-30f));
  }
}

template <typename QT, typename PT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* pos_pool, const void* table, const void* pos,
                   void* out, int B, int H, int KV, int D, int bs, int M,
                   cudaStream_t stream) {
  const int G = H / KV;
  const int tile = bs * std::max(1, kTargetTile / bs);
  const int smem =
      (G * D + tile * (D + 1) + tile * D + G * tile + 3 * G + M + tile) *
      (int)sizeof(float);
  auto kern = paged_kernel<QT, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pool),
      static_cast<const PT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pos_pool),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<QT*>(out), H, KV, D, bs, M, tile,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T>
struct PagedCache {
  const T* k;
  const T* v;
  const int* pos_pool;
  const int* table;
  int bs, M, KV, D;
  int h, n_cols;
  const int* ts;  // the slot's table row, in shared memory

  __device__ void prepare(int b, int h_, unsigned char* extra) {
    __shared__ int cols;
    int* row = reinterpret_cast<int*>(extra);
    for (int j = threadIdx.x; j < M; j += blockDim.x)
      row[j] = table[(int64_t)b * M + j];
    if (threadIdx.x == 0) cols = M;
    __syncthreads();
    for (int j = threadIdx.x + 1; j < M; j += blockDim.x)
      if (row[j] == kNull) atomicMin(&cols, j);
    __syncthreads();
    h = h_;
    n_cols = cols;
    ts = row;
  }
  __device__ int length() const { return n_cols * bs; }
  __device__ int64_t entry(int t) const {
    const int col = t / bs;
    return (int64_t)ts[col] * bs + (t - col * bs);
  }
  __device__ int64_t row(int t) const { return (entry(t) * KV + h) * D; }
  __device__ int position(int t) const { return pos_pool[entry(t)]; }
};

template <typename T>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const void* pos_pool,
                         const void* table, const void* pos, void* out,
                         void* part, void* arrived, int B, int H, int KV,
                         int D, int bs, int M, int splits, int split_cols,
                         cudaStream_t stream) {
  PagedCache<T> cache{static_cast<const T*>(k_pool),
                      static_cast<const T*>(v_pool),
                      static_cast<const int*>(pos_pool),
                      static_cast<const int*>(table), bs, M, KV, D, 0, 0,
                      nullptr};
  return split_decode::launch<PagedCache<T>, T>(
      cache, q, pos, part, arrived, out, B, H, KV, D, 0, splits,
      split_cols * bs, M * (int)sizeof(int), stream);
}

}  // namespace

// q [B,H,D]; k_pool/v_pool [N,bs,KV,D] in q's dtype; pos_pool [N,bs] int32
// (-1 = empty); table [B,M] int32 of block ids in [0, N); pos [B] int32;
// out [B,H,D]; part f32 scratch [B*KV*splits*G*(D+2)]; arrived int32
// [B*KV], zero (left zero); all contiguous.  H/KV <= 8, D in {16, 32, 64,
// 128, 256}; split_cols table columns a split, splits * split_cols >= M,
// split_cols * bs <= 8192, splits <= 128.  One launch on `stream`.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* pos_pool, const void* table, const void* pos, void* out,
    void* part, void* arrived, int B, int H, int KV, int D, int bs, int M,
    int splits, int split_cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)splits * split_cols < M) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_split<float>(q, k_pool, v_pool, pos_pool, table, pos, out,
                               part, arrived, B, H, KV, D, bs, M, splits,
                               split_cols, s);
  if (dtype == kBF16)
    return launch_split<__nv_bfloat16>(q, k_pool, v_pool, pos_pool, table,
                                       pos, out, part, arrived, B, H, KV, D,
                                       bs, M, splits, split_cols, s);
  return cudaErrorInvalidValue;
}

// As above with int8 pools and f32 k_scale/v_scale [N,KV]; q and out f32 or
// bf16 (dtype).
extern "C" int repro_paged_decode_attention_q8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* pos_pool,
    const void* table, const void* pos, void* out, int B, int H, int KV,
    int D, int bs, int M, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                 pos_pool, table, pos, out, B, H, KV, D, bs,
                                 M, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                         pos_pool, table, pos, out, B, H, KV,
                                         D, bs, M, s);
  return cudaErrorInvalidValue;
}
