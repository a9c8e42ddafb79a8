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
// int8 pools (#9): the same split kernel over a cache policy whose K/V are
// stored as int8 with an f32 scale per (pool block, kv head).  The TPU
// kernel dequantized each [bs, D] tile in VMEM (int8 x the block's scale,
// in f32) before the f32 decode; here the int8 rows move as int8 (half
// the bytes of bf16) in the same 16-byte cp.async pieces, each entry's K
// and V scale is staged beside its row, and the scales are applied where
// they cost one multiply an entry: K's on the entry's f32 score, V's on
// its p (split_decode.cuh).  With bf16 q each lane widens the int8 words
// it loads by ldmatrix to exact bf16 mma fragments in registers; with f32
// q (the parity checks) the lanes widen them to f32.  Full-precision K/V
// never exists in device memory.
//
// Numerics follow the TPU kernels: q is scaled by D^-0.5, an entry is
// attended iff kv_pos >= 0 && kv_pos <= pos, a masked score is -1e30 with m
// starting at -inf, and l is clamped at 1e-30.

#include "common.cuh"
#include "split_decode.cuh"

namespace {

constexpr int kNull = 0;  // NULL_BLOCK: unused table entries

template <typename T>
struct PagedCache {
  using Storage = T;
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

// int8 pools: entry t's K and V scale are its pool block's, for kv head h.
struct PagedQ8Cache : PagedCache<int8_t> {
  const float* k_scale;  // [N, KV]
  const float* v_scale;

  __device__ const float* k_scale_at(int t) const {
    return k_scale + (int64_t)ts[t / bs] * KV + h;
  }
  __device__ const float* v_scale_at(int t) const {
    return v_scale + (int64_t)ts[t / bs] * KV + h;
  }
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

template <typename T>
cudaError_t launch_q8(const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale,
                      const void* pos_pool, const void* table,
                      const void* pos, void* out, void* part, void* arrived,
                      int B, int H, int KV, int D, int bs, int M, int splits,
                      int split_cols, cudaStream_t stream) {
  PagedQ8Cache cache{{static_cast<const int8_t*>(k_pool),
                      static_cast<const int8_t*>(v_pool),
                      static_cast<const int*>(pos_pool),
                      static_cast<const int*>(table), bs, M, KV, D, 0, 0,
                      nullptr},
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale)};
  return split_decode::launch<PagedQ8Cache, T>(
      cache, q, pos, part, arrived, out, B, H, KV, D, 0, splits,
      split_cols * bs, M * (int)sizeof(int), stream);
}

}  // namespace

// q [B,H,D]; k_pool/v_pool [N,bs,KV,D] in q's dtype; pos_pool [N,bs] int32
// (-1 = empty); table [B,M] int32 of block ids in [0, N); pos [B] int32;
// out [B,H,D]; part f32 scratch [B*H*splits*(D+2)]; arrived int32
// [B*KV*head_groups(H/KV)], zero (left zero); all contiguous.  Any G =
// H/KV (run in groups of at most 8 q heads), D in {16, 32, 64, 128, 256}; split_cols table columns a split, splits * split_cols >= M,
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

// As above with int8 pools and f32 k_scale/v_scale [N,KV] (one scale per
// pool block and kv head); q and out f32 or bf16 (dtype).
extern "C" int repro_paged_decode_attention_q8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* pos_pool,
    const void* table, const void* pos, void* out, void* part,
    void* arrived, int B, int H, int KV, int D, int bs, int M, int splits,
    int split_cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)splits * split_cols < M) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_q8<float>(q, k_pool, v_pool, k_scale, v_scale, pos_pool,
                            table, pos, out, part, arrived, B, H, KV, D, bs,
                            M, splits, split_cols, s);
  if (dtype == kBF16)
    return launch_q8<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                    pos_pool, table, pos, out, part, arrived,
                                    B, H, KV, D, bs, M, splits, split_cols,
                                    s);
  return cudaErrorInvalidValue;
}
