// Single-token GQA flash-decode attention over a dense KV cache, for
// Hopper sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py:28 _decode_kernel (reached
// through decode_attention:72, pallas_call at :90).
//
// What bounds it on this card: one query token per head against a [T]
// cache does 4*H*D operations per valid entry for 2*KV*D elements of K and
// V, far below the card's operations-per-byte balance, so it is bound by
// the bytes of the valid entries (a serving cache is mostly empty or
// stale: 16 slots at 64-2048 of 2048 entries in the kernels phase).
//
// What the design does about it: the split-KV flash-decode of
// split_decode.cuh.  The TPU grid walked a row's T blocks in order with
// (m, l, acc) in VMEM scratch, one (row, kv head) at a time; here blocks of
// one (row, kv head) each take a run of the cache, copy only the 16-byte
// pieces of tiles that hold a valid entry through a cp.async ring, and the
// last split of each (row, kv head) to finish combines their f32
// partials.  The cache policy below is the whole of what is dense about
// it: entry t of row b is row b*T + t of the [B*T, KV, D] cache, its
// position kv_pos[b, t], and the walk covers all T entries (a row with no
// valid entry averages V over all T, as the reference does).

#include "split_decode.cuh"

namespace {

template <typename T>
struct DenseCache {
  using Storage = T;
  const T* k;
  const T* v;
  const int* kv_pos;
  int T_len, KV, D;
  int h;
  int64_t row0;  // b * T
  const int* pb;

  __device__ void prepare(int b, int h_, unsigned char*) {
    h = h_;
    row0 = (int64_t)b * T_len;
    pb = kv_pos + row0;
  }
  __device__ int length() const { return T_len; }
  __device__ int64_t row(int t) const { return ((row0 + t) * KV + h) * D; }
  __device__ int position(int t) const { return pb[t]; }
};

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_pos, const void* pos, void* out, void* part,
                   void* arrived, int B, int H, int KV, int T_len, int D,
                   int window, int splits, int split_len,
                   cudaStream_t stream) {
  DenseCache<T> cache{static_cast<const T*>(k), static_cast<const T*>(v),
                      static_cast<const int*>(kv_pos), T_len, KV, D, 0, 0,
                      nullptr};
  return split_decode::launch<DenseCache<T>, T>(
      cache, q, pos, part, arrived, out, B, H, KV, D, window, splits,
      split_len, 0, stream);
}

}  // namespace

// q [B,H,D]; k/v [B,T,KV,D]; kv_pos [B,T] int32 (-1 = empty); pos [B] int32;
// out [B,H,D]; part f32 scratch [B*H*splits*(D+2)]; arrived int32
// [B*KV*head_groups(H/KV)], zero (left zero); all contiguous.  Any G =
// H/KV (run in groups of at most 8 q heads), D in {16, 32, 64, 128, 256}; splits * split_len >= T with split_len <= 8192 and splits <=
// 128.  One launch on `stream`.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_pos,
                                      const void* pos, void* out, void* part,
                                      void* arrived, int B, int H, int KV,
                                      int T_len, int D, int window,
                                      int splits, int split_len, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)splits * split_len < T_len) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch<float>(q, k, v, kv_pos, pos, out, part, arrived, B, H, KV,
                         T_len, D, window, splits, split_len, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, kv_pos, pos, out, part, arrived, B,
                                 H, KV, T_len, D, window, splits, split_len,
                                 s);
  return cudaErrorInvalidValue;
}
