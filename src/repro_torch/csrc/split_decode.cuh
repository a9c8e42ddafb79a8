// Split-KV flash-decode for Hopper, sm_90a: the machinery that the dense
// (decode_attention.cu, #3) and paged (paged_attention.cu, #8, and #9
// over int8 pools) decode kernels share.  Each file supplies a cache
// policy that says where entry t of a (row, kv head) walk lies, what its
// position is and in which type its K/V are stored; everything else is
// here.
//
// One query token per head against a cache does 4*G*D operations per
// 2*D*sizeof(S) bytes of an entry's K and V (G = H/KV q heads share each
// entry, S the storage type), far below the card's operations-per-byte
// balance: the work is bound by the bytes of the valid entries.  So the
// design is about moving those bytes, and only those, at the card's rate:
//
// * The walk is split across blocks.  Grid (KV * NG, splits, B): split s
//   of (row b, head group x) covers entries [s*split_len, (s+1)*split_len)
//   of the walk of kv head x / NG (the wrapper picks splits so that about
//   512 blocks are in flight, ~4 on each of the 132 SMs; the kv heads of
//   a run, which interleave in a dense cache, launch side by side).  A
//   block computes at most kMaxGroup = 8 q heads: a kv head's G q heads
//   run as NG = head_groups(G) groups of G / NG each (NG = 1 for G <= 8,
//   so those launches are unchanged; granite-20b's G 48 is 6 groups of
//   8).  Every group block walks its kv head's tiles as a G <= 8 block
//   does, so a kv head's K/V are read once a group, the later reads
//   mostly from L2 (one read for all groups is later work).  Each split
//   writes an f32 partial (m, l, acc[G/NG][D]) to scratch and counts
//   itself in on its (row, head group)'s arrival counter; the last split
//   to arrive reads the group's partials back from L2, rescales them by
//   2^(m_s - m) and divides by max(l, 1e-30), and resets the counter to 0
//   for the next launch (the wrapper keeps one zeroed counter buffer a
//   stream).  One
//   launch, no spinning; a first version combined in a second launch,
//   which added 6-7 us after the splits on the H100 (the launch, then two
//   dependent trips to memory with the device otherwise idle).
// * No bytes move for empty entries.  A split first reads its entries'
//   positions into a bit mask and lists the tiles that hold a valid
//   entry; only those tiles' K/V are copied.  A split with no valid entry
//   writes an empty partial (m = -inf, l = 0) and reads no K/V, unless the
//   whole row has no valid entry (an idle slot): then, as the reference
//   does with every score at -1e30, the row averages V uniformly over the
//   entries the walk covers, each split summing its own V (m = -1e30,
//   l = its entry count), and the combine's ordinary arithmetic gives the
//   mean.  Skipping a tile without a valid entry is exact once the row
//   has one: a -1e30 score then weighs 2^(-1e30 - m) = 0.
// * Bytes stay in flight.  K/V tiles are staged in shared memory in their
//   storage type (bf16 stays 2 bytes, int8 1) by 16-byte cp.async copies,
//   neighbouring threads on neighbouring addresses, in a ring of stages,
//   so the next tiles' copies overlap this tile's math.  An int8 cache
//   (#9) also stages each entry's K and V scale (its pool block's, per kv
//   head) beside the tile, by 4-byte copies.
// * The math keeps up with the bytes.  bf16 q (every serving path) runs
//   split_decode_mma_kernel: each warp takes 16 entries of a 64-entry tile
//   and computes Sᵀ = K·Qᵀ and Oᵀ += Vᵀ·Pᵀ with mma.sync m16n8k16 (the
//   <= 8 q heads of the block's head group are the n = 8 side; K and Vᵀ come from
//   a padded bf16 tile by ldmatrix, Pᵀ from Sᵀ's accumulators by
//   movmatrix), so a lane holds two heads' scores and output columns and
//   the online softmax needs three shuffles a head.  A first version did
//   q·k and p·v as f32 FMAs with a 16-byte K row slice a lane and shuffle
//   reductions: ~94 warp instructions an entry at head dim 128 made it
//   issue-bound, at ~2.5x the bytes' time on the H100.  Over int8,
//   ldmatrix (.trans for V) reads the staged int8 rows as 16-bit pairs,
//   and each lane widens its words to the A fragments' bf16 pairs in
//   registers (exact: |x| <= 128), K's dims and V's rows taken in an
//   order that makes the words line up (q and the output follow it); a
//   first version converted each warp's rows into a bf16 buffer in
//   shared memory and ran the bf16 loads on it, at 1.49x a read of its
//   bytes on the H100, where #8 runs at 1.14x.  K's scale multiplies the
//   entry's f32 score, and V's is folded into Pᵀ (p·vs rounded to bf16
//   once), so no product of an int8 value and its scale is ever rounded
//   to bf16.  f32 q (the parity checks) keeps the CUDA-core form,
//   split_decode_kernel, where a row's lanes reduce q·k by shuffles and
//   each warp keeps its (m, l, acc) in registers; int8 rows are widened
//   to f32 as each lane reads its slice, with the same two scale
//   placements.  In both, the four warps merge through shared memory at
//   the end of the split.
//
// Numerics follow the TPU kernels: the scale D^-0.5 applied in f32 (with
// log2(e), so the softmax runs on exp2), an entry is attended iff
// kv_pos >= 0 && kv_pos <= pos (&& kv_pos > pos - window), a masked score is
// -1e30 and an entry past the walk -inf, m starts at -inf and l is clamped
// at 1e-30.  The bf16 kernel rounds p to bf16 for P·V and sums l from the
// rounded p (over int8 it rounds p·vs for P·V, and l still sums the
// rounded p).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace split_decode {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;              // f32: row passes of a warp per tile
constexpr int kMaxSplitLen = 8192;     // entries a split covers (bit mask)
constexpr int kMaxTiles = kMaxSplitLen / 16;  // smallest tile: 16 entries
constexpr int kMaxSplits = 128;        // partials the combine reads
constexpr int kMaxGroup = 8;           // q heads a block

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The groups a kv head's G q heads run in: the fewest of equal size, each
// at most kMaxGroup (1 for G <= 8; 6 of 8 for G 48; G 9 takes 3 of 3).
// kernels/decode_attention.py's head_groups mirrors it.
inline int head_groups(int G) {
  int n = (G + kMaxGroup - 1) / kMaxGroup;
  while (G % n) ++n;
  return n;
}

// Shared memory a split reuses once its walk is done: the warps' acc
// [kWarps][kMaxGroup][D] f32 (write_partial), then the combine's scratch
// (finish).
template <int D>
constexpr int tail_bytes() {
  return cmax(kWarps * kMaxGroup * D * 4,
              (2 * kMaxSplits * kMaxGroup + 2 * kMaxGroup) * 4);
}

// The ring of stages, in the cache's storage type S: a stage is K then V
// [kTile][kRow] and, for int8 (S = int8_t, which carries scales), the
// tile's per-entry K then V scales [kTile] f32.  Rows are copied in
// 16-byte pieces.  kBytes also covers what the split reuses at its end.

// f32 q: the lane layout of one K or V row of D values on the CUDA cores
// (kVec values a lane piece: 16 bytes of f32, 4 of int8).  int8 rows are
// not padded: a row's lanes read consecutive words, and a warp's rows
// follow one another, so every read is linear.
template <int D, typename S>
struct SimtLayout {
  static constexpr int kStages = 3;
  static constexpr int kVec = 4;                 // values a lane piece
  static constexpr int kPieces = D / kVec;       // lane pieces a row
  static constexpr int kLpr = kPieces < 32 ? kPieces : 32;  // lanes a row
  static constexpr int kPpl = kPieces / kLpr;    // pieces a lane
  static constexpr int kEpl = kPpl * kVec;       // elements a lane
  static constexpr int kRpw = 32 / kLpr;         // rows a warp pass
  static constexpr int kTile = kSteps * kRpw * kWarps;  // entries a tile
  static constexpr bool kScaled = std::is_same<S, int8_t>::value;
  static constexpr int kRow = D;                 // smem row, elements of S
  static constexpr int kCopies = D * (int)sizeof(S) / 16;  // copies a row
  static constexpr int kHalf = kTile * kRow * (int)sizeof(S);  // K bytes
  static constexpr int kStageBytes = 2 * kHalf + (kScaled ? 8 * kTile : 0);
  static constexpr int kBytes = cmax(kStages * kStageBytes, tail_bytes<D>());
  static_assert(kPieces * kVec == D && kPieces % kLpr == 0 &&
                    32 % kLpr == 0 && kTile >= 16 && kCopies >= 1,
                "head dim must be 16, 32, 64, 128 or 256");
};

// bf16 q: 16 entries a warp, read by ldmatrix from rows padded by 16
// bytes, so that its eight row addresses of a matrix fall in distinct
// banks: bf16 rows of D + 8, int8 rows of D + 16 elements.
template <int D, typename S>
struct MmaLayout {
  static constexpr int kStages = 2;
  static constexpr int kTile = 16 * kWarps;      // entries a tile
  static constexpr bool kScaled = std::is_same<S, int8_t>::value;
  static constexpr int kRow = D + 16 / (int)sizeof(S);  // smem row, of S
  static constexpr int kCopies = D * (int)sizeof(S) / 16;
  static constexpr int kHalf = kTile * kRow * (int)sizeof(S);
  static constexpr int kStageBytes = 2 * kHalf + (kScaled ? 8 * kTile : 0);
  static constexpr int kBytes = cmax(kStages * kStageBytes, tail_bytes<D>());
  static_assert(D % 16 == 0 && D >= 16 && D <= 256,
                "head dim must be 16, 32, 64, 128 or 256");
  static_assert(std::is_same<S, __nv_bfloat16>::value ||
                    std::is_same<S, int8_t>::value,
                "the tensor-core kernel stages bf16 or int8 rows");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 copies nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The four int8 of a word as f32, exactly: a byte permute builds the f32
// 2^23 + (x + 128) and an add takes 2^23 + 128 off (no int-to-float
// conversion, which runs at a quarter of the add's rate).
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128, as unsigned bytes
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
}
// Two such f32 as a bf16 pair (lo in the low half), exactly: |x| <= 128
// has at most 8 significant bits, so each f32's high half is its bf16.
__device__ __forceinline__ uint32_t bf16_pair_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// A lane's 4 values of a staged row as f32.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

__device__ __forceinline__ bool attended(int kp, int p, int window) {
  return kp >= 0 && kp <= p && (window <= 0 || kp > p - window);
}

// Does tile j (entries [j*tile, (j+1)*tile) of the split) hold a valid
// entry?  bits past the split's last word are never read: j < n_tiles.
__device__ __forceinline__ bool tile_any(const uint32_t* bits, int j,
                                         int tile, int n_words) {
  if (tile < 32) {
    const int first = j * tile;
    return (bits[first >> 5] >> (first & 31)) & ((1u << tile) - 1u);
  }
  const int w0 = j * (tile >> 5);
  const int w1 = min(w0 + (tile >> 5), n_words);
  uint32_t any = 0;
  for (int w = w0; w < w1; ++w) any |= bits[w];
  return any != 0;
}

// Shared memory of a split besides its K/V stages.
template <int GS>
struct SplitShared {
  uint32_t bits[kMaxSplitLen / 32];  // a bit a valid entry of the split
  short tiles[kMaxTiles];            // the tiles holding one, in order
  int n_listed;
  float w_m[kWarps][GS], w_l[kWarps][GS];  // each warp's m, l a head
};

// Phase 1 of a split (every thread): the bit mask of its n entries from
// t0 and the list of tiles holding a valid entry.  Returns the number of
// tiles to walk, 0 when the split adds nothing (its partial is written
// empty), with *idle set when the whole row has no valid entry (then every
// tile of the split is walked with its scores at -1e30).
template <class Cache, int GS>
__device__ int list_tiles(const Cache& cache, SplitShared<GS>& sh, int p,
                          int window, int t0, int n, int len, int tile,
                          bool* idle) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_words = (n + 31) >> 5;
  constexpr int kRound = 4;  // positions a thread loads at once
  for (int base = 0; base < n; base += kRound * kThreads) {
    int kp[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int i = base + u * kThreads + tid;
      kp[u] = i < n ? cache.position(t0 + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int b0 = base + u * kThreads;
      const uint32_t word =
          __ballot_sync(0xffffffffu, attended(kp[u], p, window));
      if (lane == 0 && b0 + warp * 32 < n) sh.bits[(b0 >> 5) + warp] = word;
    }
  }
  __syncthreads();
  const int n_tiles = (n + tile - 1) / tile;
  if (warp == 0) {
    int count = 0;
    for (int j0 = 0; j0 < n_tiles; j0 += 32) {
      const int j = j0 + lane;
      const bool any = j < n_tiles && tile_any(sh.bits, j, tile, n_words);
      const uint32_t m = __ballot_sync(0xffffffffu, any);
      if (any) sh.tiles[count + __popc(m & ((1u << lane) - 1u))] = (short)j;
      count += __popc(m);
    }
    if (lane == 0) sh.n_listed = count;
  }
  __syncthreads();
  *idle = false;
  if (sh.n_listed > 0) return sh.n_listed;
  // No valid entry here.  If the row has one elsewhere this split adds
  // nothing; if it has none, the row averages V (see the note above).
  bool found = false;
  for (int base = 0; base < len && !found; base += kThreads) {
    const int i = base + tid;
    found = __syncthreads_or(i < len && attended(cache.position(i), p, window));
  }
  if (found) return 0;
  *idle = true;
  return n_tiles;
}

// Start the copy of tile i of the walk (entries of split-relative tile j)
// into ring stage i % kStages of layout L: K then V, [kTile][kRow] each in
// the cache's storage type, 16-byte pieces, and for int8 each entry's K
// and V scale (the cache's k_scale_at / v_scale_at); rows past the split's
// n entries zero-filled; no K for an idle row, whose scores do not read
// it.
template <class L, class Cache>
__device__ __forceinline__ void issue_tile(const Cache& cache,
                                           unsigned char* ring, int i, int j,
                                           int t0, int n, bool idle) {
  using S = typename Cache::Storage;
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));
  unsigned char* stage = ring + (i % L::kStages) * L::kStageBytes;
  S* ks = reinterpret_cast<S*>(stage);
  S* vs = reinterpret_cast<S*>(stage + L::kHalf);
  for (int idx = threadIdx.x; idx < L::kTile * L::kCopies; idx += kThreads) {
    const int e = idx / L::kCopies, c = idx - e * L::kCopies;
    const int r = j * L::kTile + e;
    const bool in = r < n;
    const int64_t off = (in ? cache.row(t0 + r) : 0) + c * kVec;
    if (!idle) cp_async16(ks + e * L::kRow + c * kVec, cache.k + off, in);
    cp_async16(vs + e * L::kRow + c * kVec, cache.v + off, in);
  }
  if constexpr (L::kScaled) {
    float* sk = reinterpret_cast<float*>(stage + 2 * L::kHalf);
    for (int e = threadIdx.x; e < L::kTile; e += kThreads) {
      const int r = j * L::kTile + e;
      const bool in = r < n;
      const int t = t0 + (in ? r : 0);
      if (!idle) cp_async4(sk + e, cache.k_scale_at(t), in);
      cp_async4(sk + L::kTile + e, cache.v_scale_at(t), in);
    }
  }
}

// Phase 3 of a split: merge the warps' (m, l, acc) (w_acc [kWarps][GS][D]
// in shared memory) into the split's partial.
template <int GS>
__device__ void write_partial(const SplitShared<GS>& sh, const float* w_acc,
                              int G, int D, int64_t slot, float* part_m,
                              float* part_l, float* part_acc) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sh.w_m[w][g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (sh.w_m[w][g] != -INFINITY)
        a += exp2f(sh.w_m[w][g] - mx) * w_acc[(w * GS + g) * D + d];
    part_acc[slot * G * D + i] = a;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sh.w_m[w][g]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (sh.w_m[w][g] != -INFINITY)
        l += exp2f(sh.w_m[w][g] - mx) * sh.w_l[w][g];
    part_m[slot * G + g] = mx;
    part_l[slot * G + g] = l;
  }
}

__device__ __forceinline__ void write_empty(int G, int64_t slot,
                                            float* part_m, float* part_l) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part_m[slot * G + g] = -INFINITY;
    part_l[slot * G + g] = 0.f;
  }
}

// Where a split's results go: its partial, the arrival counters
// [B*KV] (zero between launches) and, from the last split of a (row, kv
// head), the output [B,H,D].  Here and below KV counts head groups (the
// grid's x), and G the q heads of a group: a kv head's NG groups are NG
// consecutive "kv heads" of G / NG q heads each.
template <typename T>
struct Out {
  float* part_m;    // [B, KV, splits, G]
  float* part_l;    // [B, KV, splits, G]
  float* part_acc;  // [B, KV, splits, G, D]
  int* arrived;     // [B * KV]
  T* out;
};

// Every block of a split ends here, after writing its partial (every
// thread): count it in, and if it is the last of its (row, kv head) to
// arrive, combine the row's partials into out[b, h*G + g, :].  `scratch`
// is shared memory for 2 * splits * G + 2 * kMaxGroup floats.
template <typename T>
__device__ void finish(const Out<T>& o, int b, int h, int KV, int G, int D,
                       int splits, float* scratch) {
  __shared__ int last;
  __threadfence();  // this block's partial is visible before it counts in
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&o.arrived[b * KV + h], 1) == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every split counted in: their partials are visible
  const int64_t slot0 = ((int64_t)b * KV + h) * splits;
  const int n = splits * G;
  float* sm = scratch;       // [split][g]: m, then the weights
  float* sl = sm + n;        // [split][g]: l
  float* mg = sl + n;        // [g]
  float* inv = mg + kMaxGroup;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm[i] = __ldcg(o.part_m + slot0 * G + i);
    sl[i] = __ldcg(o.part_l + slot0 * G + i);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, sm[s * G + g]);
    float l = 0.f;
    for (int s = 0; s < splits; ++s)
      if (sm[s * G + g] != -INFINITY)
        l += exp2f(sm[s * G + g] - mx) * sl[s * G + g];
    mg[g] = mx;
    inv[g] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {  // the weights
    const float ms = sm[i];
    const int g = i % G;
    sm[i] = ms == -INFINITY ? 0.f : exp2f(ms - mg[g]) * inv[g];
  }
  __syncthreads();
  T* ob = o.out + ((int64_t)b * KV + h) * G * D;
  const float* acc = o.part_acc + slot0 * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      // an empty split (weight 0) left its acc unwritten: load it anyway,
      // so that the loads go out together, and drop it
      const float x = __ldcg(acc + (int64_t)s * G * D + i);
      const float ws = sm[s * G + g];
      a = ws != 0.f ? fmaf(ws, x, a) : a;
    }
    ob[i] = from_f32<T>(a);
  }
  if (threadIdx.x == 0) o.arrived[b * KV + h] = 0;  // ready for the next
}

// f32: one split of one (row, head group) on the CUDA cores.  GP >= G q
// heads in registers (the padding heads get q = 0 and are never written).
// Cache: the type Storage of k / v (f32, or int8 with k_scale_at(t) and
// v_scale_at(t), the addresses of entry t's f32 scales); prepare(b, kv
// head, extra shared memory) with every thread, then length() (entries
// the walk covers), row(t) (element offset of entry t's K/V row in k / v)
// and position(t).  Head group x of the grid reads kv head x / ng.
template <class Cache, int D, int GP>
__global__ void __launch_bounds__(kThreads)
split_decode_kernel(Cache cache, const float* __restrict__ q,
                    const int* __restrict__ pos, Out<float> dst, int H,
                    int ng, int window, int split_len, float scale) {
  using S = typename Cache::Storage;
  using L = SimtLayout<D, S>;
  extern __shared__ __align__(16) unsigned char split_smem[];
  __shared__ SplitShared<GP> sh;

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.x, G = H / KV;  // head groups; q heads a group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  cache.prepare(b, h / ng, split_smem + L::kBytes);
  const int len = cache.length();
  const int t0 = s * split_len;
  const int n = min(split_len, len - t0);  // entries of this split
  const int64_t slot = ((int64_t)b * KV + h) * gridDim.y + s;
  if (n <= 0) {  // past the walk's end (a paged chain shorter than M)
    write_empty(G, slot, dst.part_m, dst.part_l);
    finish(dst, b, h, KV, G, D, gridDim.y,
           reinterpret_cast<float*>(split_smem));
    return;
  }
  bool idle;
  const int count = list_tiles(cache, sh, p, window, t0, n, len, L::kTile,
                               &idle);
  if (count == 0) {
    write_empty(G, slot, dst.part_m, dst.part_l);
    finish(dst, b, h, KV, G, D, gridDim.y,
           reinterpret_cast<float*>(split_smem));
    return;
  }

  // this lane's slice of q for all GP heads, scaled into log2 units
  const int cl = lane % L::kLpr, rg = lane / L::kLpr;
  float qr[GP][L::kEpl];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int pp = 0; pp < L::kPpl; ++pp)
#pragma unroll
      for (int x = 0; x < L::kVec; ++x)
        qr[g][pp * L::kVec + x] =
            g < G ? q[((int64_t)b * H + h * G + g) * D +
                      (cl + pp * L::kLpr) * L::kVec + x] * scale
                  : 0.f;
  float m_run[GP], l_run[GP], acc[GP][L::kEpl];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int x = 0; x < L::kEpl; ++x) acc[g][x] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < count)
      issue_tile<L>(cache, split_smem, i, idle ? i : sh.tiles[i], t0, n,
                    idle);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int nx = i + L::kStages - 1;
    if (nx < count)
      issue_tile<L>(cache, split_smem, nx, idle ? nx : sh.tiles[nx], t0, n,
                    idle);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    __syncthreads();

    const int j = idle ? i : sh.tiles[i];
    const unsigned char* stage = split_smem + (i % L::kStages) * L::kStageBytes;
    const S* ks = reinterpret_cast<const S*>(stage);
    const S* vs = reinterpret_cast<const S*>(stage + L::kHalf);
    // int8: the entries' K then V scales
    const float* scales = reinterpret_cast<const float*>(stage + 2 * L::kHalf);
    float sc[kSteps][GP];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int e = (warp * kSteps + st) * L::kRpw + rg;
      const int r = j * L::kTile + e;
      float kf[L::kEpl];
#pragma unroll
      for (int pp = 0; pp < L::kPpl; ++pp)
        load4(ks + e * L::kRow + (cl + pp * L::kLpr) * L::kVec, kf + pp * 4);
      const bool in = r < n;
      const bool valid =
          in && !idle && ((sh.bits[r >> 5] >> (r & 31)) & 1u);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < L::kEpl; ++x) d = fmaf(qr[g][x], kf[x], d);
#pragma unroll
        for (int off = L::kLpr / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if constexpr (L::kScaled) d *= scales[e];  // K's scale on the score
        sc[st][g] = !in ? -INFINITY : (valid ? d : REPRO_NEG_INF);
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int st = 1; st < kSteps; ++st) mx = fmaxf(mx, sc[st][g]);
#pragma unroll
      for (int off = L::kLpr; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[g], mx);
      // a warp whose rows so far all lie past the walk: keep p = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_run[g] - m_use);
      m_run[g] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        sc[st][g] = exp2f(sc[st][g] - m_use);
        ps += sc[st][g];
      }
      l_run[g] = l_run[g] * corr + ps;
#pragma unroll
      for (int x = 0; x < L::kEpl; ++x) acc[g][x] *= corr;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int e = (warp * kSteps + st) * L::kRpw + rg;
      // int8: V's scale goes into p (l keeps summing p)
      float pw[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g)
        pw[g] = L::kScaled ? sc[st][g] * scales[L::kTile + e] : sc[st][g];
#pragma unroll
      for (int pp = 0; pp < L::kPpl; ++pp) {
        float vf[4];
        load4(vs + e * L::kRow + (cl + pp * L::kLpr) * L::kVec, vf);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[g][pp * 4 + y] = fmaf(pw[g], vf[y], acc[g][pp * 4 + y]);
      }
    }
    __syncthreads();  // this stage is refilled next iteration
  }
  cp_async_wait<0>();

  // sum the warp's row groups (one m a warp), merge the warps
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int off = L::kLpr; off < 32; off <<= 1) {
      l_run[g] += __shfl_xor_sync(0xffffffffu, l_run[g], off);
#pragma unroll
      for (int x = 0; x < L::kEpl; ++x)
        acc[g][x] += __shfl_xor_sync(0xffffffffu, acc[g][x], off);
    }
  __syncthreads();  // the stages are free: reuse them for the warps' acc
  float* w_acc = reinterpret_cast<float*>(split_smem);  // [kWarps][GP][D]
  if (rg == 0)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int pp = 0; pp < L::kPpl; ++pp)
#pragma unroll
        for (int x = 0; x < L::kVec; ++x)
          w_acc[(warp * GP + g) * D + (cl + pp * L::kLpr) * L::kVec + x] =
              acc[g][pp * L::kVec + x];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      sh.w_m[warp][g] = m_run[g];
      sh.w_l[warp][g] = l_run[g];
    }
  __syncthreads();
  write_partial(sh, w_acc, G, D, slot, dst.part_m, dst.part_l, dst.part_acc);
  __syncthreads();  // w_acc is read: the scratch is free
  finish(dst, b, h, KV, G, D, gridDim.y, w_acc);
}

// bf16: one split of one (row, head group) on the tensor cores.  Warp w
// takes entries [16w, 16w + 16) of each 64-entry tile.  In mma.sync's
// fragments (g8 = lane / 4, t4 = lane % 4) the lane holds the scores of
// entries g8 and g8 + 8 for heads 2t4 and 2t4 + 1, and Oᵀ's dims 16i + g8
// and 16i + g8 + 8 for the same two heads; heads G..7 have q = 0.
template <class Cache, int D>
__global__ void __launch_bounds__(kThreads)
split_decode_mma_kernel(Cache cache, const __nv_bfloat16* __restrict__ q,
                        const int* __restrict__ pos, Out<__nv_bfloat16> dst,
                        int H, int ng, int window, int split_len,
                        float scale) {
  using S = typename Cache::Storage;
  using L = MmaLayout<D, S>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char split_smem[];
  __shared__ SplitShared<8> sh;

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.x, G = H / KV;  // head groups; q heads a group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int p = pos[b];
  cache.prepare(b, h / ng, split_smem + L::kBytes);
  const int len = cache.length();
  const int t0 = s * split_len;
  const int n = min(split_len, len - t0);
  const int64_t slot = ((int64_t)b * KV + h) * gridDim.y + s;
  if (n <= 0) {
    write_empty(G, slot, dst.part_m, dst.part_l);
    finish(dst, b, h, KV, G, D, gridDim.y,
           reinterpret_cast<float*>(split_smem));
    return;
  }
  bool idle;
  const int count = list_tiles(cache, sh, p, window, t0, n, len, L::kTile,
                               &idle);
  if (count == 0) {
    write_empty(G, slot, dst.part_m, dst.part_l);
    finish(dst, b, h, KV, G, D, gridDim.y,
           reinterpret_cast<float*>(split_smem));
    return;
  }

  // Qᵀ as mma's B operand, one [16 dims x 8 heads] fragment a k-step:
  // head g8, k = 2t4 (+1) and 2t4 + 8 (+9), bf16 as q is.  k is dim 16kk +
  // k over bf16 K; over int8 K (below) dims 16kk + 4t4 (+1) and + 2 (+3)
  // are the lane's k = 2t4 (+1) and 2t4 + 8 (+9): q·k sums over the dims
  // in any order, so K and Qᵀ take the same one.
  constexpr bool kInt8 = L::kScaled;
  uint32_t qb[D / 16][2];
  {
    const uint32_t* qh = reinterpret_cast<const uint32_t*>(
        q + ((int64_t)b * H + h * G + (g8 < G ? g8 : 0)) * D);
    const int d0 = kInt8 ? 4 * t4 : 2 * t4, d1 = kInt8 ? d0 + 2 : d0 + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qb[kk][0] = g8 < G ? qh[(kk * 16 + d0) / 2] : 0u;
      qb[kk][1] = g8 < G ? qh[(kk * 16 + d1) / 2] : 0u;
    }
  }
  float o[D / 16][4];
#pragma unroll
  for (int mi = 0; mi < D / 16; ++mi)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[mi][x] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < count)
      issue_tile<L>(cache, split_smem, i, idle ? i : sh.tiles[i], t0, n,
                    idle);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int nx = i + L::kStages - 1;
    if (nx < count)
      issue_tile<L>(cache, split_smem, nx, idle ? nx : sh.tiles[nx], t0, n,
                    idle);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    __syncthreads();

    const int j = idle ? i : sh.tiles[i];
    const unsigned char* stage =
        split_smem + (i % L::kStages) * L::kStageBytes;
    const S* kst = reinterpret_cast<const S*>(stage) + warp * 16 * L::kRow;
    const S* vst =
        reinterpret_cast<const S*>(stage + L::kHalf) + warp * 16 * L::kRow;
    // int8: the tile's K then V scales, by entry
    [[maybe_unused]] const float* scales =
        reinterpret_cast<const float*>(stage + 2 * L::kHalf);

    // Sᵀ [16 entries x 8 heads] = K (16 x D) · Qᵀ (D x 8)
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kInt8) {
      // ldmatrix over int8 rows as b16: per 16-byte chunk, the lane's
      // word holds bytes 4t4..4t4+3 of rows g8 and g8 + 8, which widen
      // exactly to the A fragment's two bf16 pairs of each row
      constexpr int kMats = D == 16 ? 1 : 2;  // chunks an ldmatrix
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += kMats) {
        uint32_t r[4];
        const S* a_row = kst + (lane & 15) * L::kRow + (kk + (lane >> 4)) * 16;
        if constexpr (kMats == 1) ldmatrix_x2(r, a_row);
        else ldmatrix_x4(r, a_row);
#pragma unroll
        for (int c = 0; c < kMats; ++c) {
          float lo[4], hi[4];
          i8x4_to_f32(r[2 * c], lo);       // row g8
          i8x4_to_f32(r[2 * c + 1], hi);   // row g8 + 8
          const uint32_t a[4] = {
              bf16_pair_exact(lo[0], lo[1]), bf16_pair_exact(hi[0], hi[1]),
              bf16_pair_exact(lo[2], lo[3]), bf16_pair_exact(hi[2], hi[3])};
          mma_16816(sc, a, qb[kk + c][0], qb[kk + c][1]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, kst + (lane & 15) * L::kRow + kk * 16 + (lane >> 4) * 8);
        mma_16816(sc, a, qb[kk][0], qb[kk][1]);
      }
    }
    // sc[0], sc[1]: entry g8, heads 2t4, 2t4+1; sc[2], sc[3]: entry g8 + 8
    // int8: V's scale of entries g8, g8 + 8
    [[maybe_unused]] float vsc[2] = {1.f, 1.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = warp * 16 + g8 + 8 * half;
      const int r = j * L::kTile + e;
      const bool in = r < n;
      const bool valid =
          in && !idle && ((sh.bits[r >> 5] >> (r & 31)) & 1u);
      float ksc = 1.f;
      if constexpr (L::kScaled) {
        ksc = scales[e];
        vsc[half] = scales[L::kTile + e];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[2 * half + c];
        x = !in ? -INFINITY : (valid ? x * ksc * scale : REPRO_NEG_INF);
      }
    }
    float mx0 = fmaxf(sc[0], sc[2]), mx1 = fmaxf(sc[1], sc[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // a warp whose rows so far all lie past the walk: keep p = 0
    const float u0 = n0 == -INFINITY ? 0.f : n0;
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = exp2f(m0 - u0), c1 = exp2f(m1 - u1);
    m0 = n0;
    m1 = n1;
    float pf[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) pf[c] = exp2f(sc[c] - (c & 1 ? u1 : u0));
    const uint32_t pa = pack_bf16(pf[0], pf[1]);
    const uint32_t pb = pack_bf16(pf[2], pf[3]);
    const __nv_bfloat162 ha = *reinterpret_cast<const __nv_bfloat162*>(&pa);
    const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&pb);
    l0 = l0 * c0 + (__low2float(ha) + __low2float(hb));
    l1 = l1 * c1 + (__high2float(ha) + __high2float(hb));
    // Pᵀ as mma's B operand [16 entries x 8 heads]: transpose the two 8x8
    // blocks of Sᵀ's layout (entries 0-7, 8-15); int8 folds V's scale in
    uint32_t b0, b1;
    if constexpr (L::kScaled) {
      b0 = movmatrix_trans(pack_bf16(pf[0] * vsc[0], pf[1] * vsc[0]));
      b1 = movmatrix_trans(pack_bf16(pf[2] * vsc[1], pf[3] * vsc[1]));
    } else {
      b0 = movmatrix_trans(pa);
      b1 = movmatrix_trans(pb);
    }

    // Oᵀ [D x 8 heads] += Vᵀ (D x 16 entries) · Pᵀ (16 x 8)
#pragma unroll
    for (int mi = 0; mi < D / 16; ++mi) {
      o[mi][0] *= c0;
      o[mi][1] *= c1;
      o[mi][2] *= c0;
      o[mi][3] *= c1;
    }
    if constexpr (kInt8) {
      // ldmatrix.trans over int8 rows as b16: per 16-byte chunk and 8
      // entries, the lane's word holds dims 2g8, 2g8 + 1 of entries 2t4
      // and 2t4 + 1, i.e. Vᵀ's pairs of rows g8 (dim 2g8) and g8 + 8 (dim
      // 2g8 + 1) of the A fragment, so o's rows are those dims here
      constexpr int kMats = D == 16 ? 1 : 2;
#pragma unroll
      for (int mi = 0; mi < D / 16; mi += kMats) {
        uint32_t r[4];
        const S* a_row = vst + (lane & 15) * L::kRow + (mi + (lane >> 4)) * 16;
        if constexpr (kMats == 1) ldmatrix_x2_trans(r, a_row);
        else ldmatrix_x4_trans(r, a_row);
#pragma unroll
        for (int c = 0; c < kMats; ++c) {
          float e0[4], e8[4];
          i8x4_to_f32(r[2 * c], e0);       // entries 2t4, 2t4 + 1
          i8x4_to_f32(r[2 * c + 1], e8);   // entries 2t4 + 8, 2t4 + 9
          const uint32_t a[4] = {
              bf16_pair_exact(e0[0], e0[2]), bf16_pair_exact(e0[1], e0[3]),
              bf16_pair_exact(e8[0], e8[2]), bf16_pair_exact(e8[1], e8[3])};
          mma_16816(o[mi + c], a, b0, b1);
        }
      }
    } else {
      const int vr = (lane & 7) + ((lane >> 4) << 3);  // entry of the lane
      const int vc = ((lane >> 3) & 1) * 8;             // dim offset
#pragma unroll
      for (int mi = 0; mi < D / 16; ++mi) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vst + vr * L::kRow + mi * 16 + vc);
        mma_16816(o[mi], a, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled next iteration
  }
  cp_async_wait<0>();

  // l over the warp's entries (m is the same on the lanes of a t4)
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();  // the stages are free: reuse them for the warps' acc
  float* w_acc = reinterpret_cast<float*>(split_smem);  // [kWarps][8][D]
#pragma unroll
  for (int mi = 0; mi < D / 16; ++mi) {
    // o's rows g8, g8 + 8: dims g8, g8 + 8 (int8: 2g8, 2g8 + 1) of 16mi
    const int d = mi * 16 + (kInt8 ? 2 * g8 : g8), d8 = d + (kInt8 ? 1 : 8);
    w_acc[(warp * 8 + 2 * t4) * D + d] = o[mi][0];
    w_acc[(warp * 8 + 2 * t4 + 1) * D + d] = o[mi][1];
    w_acc[(warp * 8 + 2 * t4) * D + d8] = o[mi][2];
    w_acc[(warp * 8 + 2 * t4 + 1) * D + d8] = o[mi][3];
  }
  if (g8 == 0) {
    sh.w_m[warp][2 * t4] = m0;
    sh.w_m[warp][2 * t4 + 1] = m1;
    sh.w_l[warp][2 * t4] = l0;
    sh.w_l[warp][2 * t4 + 1] = l1;
  }
  __syncthreads();
  write_partial(sh, w_acc, G, D, slot, dst.part_m, dst.part_l, dst.part_acc);
  __syncthreads();  // w_acc is read: the scratch is free
  finish(dst, b, h, KV, G, D, gridDim.y, w_acc);
}

// Raise a kernel's dynamic shared memory limit to `bytes` once per device
// (`allowed` is the caller's record, one per kernel instance).
template <class Kern>
cudaError_t allow_smem(Kern kern, int bytes, int (&allowed)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 16) allowed[dev] = bytes;
  return err;
}

template <class Kern, class Cache, typename T>
cudaError_t run(Kern kern, int ring_bytes, int (&allowed)[16],
                const Cache& cache, const T* q, const int* pos, float* part,
                int* arrived, T* out, int B, int H, int KV, int D, int window,
                int splits, int split_len, int extra_smem,
                cudaStream_t stream) {
  const int smem = ring_bytes + extra_smem;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const int ng = head_groups(H / KV);
  const int64_t parts = (int64_t)B * H * splits;  // B * KV * splits * G
  const Out<T> o{part, part + parts, part + 2 * parts, arrived, out};
  // scores in log2 units: the softmax runs on exp2
  const float scale = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  kern<<<dim3(KV * ng, splits, B), kThreads, smem, stream>>>(
      cache, q, pos, o, H, ng, window, split_len, scale);
  return cudaGetLastError();
}

template <class Cache, typename T, int D>
cudaError_t launch_d(const Cache& cache, const T* q, const int* pos,
                     float* part, int* arrived, T* out, int B, int H, int KV,
                     int window, int splits, int split_len, int extra_smem,
                     cudaStream_t stream) {
  using S = typename Cache::Storage;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static int allowed[16] = {0};  // this instance's limit, per device
    return run(split_decode_mma_kernel<Cache, D>, MmaLayout<D, S>::kBytes,
               allowed, cache, q, pos, part, arrived, out, B, H, KV, D,
               window, splits, split_len, extra_smem, stream);
  } else {
    using L = SimtLayout<D, S>;
    const int G = H / KV / head_groups(H / KV);  // q heads a block
#define REPRO_SPLIT_GP(GP)                                                 \
  {                                                                        \
    static int allowed[16] = {0};                                          \
    return run(split_decode_kernel<Cache, D, GP>, L::kBytes, allowed, cache, \
               q, pos, part, arrived, out, B, H, KV, D, window, splits,    \
               split_len, extra_smem, stream);                             \
  }
    if (G == 1) REPRO_SPLIT_GP(1)
    if (G == 2) REPRO_SPLIT_GP(2)
    if (G <= 4) REPRO_SPLIT_GP(4)
    if (G <= kMaxGroup) REPRO_SPLIT_GP(8)
#undef REPRO_SPLIT_GP
    return cudaErrorInvalidValue;
  }
}

// The decode over any cache policy: q [B,H,D]; out [B,H,D]; part the f32
// scratch of 2*B*H*splits + B*H*splits*D floats; arrived
// B*KV*head_groups(H/KV) int32 counters, zero, which the launch leaves
// zero; 1 <= splits <= kMaxSplits, 1 <= split_len <= kMaxSplitLen, any
// G = H/KV, D in {16, 32, 64, 128, 256}; T float (CUDA cores) or bf16
// (tensor cores).
template <class Cache, typename T>
cudaError_t launch(const Cache& cache, const void* q, const void* pos,
                   void* part, void* arrived, void* out, int B, int H, int KV,
                   int D,
                   int window, int splits, int split_len, int extra_smem,
                   cudaStream_t stream) {
  if (KV <= 0 || H % KV || splits < 1 ||
      splits > kMaxSplits || split_len < 1 || split_len > kMaxSplitLen)
    return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const int* pt = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part);
  int* ar = static_cast<int*>(arrived);
  T* ot = static_cast<T*>(out);
  switch (D) {
#define REPRO_SPLIT_D(DD)                                                  \
  case DD:                                                                 \
    return launch_d<Cache, T, DD>(cache, qt, pt, pa, ar, ot, B, H, KV,     \
                                  window, splits, split_len, extra_smem,   \
                                  stream)
    REPRO_SPLIT_D(16);
    REPRO_SPLIT_D(32);
    REPRO_SPLIT_D(64);
    REPRO_SPLIT_D(128);
    REPRO_SPLIT_D(256);
#undef REPRO_SPLIT_D
  }
  return cudaErrorInvalidValue;
}

}  // namespace split_decode
