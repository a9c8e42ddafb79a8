// Max-abs int8 quantization of KV tiles, its inverse with an optional
// block-table gather, and the int8 pool's fused entry write, for Hopper
// sm_90a.
//
// Replaces: src/repro/kernels/quant.py:39 _quant_kernel (reached through
// _quantize_int8:73, pallas_call at :77) and :48 _dequant_kernel
// (_dequantize_int8:102, pallas_call at :106); the fused write computes
// the int8 pool write of src/repro/models/attention.py:378
// _quantized_block_write, which runs block_quant's row math (quant.py:52)
// in jnp.
//
// What bounds them on this card: each is one pass over memory with a
// handful of operations per byte (a max, a division and a rounding per
// element), so all three are bound by the bytes they must move.
//
// What the design does about it:
//  * quantize_rows (#10): one warp per row (two, four or eight warps for
//    rows of more than 1,024 values), eight warps a block; a row of more
//    than 8,192 values takes a block and is read twice.  A row is a
//    [bs, D] tile of one kv head, read in place from the [.., T, KV, D]
//    layout with its strides (the admission splice's (block, kv head)
//    tiles; a [nb, n] matrix is the case bs = 1, KV = 1), so the caller
//    never gathers the tiles into a copy.  A lane takes up to four pieces
//    of 8 values of one entry's D (16-byte loads of bf16, two of f32; D %
//    8 == 0), holds them in registers from the load to the store, so the
//    row is read once, and the row's max comes from xor shuffles (and,
//    for a row of several warps, one __syncthreads over a slot a warp).
//    Entries past T read as zero, which is the plain version's zero
//    padding of a short tail.  Then each element x / scale in IEEE f32
//    division, rintf (round half to even, as jnp.round) and a clip to
//    +-127, stored 8 bytes a piece.  K and V are the two rows of the
//    grid's y axis: one launch a splice layer.  The TPU kernel moved 64
//    rows of 256 through VMEM a grid step.
//  * dequantize_rows (#11): a thread takes 16 int8 values with one 16-byte
//    load (D % 16 == 0, so they lie in one (entry, kv head) row and share
//    one scale, found once from the chunk's index), multiplies them by the
//    scale in f32 and writes them, rounded once, in 16-byte stores.  With
//    a block table, row (b, m) is pool block table[b, m] and the output is
//    the contiguous [B, M*bs, KV, D] gather the int8 chunk append attends
//    over, cast to the activation dtype.  K and V are the two rows of the
//    grid's y axis: one launch per layer.  A first version ran a block a
//    row with 1-byte loads and a (i / D) % KV per element.
//  * quantized_block_write: the write's four phases (clear the scales of
//    blocks written at offset 0, grow each block's scale by the new
//    entries' max, requantize the block's payload by round(q * old / new),
//    write the entries) must each finish for a block before the next
//    starts, and the written blocks repeat: inactive rows all write the
//    trash block and a chunk's tokens share blocks.  One CUDA block owns
//    each distinct pool block (the first occurrence in touched = [write
//    blocks, cleared blocks]; later occurrences exit), so it runs the four
//    phases for that block in order with __syncthreads between them and no
//    other block touches its payload or scales.  A block is requantized
//    exactly once, and an entry written twice (only ever in the trash
//    block) takes the later row's value, as a sequential scatter does.
//    K and V are the two rows of the grid's y axis: one launch per layer.
//
// No fast math: the build has no -use_fast_math, so division is IEEE
// round-to-nearest and subnormal scales are kept, not flushed.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTrash = 1;  // TRASH_BLOCK: the junk-write sink

__device__ __forceinline__ int8_t quant1(float x, float safe) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / safe), -127.f), 127.f));
}

constexpr int kQWarps = 8;      // warps of a quantize_rows block
constexpr int kPieces = 4;      // pieces of 8 values a lane holds at most
constexpr int kPiece = 8;       // values of a piece

struct QuantLeaf {
  const void* x;  // n_outer rows of outer_stride elements
  int8_t* q;      // [n_outer, ncol * bs, KV, D]
  float* scale;   // [n_outer, ncol, KV]
};

// 8 values of x from 16 bytes (bf16) or 32 (f32), 16-byte aligned.
__device__ __forceinline__ void load8(float (&v)[kPiece], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[kPiece],
                                      const __nv_bfloat16* p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Row = (o, col, kv) of the leaf blockIdx.y -> the tile of bs entries
// col * bs + j (j < bs), kv head kv, of outer row o; W warps a row.
template <typename T, int W>
__global__ void __launch_bounds__(kQWarps * 32, 4)
quantize_rows_kernel(QuantLeaf k, QuantLeaf v, long long rows,
                     long long outer_stride, int ncol, int bs, int KV, int D,
                     int T_valid) {
  __shared__ float red[kQWarps];
  const QuantLeaf L = blockIdx.y == 0 ? k : v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kQWarps / W) + warp / W;
  const int part = warp % W;  // this warp's share of the row
  const bool live = row < rows;
  const int kv = static_cast<int>(row % KV);
  const int col = static_cast<int>((row / KV) % ncol);
  const long long o = row / (static_cast<long long>(KV) * ncol);
  const int per_entry = D / kPiece;
  const int pieces = live ? bs * per_entry : 0;
  const T* xo = static_cast<const T*>(L.x) + o * outer_stride;
  int8_t* qo = L.q + o * static_cast<long long>(ncol) * bs * KV * D;

  float val[kPieces][kPiece];
  int at[kPieces];  // the piece's offset in x's and q's [T, KV, D] slab
  float m = 0.f;
#pragma unroll
  for (int u = 0; u < kPieces; ++u) {
    const int e = (u * W + part) * 32 + lane;  // the piece in the row
    const int j = e / per_entry;
    const int t = col * bs + j;
    at[u] = e < pieces ? (t * KV + kv) * D + (e - j * per_entry) * kPiece
                       : 0;
#pragma unroll
    for (int i = 0; i < kPiece; ++i) val[u][i] = 0.f;
    if (e < pieces && t < T_valid) load8(val[u], xo + at[u]);
#pragma unroll
    for (int i = 0; i < kPiece; ++i) m = fmaxf(m, fabsf(val[u][i]));
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    m = fmaxf(m, __shfl_xor_sync(~0u, m, o2));
  if constexpr (W > 1) {
    if (lane == 0) red[warp] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) m = fmaxf(m, red[warp - part + w]);
  }
  const float s = m / 127.f;
  const float safe = s > 0.f ? s : 1.f;
#pragma unroll
  for (int u = 0; u < kPieces; ++u) {
    const int e = (u * W + part) * 32 + lane;
    if (e >= pieces) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kPiece; ++i)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      quant1(val[u][i], safe))) << (8 * (i % 4));
    *reinterpret_cast<uint2*>(qo + at[u]) = make_uint2(w[0], w[1]);
  }
  if (live && part == 0 && lane == 0) L.scale[row] = s;
}

// A row of more than kQWarps * 32 * kPieces * kPiece values (8,192), too
// long for the registers: a block a row, which reads the row twice, once
// for its max and once for its write.  Same row layout as above.
template <typename T>
__global__ void __launch_bounds__(kQWarps * 32)
quantize_long_rows_kernel(QuantLeaf k, QuantLeaf v, long long outer_stride,
                          int ncol, int bs, int KV, int D, int T_valid) {
  __shared__ float red[kQWarps];
  const QuantLeaf L = blockIdx.y == 0 ? k : v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x;
  const int kv = static_cast<int>(row % KV);
  const int col = static_cast<int>((row / KV) % ncol);
  const long long o = row / (static_cast<long long>(KV) * ncol);
  const int per_entry = D / kPiece;
  const int pieces = bs * per_entry;
  const T* xo = static_cast<const T*>(L.x) + o * outer_stride;
  int8_t* qo = L.q + o * static_cast<long long>(ncol) * bs * KV * D;
  // piece e of the row into val (zeros past T); its offset in the slab
  auto piece = [&](int e, float (&val)[kPiece]) {
    const int j = e / per_entry;
    const int t = col * bs + j;
    const int at = (t * KV + kv) * D + (e - j * per_entry) * kPiece;
#pragma unroll
    for (int i = 0; i < kPiece; ++i) val[i] = 0.f;
    if (t < T_valid) load8(val, xo + at);
    return at;
  };
  float m = 0.f;
  for (int e = threadIdx.x; e < pieces; e += kQWarps * 32) {
    float val[kPiece];
    piece(e, val);
#pragma unroll
    for (int i = 0; i < kPiece; ++i) m = fmaxf(m, fabsf(val[i]));
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    m = fmaxf(m, __shfl_xor_sync(~0u, m, o2));
  if (lane == 0) red[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQWarps; ++w) m = fmaxf(m, red[w]);
  const float s = m / 127.f;
  const float safe = s > 0.f ? s : 1.f;
  for (int e = threadIdx.x; e < pieces; e += kQWarps * 32) {
    float val[kPiece];
    const int at = piece(e, val);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kPiece; ++i)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      quant1(val[i], safe))) << (8 * (i % 4));
    *reinterpret_cast<uint2*>(qo + at) = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) L.scale[row] = s;
}

// Sixteen values x * s, rounded once to OT, in 16-byte stores.
__device__ __forceinline__ void store16(float* dst, const int4& x, float s) {
  const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 o;
    o.x = static_cast<float>(static_cast<int8_t>(w[i])) * s;
    o.y = static_cast<float>(static_cast<int8_t>(w[i] >> 8)) * s;
    o.z = static_cast<float>(static_cast<int8_t>(w[i] >> 16)) * s;
    o.w = static_cast<float>(static_cast<int8_t>(w[i] >> 24)) * s;
    reinterpret_cast<float4*>(dst)[i] = o;
  }
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const int4& x,
                                        float s) {
  const int w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          static_cast<float>(static_cast<int8_t>(w[i] >> (16 * k))) * s,
          static_cast<float>(static_cast<int8_t>(w[i] >> (16 * k + 8))) * s);
      o[2 * i + k] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

struct DequantLeaf {
  const int8_t* q;     // [N, bs, KV, D] int8 blocks
  const float* scale;  // [N, KV]
  void* out;           // [rows, bs * KV * D]
};

// Leaf blockIdx.y: row r reads block table[r] (r itself without a table);
// `chunks` 16-value pieces in all, `row_chunks` of them a row.
template <typename OT>
__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(DequantLeaf k, DequantLeaf v,
                       const int* __restrict__ table, long long chunks,
                       int row_chunks, int KV, int D) {
  const DequantLeaf L = blockIdx.y == 0 ? k : v;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (c >= chunks) return;
  const long long r = c / row_chunks;
  const int w = static_cast<int>(c - r * row_chunks);  // chunk in the row
  const long long blk = table != nullptr ? table[r] : r;
  const float s = L.scale[blk * KV + (w * 16 / D) % KV];
  const int4 x = __ldg(reinterpret_cast<const int4*>(L.q) +
                       blk * row_chunks + w);
  store16(static_cast<OT*>(L.out) + c * 16, x, s);
}

struct Leaf {
  int8_t* pool;       // [N, bs, KV, D]
  float* scale;       // [N, KV]
  const void* fresh;  // [R, KV, D] new entries, f32 or bf16
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_write_kernel(Leaf k, Leaf v, const int* __restrict__ bids,
                   const int* __restrict__ off, int R, int bs, int KV,
                   int D) {
  extern __shared__ float smem[];  // grown[KV], ratio[KV]
  float* grown = smem;
  float* ratio = smem + KV;
  const Leaf L = blockIdx.y == 0 ? k : v;
  const T* fresh = static_cast<const T*>(L.fresh);
  // touched[j]: the write blocks, then the blocks each row clears (its
  // write block at offset 0, else the trash block)
  auto touched = [&](int j) {
    return j < R ? bids[j] : (off[j - R] == 0 ? bids[j - R] : kTrash);
  };
  const int j = blockIdx.x;
  const int b = touched(j);
  for (int i = 0; i < j; ++i)
    if (touched(i) == b) return;  // an earlier CUDA block owns b
  bool cleared = false;
  for (int i = R; i < 2 * R; ++i) cleared |= touched(i) == b;
  const long long tile = static_cast<long long>(KV) * D;
  // phases 1-2: the cleared or current scale, grown by the new entries'
  // max / 127 (one warp per kv head at a time)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < KV; h += blockDim.x >> 5) {
    const float old = cleared ? 0.f : L.scale[static_cast<long long>(b) * KV + h];
    float g = old;
    for (int r = 0; r < R; ++r) {
      if (bids[r] != b) continue;
      float m = 0.f;
      for (int d = lane; d < D; d += 32)
        m = fmaxf(m, fabsf(to_f32(fresh[r * tile + h * D + d])));
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
      g = fmaxf(g, m / 127.f);
    }
    if (lane == 0) {
      grown[h] = g;
      ratio[h] = old / (g > 0.f ? g : 1.f);
    }
  }
  __syncthreads();
  if (threadIdx.x < KV)
    L.scale[static_cast<long long>(b) * KV + threadIdx.x] = grown[threadIdx.x];
  // phase 3: requantize the block's payload once (a ratio of exactly 1
  // leaves it as it is)
  int8_t* blk = L.pool + static_cast<long long>(b) * bs * tile;
  const long long n = bs * tile;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const float rt = ratio[(i / D) % KV];
    if (rt != 1.f)
      blk[i] = static_cast<int8_t>(rintf(static_cast<float>(blk[i]) * rt));
  }
  __syncthreads();
  // phase 4: the entries, in row order (a repeated (block, offset) takes
  // the later row's value); each thread writes the same elements of every
  // row, so program order is the write order
  for (int r = 0; r < R; ++r) {
    if (bids[r] != b) continue;
    int8_t* dst = blk + static_cast<long long>(off[r]) * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const float g = grown[i / D];
      dst[i] = quant1(to_f32(fresh[r * tile + i]), g > 0.f ? g : 1.f);
    }
  }
}

template <typename T, int W>
cudaError_t launch_quant(QuantLeaf k, QuantLeaf v, int nleaves,
                         long long rows, long long outer_stride, int ncol,
                         int bs, int KV, int D, int T_valid,
                         cudaStream_t s) {
  const long long blocks = (rows + kQWarps / W - 1) / (kQWarps / W);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_rows_kernel<T, W>
      <<<dim3(static_cast<unsigned>(blocks), nleaves), kQWarps * 32, 0, s>>>(
          k, v, rows, outer_stride, ncol, bs, KV, D, T_valid);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quant(QuantLeaf k, QuantLeaf v, int nleaves,
                           long long rows, long long outer_stride, int ncol,
                           int bs, int KV, int D, int T_valid,
                           cudaStream_t s) {
  const int pieces = bs * D / kPiece;  // a warp holds 32 * kPieces
  if (pieces <= 32 * kPieces)
    return launch_quant<T, 1>(k, v, nleaves, rows, outer_stride, ncol, bs,
                              KV, D, T_valid, s);
  if (pieces <= 2 * 32 * kPieces)
    return launch_quant<T, 2>(k, v, nleaves, rows, outer_stride, ncol, bs,
                              KV, D, T_valid, s);
  if (pieces <= 4 * 32 * kPieces)
    return launch_quant<T, 4>(k, v, nleaves, rows, outer_stride, ncol, bs,
                              KV, D, T_valid, s);
  if (pieces <= kQWarps * 32 * kPieces)
    return launch_quant<T, 8>(k, v, nleaves, rows, outer_stride, ncol, bs,
                              KV, D, T_valid, s);
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_long_rows_kernel<T>
      <<<dim3(static_cast<unsigned>(rows), nleaves), kQWarps * 32, 0, s>>>(
          k, v, outer_stride, ncol, bs, KV, D, T_valid);
  return cudaGetLastError();
}

}  // namespace

// For one or two leaves (K, V; nleaves 1 leaves the second set unused):
// x [n_outer, outer_stride] elements, each row of x a [T, KV, D] slab of
// which the first T_valid entries are read; dtype 0 = f32, 1 = bf16.
// q: [n_outer, ncol * bs, KV, D] int8; scale: [n_outer, ncol, KV] f32.
// D % 8 == 0, outer_stride and ncol * bs * KV * D below 2^31, x 16-byte
// aligned.
extern "C" int repro_quantize_rows(const void* k_x, void* k_q, void* k_scale,
                                   const void* v_x, void* v_q, void* v_scale,
                                   int nleaves, long long n_outer,
                                   long long outer_stride, int ncol, int bs,
                                   int KV, int D, int T_valid, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = n_outer * ncol * KV;
  if (rows <= 0 || D <= 0 || D % kPiece || bs <= 0 ||
      static_cast<long long>(ncol) * bs * KV * D > 0x7fffffffLL ||
      outer_stride > 0x7fffffffLL ||
      nleaves < 1 || nleaves > 2)
    return cudaErrorInvalidValue;
  const QuantLeaf k{k_x, static_cast<int8_t*>(k_q),
                    static_cast<float*>(k_scale)};
  const QuantLeaf v{v_x, static_cast<int8_t*>(v_q),
                    static_cast<float*>(v_scale)};
  if (dtype == kF32)
    return dispatch_quant<float>(k, v, nleaves, rows, outer_stride, ncol, bs,
                                 KV, D, T_valid, s);
  if (dtype == kBF16)
    return dispatch_quant<__nv_bfloat16>(k, v, nleaves, rows, outer_stride,
                                         ncol, bs, KV, D, T_valid, s);
  return cudaErrorInvalidValue;
}

// For one or two leaves (K, V; nleaves 1 leaves the second set unused):
// q [N, bs, KV, D] int8, scale [N, KV] f32, out [rows, bs, KV, D] in
// dtype; table: [rows] int32 block ids or null (row r reads block r).
// D % 16 == 0; q and out 16-byte aligned.
extern "C" int repro_dequantize_rows(const void* k_q, const void* k_scale,
                                     void* k_out, const void* v_q,
                                     const void* v_scale, void* v_out,
                                     const void* table, int nleaves,
                                     long long rows, int bs, int KV, int D,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_chunks = bs * KV * D / 16;
  const long long chunks = rows * row_chunks;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (rows <= 0 || D % 16 || row_chunks <= 0 || nleaves < 1 ||
      nleaves > 2 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const DequantLeaf k{static_cast<const int8_t*>(k_q),
                      static_cast<const float*>(k_scale), k_out};
  const DequantLeaf v{static_cast<const int8_t*>(v_q),
                      static_cast<const float*>(v_scale), v_out};
  const dim3 grid(static_cast<unsigned>(blocks), nleaves);
  const int* tb = static_cast<const int*>(table);
  if (dtype == kF32)
    dequantize_rows_kernel<float><<<grid, kThreads, 0, s>>>(
        k, v, tb, chunks, row_chunks, KV, D);
  else if (dtype == kBF16)
    dequantize_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        k, v, tb, chunks, row_chunks, KV, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// pools: [N, bs, KV, D] int8 and scales [N, KV] f32 of one or two leaves
// (K, V; nleaves 1 leaves the second set unused); fresh: [R, KV, D] new
// entries in dtype; bids/off: [R] int32 write blocks and offsets.
extern "C" int repro_quantized_block_write(
    void* k_pool, void* k_scale, const void* k_new, void* v_pool,
    void* v_scale, const void* v_new, const void* bids, const void* off,
    int nleaves, int R, int bs, int KV, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || nleaves < 1 || nleaves > 2 || KV > kThreads)
    return cudaErrorInvalidValue;
  Leaf k{static_cast<int8_t*>(k_pool), static_cast<float*>(k_scale), k_new};
  Leaf v{static_cast<int8_t*>(v_pool), static_cast<float*>(v_scale), v_new};
  dim3 grid(2 * R, nleaves);
  const size_t smem = 2 * KV * sizeof(float);
  const int* bi = static_cast<const int*>(bids);
  const int* of = static_cast<const int*>(off);
  if (dtype == kF32)
    block_write_kernel<float><<<grid, kThreads, smem, s>>>(k, v, bi, of, R,
                                                           bs, KV, D);
  else if (dtype == kBF16)
    block_write_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        k, v, bi, of, R, bs, KV, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
