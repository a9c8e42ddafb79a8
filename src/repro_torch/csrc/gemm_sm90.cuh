// Tensor-core mainloop for Hopper (sm_90a), shared by the bf16 routes of
// the fused SwiGLU FFN (csrc/fused_ffn.cu, csrc/fused_ffn_bwd.cu).
//
// One block owns a [BM, BN] output tile (BM = 64 rows per consumer
// warpgroup, one or two of them) and walks K in 64-deep tiles.  The flash
// attention forward (csrc/flash_attention.cu) uses its device helpers and
// the register-A form of wgmma below.  A producer
// warp keeps a ring of kStages stages in shared memory filled with TMA
// loads (cp.async.bulk.tensor, 128-byte swizzle, completion counted in
// bytes on one mbarrier per stage); the consumer warpgroups run
// wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate in registers) on each
// stage as it lands and hand it back on a second mbarrier.  Warps 0..4*CW-1
// are the consumers (a warpgroup starts at a warp index that is a multiple
// of 4) and warp 4*CW the producer, so a block of 288 threads leaves each
// thread up to 224 registers without setmaxnreg (160 threads, two blocks
// an SM: 204).
//
// A stage holds NA A tiles [BM, 64] (row-major operands read K-major, or,
// for a Kind with kAMnMajor, the transpose of a row-major [K, M] operand:
// xᵀ and dyᵀ in the weight gradients, loaded as BM/64 boxes of [64 k][64 m]
// and read by wgmma with its transpose-A bit) and NP B tiles, one per product: product q accumulates A[a_of(q)]·B[q] into
// its own registers, so products that share A (x·Wg and x·Wu) read their A
// tile once.  A B operand is MN-major (a row-major [K, N] weight read as it
// is: Wg, Wu, Wd in the forward), loaded as BN/64 boxes of [64 k][64 n],
// or K-major (a row-major [N, K] weight read transposed: Wdᵀ, Wgᵀ, Wuᵀ in
// the backward), loaded as one [BN n][64 k] box; wgmma reads both from
// shared memory.  A problem of NSEG segments concatenates K: dx =
// dg·Wgᵀ + du·Wuᵀ is one product over K = 2F.  K may be split across
// blocks (gridDim.z), which then write f32 partials for
// ffn_reduce_kernel to add in split order.  TMA fills rows and columns
// past the edge with zeros, so ragged N and K need no masking in the
// mainloop; the epilogues mask their stores.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so no -lcuda
#include <cuda_bf16.h>

#include "common.cuh"

namespace tc {

constexpr int kBK = 64;             // K per stage: one 128-byte bf16 row
constexpr int kMaxStages = 5;
constexpr int kSmemBlock = 232448;  // a block's shared memory on sm_90
constexpr int kSmemSM = 233472;     // an SM's, 1 KB of it reserved a block
constexpr int kSmemSlack = 1024 + 256;  // 1024-byte alignment, barriers

struct Params {
  CUtensorMap a[2][2];  // [segment][A operand]
  CUtensorMap b[2][3];  // [segment][product]
  void* out0;
  void* out1;
  void* out2;
  float* ws;            // [splits, M, ncols] f32 partials (split K only)
  int M, ncols;         // output rows, columns (= its row stride)
  int kt_seg;           // 64-deep K tiles per segment
  int kt_split;         // K tiles per split
};

// K::kAMnMajor where a Kind defines it, else false (A read K-major).
template <class K, class = void>
struct AMnMajor {
  static constexpr bool value = false;
};
template <class K>
struct AMnMajor<K, decltype(void(K::kAMnMajor))> {
  static constexpr bool value = K::kAMnMajor;
};

// One consumer warpgroup (64-row tiles: decode, small N) runs two blocks
// to an SM, so that one block's epilogue and ramp overlap the other's
// loads; two consumer warpgroups run one.
template <class K, int CW, int BN>
struct Cfg {
  static constexpr int BM = 64 * CW;
  static constexpr int kThreads = 128 * CW + 32;
  static constexpr int kBlocksPerSM = CW == 1 ? 2 : 1;
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = K::NA * kABytes + K::NP * kBBytes;
  static constexpr int kBudget =
      (kSmemSM / kBlocksPerSM - 1024 < kSmemBlock
           ? kSmemSM / kBlocksPerSM - 1024
           : kSmemBlock) - kSmemSlack;
  static constexpr int kFit = kBudget / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "stage does not fit twice in shared memory");
};

// -- device helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 4-D TMA load of the box at (c0 innermost .. c3) into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64, n] (+)= A[64, 16]·B[16, n], both from shared memory: A K-major
// (TA 0) or MN-major (TA 1), B K-major (TB 0) or MN-major (TB 1); D is
// overwritten where scale_d is 0.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64, n] += A[64, 16]·B[16, n] with A in registers (four bf16 pairs a
// thread, in the accumulator's layout: see for_each_pair) and B MN-major
// from shared memory: the flash forward's P·V.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN, int TA = 0>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a,
                                    uint64_t b, bool mn_major) {
  if constexpr (BN == 128) {
    if (mn_major) wgmma_n128<TA, 1>(d, a, b, 1);
    else wgmma_n128<TA, 0>(d, a, b, 1);
  } else {
    static_assert(BN == 64, "BN is 64 or 128");
    if (mn_major) wgmma_n64<TA, 1>(d, a, b, 1);
    else wgmma_n64<TA, 0>(d, a, b, 1);
  }
}

// The m64nBN accumulator of a warpgroup: thread l (0..127) holds, in
// registers i and i + 1 (i = 4j + 2h), row 16*(l/32) + (l%32)/4 + 8h and
// columns 8j + 2*(l%4) + {0, 1}.  fn(i, row, col) for each such pair, with
// row0 / col0 the warpgroup's first row and the tile's first column.
template <int BN, class Fn>
__device__ __forceinline__ void for_each_pair(int row0, int col0, Fn fn) {
  const int l = threadIdx.x % 128;
  const int r = row0 + 16 * (l / 32) + (l % 32) / 4, c = col0 + 2 * (l % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) fn(4 * j + 2 * h, r + 8 * h, c + 8 * j);
  }
}

// The block's dynamic shared memory from its first 1024-byte boundary: the
// stages of run(), which an epilogue may reuse once every consumer
// warpgroup has passed a bar_sync over all of them.
__device__ __forceinline__ uint8_t* stage_memory() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t at = smem_u32(smem_raw);
  return smem_raw + (((at + 1023u) & ~1023u) - at);
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void store_bf16x2(void* base, int64_t at, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                     at) = __floats2bfloat162_rn(a, b);
}

// The block's mainloop and its Kind's epilogue.  Kind: NA, NP, NSEG;
// a_of(q), mn_major(q); epilogue<BN>(p, acc, row0, col0, split).
template <class K, int CW, int BN>
__device__ __forceinline__ void run(const Params& p) {
  using C = Cfg<K, CW, BN>;
  constexpr int S = C::kStages;
  __shared__ __align__(8) uint64_t full[S], empty[S];
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem_u32(full), empty0 = smem_u32(empty);

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * p.kt_split;
  const int t1 = min(t0 + p.kt_split, K::NSEG * p.kt_seg);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CW) {  // the producer: one thread issues every load
    if (tid % 32 == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = t0; t < t1; ++t) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, C::kStageBytes);
        const int seg = t / p.kt_seg, k0 = (t - seg * p.kt_seg) * kBK;
        const uint32_t st = base + s * C::kStageBytes;
#pragma unroll
        for (int i = 0; i < K::NA; ++i) {
          if constexpr (AMnMajor<K>::value) {
#pragma unroll
            for (int j = 0; j < CW; ++j)
              tma_load(st + i * C::kABytes + j * 64 * kBK * 2, &p.a[seg][i],
                       bar, m0 + 64 * j, k0);
          } else {
            tma_load(st + i * C::kABytes, &p.a[seg][i], bar, k0, m0);
          }
        }
#pragma unroll
        for (int q = 0; q < K::NP; ++q) {
          const uint32_t dst = st + K::NA * C::kABytes + q * C::kBBytes;
          if (K::mn_major(q)) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(dst + j * 64 * kBK * 2, &p.b[seg][q], bar,
                       n0 + 64 * j, k0);
          } else {
            tma_load(dst, &p.b[seg][q], bar, k0, n0);
          }
        }
        if (++s == S) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[K::NP][BN / 2];
#pragma unroll
  for (int q = 0; q < K::NP; ++q)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[q][i] = 0.f;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int t = t0; t < t1; ++t) {
    mbar_wait(full0 + 8 * s, ph);
    const uint32_t st = base + s * C::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < K::NP; ++q) {
        // A K-major: rows of 128 bytes, 8-row groups 1024 bytes apart; k16
        // steps 32 bytes along the swizzled row.  MN-major: the warpgroup's
        // [64 k][64 m] box, k16 steps 16 rows = 2 KB, as MN-major B.
        const uint32_t aq =
            st + K::a_of(q) * C::kABytes + wg * 64 * kBK * 2;
        const uint64_t da =
            AMnMajor<K>::value ? desc(aq + kk * 16 * 128, 64 * kBK * 2, 1024)
                               : desc(aq + kk * 32, 16, 1024);
        const uint32_t bq = st + K::NA * C::kABytes + q * C::kBBytes;
        // B MN-major: 64-wide n chunks 8 KB apart (LBO), 8-row k groups
        // 1024 bytes apart (SBO), k16 steps 16 rows = 2 KB; K-major as A
        const uint64_t db =
            K::mn_major(q) ? desc(bq + kk * 16 * 128, 64 * kBK * 2, 1024)
                           : desc(bq + kk * 32, 16, 1024);
        mma<BN, AMnMajor<K>::value>(acc[q], da, db, K::mn_major(q));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (t > t0) mbar_arrive(empty0 + 8 * prev);
    prev = s;
    if (++s == S) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  K::template epilogue<BN>(p, acc, m0 + 64 * wg, n0, blockIdx.z);
}

// out = A·B (NSEG segments concatenated along K): bf16 [M, ncols] in out0,
// or with K split the f32 partial of split z in ws[z].
template <int NSEG_>
struct Linear {
  static constexpr int NA = 1, NP = 1, NSEG = NSEG_;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr bool mn_major(int) {
    return NSEG_ == 1;  // forward: Wd [F, D] as it is; dx: Wgᵀ, Wuᵀ
  }
  template <int BN>
  __device__ static void epilogue(const Params& p, float (&acc)[1][BN / 2],
                                  int row0, int col0, int split) {
    const bool partial = gridDim.z > 1;
    for_each_pair<BN>(row0, col0, [&](int i, int r, int c) {
      if (r >= p.M || c >= p.ncols) return;
      const int64_t at = static_cast<int64_t>(r) * p.ncols + c;
      if (partial)
        *reinterpret_cast<float2*>(
            p.ws + static_cast<int64_t>(split) * p.M * p.ncols + at) =
            make_float2(acc[0][i], acc[0][i + 1]);
      else
        store_bf16x2(p.out0, at, acc[0][i], acc[0][i + 1]);
    });
  }
};

// -- host helpers ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map of a row-major bf16 [rows, cols] tensor read in boxes of
// [box_rows, 64 columns], 128-byte swizzle, zeros past the edges.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows,
                            int cols, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || cols % 8)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A operand [M, K]: boxes of [BM rows, 64]; or, MN-major, the transpose
// of a row-major [K, M] tensor in [64 k, 64 m] boxes.
template <int CW>
cudaError_t map_a(CUtensorMap* map, const void* ptr, int M, int K,
                  bool mn_major = false) {
  return mn_major ? make_map(map, ptr, K, M, kBK)
                  : make_map(map, ptr, M, K, 64 * CW);
}

// B operand: MN-major [K, N] in [64 k, 64 n] boxes, or K-major [N, K] in
// [BN n, 64 k] boxes.
template <int BN>
cudaError_t map_b(CUtensorMap* map, const void* ptr, bool mn_major, int K,
                  int N) {
  return mn_major ? make_map(map, ptr, K, N, kBK)
                  : make_map(map, ptr, N, K, BN);
}

template <class K, int CW, int BN>
cudaError_t launch(void (*kern)(Params), const Params& p, int splits,
                   cudaStream_t stream) {
  using C = Cfg<K, CW, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + C::BM - 1) / C::BM, (p.ncols + BN - 1) / BN,
                  splits);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// out[i] = sum over splits of ws[s][i], in split order (the f32 forward's
// split F and the bf16 kernels' split K).
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ ws,
                                  T* __restrict__ out, int64_t n, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T>
cudaError_t launch_reduce(const float* ws, void* out, int64_t n, int splits,
                          cudaStream_t stream) {
  const int blocks = (int)std::min<int64_t>((n + 255) / 256, 1024);
  ffn_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, static_cast<T*>(out),
                                                   n, splits);
  return cudaGetLastError();
}
