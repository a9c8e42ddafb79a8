// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:67 _attn_kernel (reached
// through _forward:112, pallas_call at :120).
//
// What bounds it on this card: at prefill lengths the work is the two
// [S,T]x[T,D] products, O(S*T*D) operations against O((S+T)*D) bytes, so
// it is bound by operations, which only the tensor cores (wgmma, 989
// TFLOP/s in bf16 against 67 TFLOP/s of f32 FMAs) come near.
//
// What the design does about it.  bf16 at head dims 64 and 128 (every
// model path on the card) runs flash_fwd_tc_kernel: one block per (64-row
// q tile, head, batch), one consumer warpgroup and one producer warp, two
// blocks an SM (a causal prefill block walks only a few K/V tiles, so one
// block's loads and epilogue overlap the other's products).  The producer
// TMA-loads the block's Q tile once and streams K/V tiles (128 keys at D
// 64, 64 at D 128) through a ring of shared-memory stages (4-D tensor maps
// over (D, rows, heads, batch) with the tensors' own strides, so the
// model's [B,S,H,D] views are read as they lie; 128-byte swizzle;
// mbarriers, as gemm_sm90.cuh; the pieces the backward shares are in
// flash_tc.cuh).  The consumer warpgroup computes S = Q·Kᵀ
// on wgmma (Q and K both K-major from shared memory, f32 accumulators in
// registers), runs the online softmax on those registers (the row max and
// sum over the four threads that share a row; the scale applied once, to
// s − m before ex2), casts P to bf16 in place (the m64 accumulator's layout
// is wgmma's register-A layout, so P never touches shared memory) and adds
// P·V with the register-A form of wgmma (V an MN-major B, row-major
// [keys, D] as it lies).  Blocks run the heaviest (last) q tiles first.
// The TPU grid ran the q tiles in order with VMEM scratch; here the tiles
// are independent blocks and the KV walk is a loop inside the block.
//
// f32, and bf16 at head dims 16, 32 and 256, run the first SIMT version
// (flash_fwd_kernel): f32 FMAs, one block per (batch, head, 64-row q tile),
// K/V in 64-key tiles in shared memory, a 4x4 score tile and a 4x(D/16)
// output tile per thread.
//
// Both skip the tiles past the causal diagonal and before the sliding
// window (the TPU kernel's fori_loop bounds) and follow its numerics: the
// scale D^-0.5 applied in f32 (to q in the SIMT kernel, to the f32 scores
// in the tensor-core one), masked scores -1e30, l clamped at 1e-30,
// lse = m + log(l) and 0 where l == 0.  Keys past T are excluded outright
// (p = 0), rows past S are not stored.  The tensor-core kernel rounds p to
// bf16 for P·V (as the reference's plain attention does) and sums l from
// the f32 p.

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"

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
  // bf16 at head dims 64 and 128 is the tensor-core kernel's
  constexpr bool simt_mid = std::is_same<T, float>::value;
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
    case 64:
      if constexpr (simt_mid)
        return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
      break;
    case 128:
      if constexpr (simt_mid)
        return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
      break;
    case 256: return launch<T, 256>(q, k, v, o, lse, B, H, Hkv, S, Tk, st, causal, window, s);
  }
  return cudaErrorInvalidValue;
}


// -- bf16 on the tensor cores -------------------------------------------------

namespace fa_tc {

// One consumer warpgroup a block and two blocks an SM: one block's Q load,
// first K/V tiles and epilogue overlap the other's products (a causal
// prefill block walks only a few K/V tiles).
constexpr int kCW = 1;                // consumer warpgroups
constexpr int kBQ = 64 * kCW;         // q rows a block
constexpr int kThreads = 128 * kCW + 32;
constexpr int kBlocksPerSM = 2;
using flash_tc::exp2_approx;
using flash_tc::kLog2e;

template <int D>
struct Tile {
  static constexpr int BK = D == 64 ? 128 : 64;   // keys a stage
  static constexpr int DC = D / 64;                // 64-wide column chunks
  static constexpr int kChunk = flash_tc::kChunk;  // one Q box [64 rows][64]
  static constexpr int kKBytes = BK * D * 2;       // K (and V) of a stage
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kStageBytes = 2 * kKBytes;
  // as many stages (up to 3) as two blocks' shared memory holds
  static constexpr int kBudget =
      tc::kSmemSM / kBlocksPerSM - 1024 - tc::kSmemSlack - kQBytes;
  static constexpr int kStages =
      kBudget / kStageBytes < 3 ? kBudget / kStageBytes : 3;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "two K/V stages do not fit");
};

struct Params {
  CUtensorMap q, k, v;  // (D, rows, heads, batch), boxes (64, 64 | BK, 1, 1)
  __nv_bfloat16* o;
  float* lse;
  int64_t osb, osh, oss;
  int B, H, group, S, T, n_qt, causal, window;
  float scale;  // D^-0.5
};

template <int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_fwd_tc_kernel(const __grid_constant__ Params p) {
  using Tl = Tile<D>;
  constexpr int BK = Tl::BK, DC = Tl::DC, kStages = Tl::kStages;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qfull;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + Tl::kQBytes;
  const uint32_t full0 = tc::smem_u32(full), empty0 = tc::smem_u32(empty);
  const uint32_t qbar = tc::smem_u32(&qfull);

  const int tid = threadIdx.x, warp = tid / 32;
  const int bh = blockIdx.x % (p.B * p.H);
  const int q0 = (p.n_qt - 1 - static_cast<int>(blockIdx.x) / (p.B * p.H)) *
                 kBQ;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;

  // KV tiles this q tile can see: from the window's first tile to the
  // diagonal's last (all of T without a causal mask)
  const int n_tiles = (p.T + BK - 1) / BK;
  int t_begin = 0, t_end = n_tiles;
  if (p.causal) {
    t_end = min(n_tiles, min(q0 + kBQ - 1, p.S - 1) / BK + 1);
    if (p.window > 0) t_begin = max(0, q0 - p.window + 1) / BK;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full0 + 8 * s, 1);
      tc::mbar_init(empty0 + 8 * s, 128 * kCW);
    }
    tc::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kCW) {  // the producer: one thread issues every load
    if (tid % 32 == 0) {
      tc::mbar_expect_tx(qbar, Tl::kQBytes);
#pragma unroll
      for (int w = 0; w < kCW; ++w)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tc::tma_load_4d(qs + (w * DC + c) * Tl::kChunk, &p.q, qbar, 64 * c,
                          q0 + 64 * w, h, b);
      int s = 0;
      uint32_t ph = 0;
      for (int t = t_begin; t < t_end; ++t) {
        tc::mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s;
        tc::mbar_expect_tx(bar, Tl::kStageBytes);
        const uint32_t st = ks + s * Tl::kStageBytes;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tc::tma_load_4d(st + c * BK * 128, &p.k, bar, 64 * c, t * BK, hk,
                          b);
          tc::tma_load_4d(st + Tl::kKBytes + c * BK * 128, &p.v, bar, 64 * c,
                          t * BK, hk, b);
        }
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows q0 + 64 wg + [0, 64); thread l holds rows
  // r and r + 8 of the m64 fragments (see tc::for_each_pair)
  const int wg = warp / 4, l = tid % 128;
  const int r = q0 + 64 * wg + 16 * (l / 32) + (l % 32) / 4;
  const int c0 = 2 * (l % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};

  tc::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int t = t_begin; t < t_end; ++t) {
    tc::mbar_wait(full0 + 8 * s, ph);
    const uint32_t st = ks + s * Tl::kStageBytes;
    float sc[BK / 2];  // raw scores q·k
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      flash_tc::mma_kk<BK>(
          sc, tc::desc(qs + (wg * DC + c) * Tl::kChunk + off, 16, 1024),
          tc::desc(st + c * BK * 128 + off, 16, 1024));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();

    // the softmax on the raw scores: max first (the scale is positive),
    // then p = 2^((s − m)·c) with c = D^-0.5·log2(e); masked raw scores
    // are -1e30 / D^-0.5, i.e. -1e30 scaled, and s − m is exactly 0 where
    // a row's scores are all masked (an FMA s·c − m·c would keep the
    // rounding of m·c there, ~1e23)
    const int k0 = t * BK;
    const float c = p.scale * kLog2e, neg = REPRO_NEG_INF / p.scale;
    const bool masked =
        k0 + BK > p.T ||
        (p.causal && (k0 + BK - 1 > q0 ||
                      (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window)));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qp = r + 8 * hh;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e, kp = k0 + 8 * j + c0 + e;
          if (masked) {
            if (kp >= p.T)
              sc[i] = -INFINITY;
            else if (p.causal &&
                     (kp > qp || (p.window > 0 && kp <= qp - p.window)))
              sc[i] = neg;
          }
          mx = fmaxf(mx, sc[i]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float corr = exp2_approx((m[hh] - m_new) * c);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          sc[i] = exp2_approx((sc[i] - m_new) * c);
          rs += sc[i];
        }
      }
      lsum[hh] = lsum[hh] * corr + rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * hh] *= corr;
        o[4 * j + 2 * hh + 1] *= corr;
      }
    }

    // P in bf16 as wgmma's register A
    uint32_t pa[BK / 16][4];
    flash_tc::to_a<BK>(pa, sc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // V MN-major: 64-wide D chunks BK*128 bytes apart (LBO), 8-key groups
      // 1024 bytes apart (SBO), k16 steps 16 keys = 2 KB
      flash_tc::mma_rs<D>(o, pa[kk], tc::desc(st + Tl::kKBytes + kk * 2048,
                                              BK * 128, 1024));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::mbar_arrive(empty0 + 8 * s);
    if (++s == kStages) { s = 0; ph ^= 1; }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = lsum[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qp = r + 8 * hh;
    if (qp >= p.S) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = p.o + b * p.osb + h * p.osh + qp * p.oss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      tc::store_bf16x2(orow, 8 * j + c0, o[4 * j + 2 * hh] * inv,
                       o[4 * j + 2 * hh + 1] * inv);
    if (l % 4 == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.S + qp] =
          lt > 0.f ? m[hh] * p.scale + logf(fmaxf(lt, 1e-30f)) : 0.f;
  }
}

using flash_tc::map_4d;

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int S, int T,
                   const int64_t* st, int causal, int window,
                   cudaStream_t stream) {
  using Tl = Tile<D>;
  Params p{};
  cudaError_t err;
  if ((err = map_4d(&p.q, q, B, H, S, D, st[0], st[1], st[2], 64)) !=
      cudaSuccess)
    return err;
  if ((err = map_4d(&p.k, k, B, Hkv, T, D, st[3], st[4], st[5], Tl::BK)) !=
      cudaSuccess)
    return err;
  if ((err = map_4d(&p.v, v, B, Hkv, T, D, st[6], st[7], st[8], Tl::BK)) !=
      cudaSuccess)
    return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.osb = st[9];
  p.osh = st[10];
  p.oss = st[11];
  p.B = B;
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.T = T;
  p.n_qt = (S + kBQ - 1) / kBQ;
  p.causal = causal;
  p.window = window;
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  auto kern = flash_fwd_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tl::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<p.n_qt * B * H, kThreads, Tl::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fa_tc

}  // namespace

// SIMT: f32 at any head dim, bf16 at 16, 32 and 256 (64 and 128 are
// repro_flash_attention_fwd_tc's).  strides: q(b,h,s) k(b,h,t) v(b,h,t)
// o(b,h,s), in elements.
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

// bf16 on the tensor cores, head dim 64 or 128: as above; every stride a
// multiple of 8 elements (16 bytes) and q/k/v 16-byte aligned (TMA).
extern "C" int repro_flash_attention_fwd_tc(const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int B, int H, int Hkv,
                                            int S, int Tk, int D,
                                            const int64_t* strides,
                                            int causal, int window,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return fa_tc::launch<64>(q, k, v, o, lse, B, H, Hkv, S, Tk, strides,
                             causal, window, s);
  if (D == 128)
    return fa_tc::launch<128>(q, k, v, o, lse, B, H, Hkv, S, Tk, strides,
                              causal, window, s);
  return cudaErrorInvalidValue;
}
