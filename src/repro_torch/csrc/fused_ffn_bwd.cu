// Fused SwiGLU FFN backward for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/fused_ffn.py:108 _bwd_dx_kernel and :131
// _bwd_dw_kernel (both reached through _backward:159, pallas_calls at :164
// and :181; wired by the custom_vjp _swiglu_bwd:222).
//
// With g = x·Wg, u = x·Wu, σ = logistic(g), h = g·σ·u and dh = dy·Wdᵀ:
//   du = dh·g·σ,   dg = dh·u·(σ + g·σ·(1 − σ)),
//   dX = dg·Wgᵀ + du·Wuᵀ,  dWg = xᵀ·dg,  dWu = xᵀ·du,  dWd = hᵀ·dy.
//
// What bounds it on this card: at training row counts the products are
// O(N*D*F) operations against O((N+F)*D) bytes, so both are bound by
// operations (five [N,D]x[D,F]-sized products for dX, three for the weight
// grads once dg, du and h are at hand, run over both parts of their bf16
// pairs), which only the tensor cores
// (wgmma, 989 TFLOP/s in bf16 against 67 TFLOP/s of f32 FMAs) come near.
//
// What the design does about it, in bf16 (the training dtype): three
// launches over the tensor-core mainloop of gemm_sm90.cuh (TMA ring, wgmma,
// f32 accumulators in registers).
// (a) ffn_bwd_grad_tc_kernel: a [BM, 64] tile of F, three products over
//     K = D, g = x·Wg and u = x·Wu from one x tile and dh = dy·Wdᵀ (Wd read
//     K-major, as it lies); the epilogue computes dg, du and h = silu(g)·u
//     in f32 and stores them into row-major [N, F] scratch (the layout the
//     other two kernels read): dg and du rounded once to bf16 for dx; for
//     the weight grads, dg, du and h each as a bf16 pair (hi = the value
//     rounded to bf16, lo = the rest rounded to bf16, ~16 significant
//     bits), since with one rounding the N-term dW sums drift ~2^-9 of
//     their RMS from the f32 result, past the reference's elementwise
//     bound on their small entries.
// (b) ffn_bwd_dx_tc_kernel: dX = dg·Wgᵀ + du·Wuᵀ as one product over
//     K = 2F, both pairs accumulated in the same registers; when its output
//     tiles alone would leave SMs idle, K is split across blocks whose f32
//     partials ffn_reduce_kernel adds in split order.
// (c) ffn_bwd_dw_tc_kernel: a [BM, 64] tile of [D, F], three products over
//     K = 2N rows (the hi rows, then the lo rows, as two segments of K):
//     dWg = xᵀ·dg and dWu = xᵀ·du from one xᵀ tile, and dWdᵀ = dyᵀ·h,
//     stored transposed into dWd [F, D].  xᵀ and dyᵀ are row-major [N, D]
//     tensors read with K = N, i.e. MN-major A operands, which wgmma reads
//     from shared memory with its transpose bit; dg, du and h are MN-major
//     B.  With few output tiles (small D and F) the rows
//     are split across blocks whose f32 partials ffn_dw_reduce_kernel adds
//     in split order (deterministic, no atomics).
// The TPU kernels recomputed (g, u, dh) per F tile (dx) and per row tile
// (dW) and carried f32 accumulators in VMEM across the grid; at d_model
// 4096 such an accumulator alone is past a block's shared memory, so dg,
// du and h make one round trip through device memory instead (12·N·F bytes
// written, 16·N·F read, against 22·N·D·F operations).
//
// f32 stays on the first SIMT versions, kept for the f32 parity checks.
// * dX (ffn_bwd_dx_kernel): one block owns BR rows, staged once in shared
//   memory as f32, and walks F in 32-wide tiles: each lane one F column,
//   each warp BR/8 rows, it recomputes g, u and dh for the tile, parks dg
//   and du in shared memory and folds dg·Wgᵀ + du·Wuᵀ into an f32 [BR,D]
//   accumulator in shared memory.
// * dW (ffn_bwd_dw_kernel, f32 FMAs): one block owns a BF-wide tile of F
//   (BF <= 16, chosen so the three f32 weight-gradient tiles [D,BF],
//   [D,BF], [BF,D] fit in shared memory) and a range of rows, walked in
//   chunks: for each chunk it recomputes the (h, dg, du) tile into shared
//   memory (each thread one F column of two rows), then each thread takes
//   D columns and adds the chunk's xᵀ·dg, xᵀ·du and hᵀ·dy for them in
//   registers before adding them to the shared accumulators.  When the F
//   tiles alone would leave SMs idle, the rows are split across blocks
//   that write f32 partials to a [splits, 3, D*F] workspace, added in
//   order by ffn_dw_reduce_kernel.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBF = 32;        // dx kernel's F tile: one column per lane

__device__ __forceinline__ void swiglu_grads(float g, float u, float dh,
                                             float* h, float* dg, float* du) {
  const float sg = 1.f / (1.f + expf(-g));
  const float silu = g * sg;
  *h = silu * u;
  *du = dh * silu;
  *dg = dh * u * (sg + g * sg * (1.f - sg));
}

template <typename T, int BR>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, const T* __restrict__ wd,
                  const T* __restrict__ dy, T* __restrict__ dx, int N, int D,
                  int F) {
  constexpr int RPW = BR / 8;  // rows per warp
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [BR][D]
  float* acc = xs + BR * D;       // [BR][D]
  float* dgs = acc + BR * D;      // [BR][kBF]
  float* dus = dgs + BR * kBF;    // [BR][kBF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BR;
  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    xs[i] = row0 + r < N ? to_f32(x[(int64_t)(row0 + r) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kBF) {
    const int f = f0 + lane;
    float g[RPW], u[RPW], dh[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) g[i] = u[i] = dh[i] = 0.f;
    if (f < F) {
      const T* pg = wg + f;
      const T* pu = wu + f;
      const T* pd = wd + (int64_t)f * D;
      for (int d = 0; d < D; d += 4) {  // D % 4 == 0 (checked by the wrapper)
        float a[4], b[4], c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = to_f32(pg[(int64_t)(d + e) * F]);
          b[e] = to_f32(pu[(int64_t)(d + e) * F]);
          c[e] = to_f32(pd[d + e]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp * RPW + i;
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * D + d);
          float yv[4] = {0.f, 0.f, 0.f, 0.f};
          if (row0 + r < N) {
            const T* py = dy + (int64_t)(row0 + r) * D + d;
#pragma unroll
            for (int e = 0; e < 4; ++e) yv[e] = to_f32(py[e]);
          }
          g[i] = fmaf(xv.x, a[0], g[i]); u[i] = fmaf(xv.x, b[0], u[i]);
          g[i] = fmaf(xv.y, a[1], g[i]); u[i] = fmaf(xv.y, b[1], u[i]);
          g[i] = fmaf(xv.z, a[2], g[i]); u[i] = fmaf(xv.z, b[2], u[i]);
          g[i] = fmaf(xv.w, a[3], g[i]); u[i] = fmaf(xv.w, b[3], u[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i] = fmaf(yv[e], c[e], dh[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float h, dg = 0.f, du = 0.f;
      if (f < F) swiglu_grads(g[i], u[i], dh[i], &h, &dg, &du);
      dgs[(warp * RPW + i) * kBF + lane] = dg;
      dus[(warp * RPW + i) * kBF + lane] = du;
    }
    __syncthreads();

    // fold dg·Wgᵀ + du·Wuᵀ into the accumulator: thread -> columns d
    const int nf = min(kBF, F - f0);
    for (int d = tid; d < D; d += kThreads) {
      float a[kBF], b[kBF];
      const T* pg = wg + (int64_t)d * F + f0;
      const T* pu = wu + (int64_t)d * F + f0;
#pragma unroll
      for (int j = 0; j < kBF; ++j) {
        a[j] = j < nf ? to_f32(pg[j]) : 0.f;
        b[j] = j < nf ? to_f32(pu[j]) : 0.f;
      }
#pragma unroll 2
      for (int r = 0; r < BR; ++r) {
        const float4* g4 = reinterpret_cast<const float4*>(dgs + r * kBF);
        const float4* u4 = reinterpret_cast<const float4*>(dus + r * kBF);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kBF / 4; ++j) {
          const float4 gv = g4[j], uv = u4[j];
          s = fmaf(gv.x, a[4 * j], s);     s = fmaf(uv.x, b[4 * j], s);
          s = fmaf(gv.y, a[4 * j + 1], s); s = fmaf(uv.y, b[4 * j + 1], s);
          s = fmaf(gv.z, a[4 * j + 2], s); s = fmaf(uv.z, b[4 * j + 2], s);
          s = fmaf(gv.w, a[4 * j + 3], s); s = fmaf(uv.w, b[4 * j + 3], s);
        }
        acc[r * D + d] += s;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (row0 + r < N) dx[(int64_t)(row0 + r) * D + d] = from_f32<T>(acc[i]);
  }
}

// dw kernel: rows per chunk, so that each thread recomputes 2 rows x 1
// column of the [RC, BF] hidden tile.
template <int BF>
__host__ __device__ constexpr int rows_per_chunk() {
  return 2 * kThreads / BF;
}

template <typename T, int BF>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, const T* __restrict__ wd,
                  const T* __restrict__ dy, T* __restrict__ dwg,
                  T* __restrict__ dwu, T* __restrict__ dwd,
                  float* __restrict__ ws, int N, int D, int F,
                  int rows_per_split, int splits) {
  constexpr int RC = rows_per_chunk<BF>();
  extern __shared__ __align__(16) float smem[];
  float* ag = smem;               // dWg tile [D][BF]
  float* au = ag + D * BF;        // dWu tile [D][BF]
  float* ad = au + D * BF;        // dWd tile [BF][D]
  float* hs = ad + BF * D;        // [RC][BF]
  float* dgs = hs + RC * BF;      // [RC][BF]
  float* dus = dgs + RC * BF;     // [RC][BF]

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * BF;
  const int nf = min(BF, F - f0);
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  for (int i = tid; i < 3 * D * BF; i += kThreads) ag[i] = 0.f;

  // phase-1 role: column j of rows 2*rg, 2*rg + 1 of each chunk
  const int j = tid % BF, rg = tid / BF;
  const int f = f0 + j;

  for (int c0 = r_begin; c0 < r_end; c0 += RC) {
    __syncthreads();  // previous chunk's tiles consumed
    {
      float g[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, dh[2] = {0.f, 0.f};
      const int ra = c0 + 2 * rg;
      const bool ok0 = j < nf && ra < r_end, ok1 = j < nf && ra + 1 < r_end;
      if (ok0) {
        const T* x0 = x + (int64_t)ra * D;
        const T* y0 = dy + (int64_t)ra * D;
        const T* pd = wd + (int64_t)f * D;
        for (int d = 0; d < D; d += 4) {  // D % 4 == 0
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float a = to_f32(wg[(int64_t)(d + e) * F + f]);
            const float b = to_f32(wu[(int64_t)(d + e) * F + f]);
            const float c = to_f32(pd[d + e]);
            const float xv0 = to_f32(x0[d + e]), yv0 = to_f32(y0[d + e]);
            g[0] = fmaf(xv0, a, g[0]);
            u[0] = fmaf(xv0, b, u[0]);
            dh[0] = fmaf(yv0, c, dh[0]);
            if (ok1) {
              const float xv1 = to_f32(x0[D + d + e]);
              const float yv1 = to_f32(y0[D + d + e]);
              g[1] = fmaf(xv1, a, g[1]);
              u[1] = fmaf(xv1, b, u[1]);
              dh[1] = fmaf(yv1, c, dh[1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float h = 0.f, dg = 0.f, du = 0.f;
        if (i == 0 ? ok0 : ok1) swiglu_grads(g[i], u[i], dh[i], &h, &dg, &du);
        const int r = 2 * rg + i;
        hs[r * BF + j] = h;
        dgs[r * BF + j] = dg;
        dus[r * BF + j] = du;
      }
    }
    __syncthreads();

    // phase 2: thread -> column d of x/dy; the chunk's rows summed in
    // registers, then added to the shared accumulators
    const int nr = min(RC, r_end - c0);
    for (int d = tid; d < D; d += kThreads) {
      float sg[BF], su[BF], sd[BF];
#pragma unroll
      for (int t = 0; t < BF; ++t) sg[t] = su[t] = sd[t] = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float xv = to_f32(x[(int64_t)(c0 + r) * D + d]);
        const float yv = to_f32(dy[(int64_t)(c0 + r) * D + d]);
#pragma unroll
        for (int t = 0; t < BF; ++t) {
          sg[t] = fmaf(xv, dgs[r * BF + t], sg[t]);
          su[t] = fmaf(xv, dus[r * BF + t], su[t]);
          sd[t] = fmaf(hs[r * BF + t], yv, sd[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < BF; ++t) {
        ag[d * BF + t] += sg[t];
        au[d * BF + t] += su[t];
        ad[t * D + d] += sd[t];
      }
    }
  }
  __syncthreads();

  // write the tiles: dWg/dWu [D,F] columns f0.., dWd [F,D] rows f0..
  const int64_t DF = (int64_t)D * F;
  for (int i = tid; i < D * BF; i += kThreads) {
    const int d = i / BF, t = i % BF;
    if (t >= nf) continue;
    const int64_t gi = (int64_t)d * F + f0 + t;
    if (splits == 1) {
      dwg[gi] = from_f32<T>(ag[i]);
      dwu[gi] = from_f32<T>(au[i]);
    } else {
      ws[(int64_t)split * 3 * DF + gi] = ag[i];
      ws[(int64_t)split * 3 * DF + DF + gi] = au[i];
    }
  }
  for (int i = tid; i < BF * D; i += kThreads) {
    const int t = i / D, d = i % D;
    if (t >= nf) continue;
    const int64_t gi = (int64_t)(f0 + t) * D + d;
    if (splits == 1)
      dwd[gi] = from_f32<T>(ad[i]);
    else
      ws[(int64_t)split * 3 * DF + 2 * DF + gi] = ad[i];
  }
}

// The three weight gradients = the sum over splits of the workspace, in
// split order.
template <typename T>
__global__ void ffn_dw_reduce_kernel(const float* __restrict__ ws,
                                     T* __restrict__ dwg, T* __restrict__ dwu,
                                     T* __restrict__ dwd, int64_t DF,
                                     int splits) {
  const int64_t n = 3 * DF;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    T* out = i < DF ? dwg : (i < 2 * DF ? dwu : dwd);
    out[i % DF] = from_f32<T>(s);
  }
}

template <typename T, int BR>
cudaError_t launch_dx(const void* x, const void* wg, const void* wu,
                      const void* wd, const void* dy, void* dx, int N, int D,
                      int F, cudaStream_t stream) {
  auto kern = ffn_bwd_dx_kernel<T, BR>;
  const int smem = (2 * BR * D + 2 * BR * kBF) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + BR - 1) / BR, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<const T*>(dy), static_cast<T*>(dx), N, D, F);
  return cudaGetLastError();
}

template <typename T, int BF>
cudaError_t launch_dw(const void* x, const void* wg, const void* wu,
                      const void* wd, const void* dy, void* dwg, void* dwu,
                      void* dwd, float* ws, int N, int D, int F,
                      int rows_per_split, int splits, cudaStream_t stream) {
  auto kern = ffn_bwd_dw_kernel<T, BF>;
  constexpr int RC = rows_per_chunk<BF>();
  const int smem = (3 * D * BF + 3 * RC * BF) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((F + BF - 1) / BF, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<const T*>(dy), static_cast<T*>(dwg), static_cast<T*>(dwu),
      static_cast<T*>(dwd), ws, N, D, F, rows_per_split, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t DF = (int64_t)D * F;
  const int blocks = (int)std::min<int64_t>((3 * DF + 255) / 256, 2048);
  ffn_dw_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      ws, static_cast<T*>(dwg), static_cast<T*>(dwu), static_cast<T*>(dwd),
      DF, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dx(int br, const void* x, const void* wg, const void* wu,
                        const void* wd, const void* dy, void* dx, int N, int D,
                        int F, cudaStream_t s) {
  switch (br) {
    case 8: return launch_dx<T, 8>(x, wg, wu, wd, dy, dx, N, D, F, s);
    case 16: return launch_dx<T, 16>(x, wg, wu, wd, dy, dx, N, D, F, s);
    case 32: return launch_dx<T, 32>(x, wg, wu, wd, dy, dx, N, D, F, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dw(int bf, const void* x, const void* wg, const void* wu,
                        const void* wd, const void* dy, void* dwg, void* dwu,
                        void* dwd, float* ws, int N, int D, int F, int rps,
                        int splits, cudaStream_t s) {
  switch (bf) {
    case 1: return launch_dw<T, 1>(x, wg, wu, wd, dy, dwg, dwu, dwd, ws, N, D, F, rps, splits, s);
    case 2: return launch_dw<T, 2>(x, wg, wu, wd, dy, dwg, dwu, dwd, ws, N, D, F, rps, splits, s);
    case 4: return launch_dw<T, 4>(x, wg, wu, wd, dy, dwg, dwu, dwd, ws, N, D, F, rps, splits, s);
    case 8: return launch_dw<T, 8>(x, wg, wu, wd, dy, dwg, dwu, dwd, ws, N, D, F, rps, splits, s);
    case 16: return launch_dw<T, 16>(x, wg, wu, wd, dy, dwg, dwu, dwd, ws, N, D, F, rps, splits, s);
  }
  return cudaErrorInvalidValue;
}

// -- bf16 on the tensor cores ------------------------------------------------

// (a) from g = x·Wg, u = x·Wu, dh = dy·Wdᵀ: dg, du and h as bf16 (hi, lo)
// pairs [2, N, F] in out0, out1, out2 (hi = the f32 value rounded to bf16,
// lo = the rest rounded to bf16).  A warpgroup stages its six [64, BN]
// planes in shared memory (the mainloop's stages, free once every
// consumer warpgroup is past its last wgmma), rows kPitch apart so that
// the accumulator layout's 4-byte writes hit 32 banks, then stores whole
// rows in 16-byte pieces: straight from the accumulator layout, each
// store instruction would write 4 bytes into each of 8 rows.
struct Grad {
  static constexpr int NA = 2, NP = 3, NSEG = 1;
  template <int BN>
  static constexpr int kPitch = BN + 8;  // bf16 a staged row
  template <int BN>
  static constexpr int kStagedBytes = 6 * 64 * kPitch<BN> * 2;  // a warpgroup
  __host__ __device__ static constexpr int a_of(int q) { return q == 2; }
  __host__ __device__ static constexpr bool mn_major(int q) { return q < 2; }
  template <int BN>
  __device__ static void epilogue(const tc::Params& p,
                                  float (&acc)[3][BN / 2], int row0,
                                  int col0, int) {
    constexpr int P = kPitch<BN>, kPlane = 64 * P, kChunks = BN / 8;
    const int wg = threadIdx.x / 128;
    auto* st = reinterpret_cast<__nv_bfloat16*>(tc::stage_memory()) +
               wg * 6 * kPlane;
    tc::bar_sync(1, blockDim.x - 32);  // every consumer's wgmma is done
    tc::for_each_pair<BN>(0, 0, [&](int i, int r, int c) {
      float v[3][2];  // dg, du, h
#pragma unroll
      for (int e = 0; e < 2; ++e)
        swiglu_grads(acc[0][i + e], acc[1][i + e], acc[2][i + e], &v[2][e],
                     &v[0][e], &v[1][e]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[q][0], v[q][1]);
        const float2 hf = __bfloat1622float2(hi);
        auto* at = st + 2 * q * kPlane + r * P + c;
        *reinterpret_cast<__nv_bfloat162*>(at) = hi;
        *reinterpret_cast<__nv_bfloat162*>(at + kPlane) =
            __floats2bfloat162_rn(v[q][0] - hf.x, v[q][1] - hf.y);
      }
    });
    tc::bar_sync(2 + wg, 128);  // the warpgroup's planes are staged
    const int64_t plane = static_cast<int64_t>(p.M) * p.ncols;
#pragma unroll
    for (int pl = 0; pl < 6; ++pl) {
      auto* out = static_cast<__nv_bfloat16*>(
                      pl < 2 ? p.out0 : (pl < 4 ? p.out1 : p.out2)) +
                  (pl % 2) * plane;
      for (int k = threadIdx.x % 128; k < 64 * kChunks; k += 128) {
        const int r = k / kChunks, gr = row0 + r,
                  gc = col0 + 8 * (k % kChunks);
        if (gr >= p.M || gc >= p.ncols) continue;  // F % 8 == 0
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(gr) * p.ncols +
                                  gc) =
            *reinterpret_cast<const uint4*>(st + pl * kPlane + r * P +
                                            8 * (k % kChunks));
      }
    }
  }
};
using Dx = tc::Linear<2>;  // (b) dX = [dg | du]·[Wg | Wu]ᵀ over K = 2F
constexpr int kGradBN = 64;  // three accumulators of 64 columns

template <int CW>
__global__ void __launch_bounds__(tc::Cfg<Grad, CW, kGradBN>::kThreads,
                      tc::Cfg<Grad, CW, kGradBN>::kBlocksPerSM)
ffn_bwd_grad_tc_kernel(const __grid_constant__ tc::Params p) {
  using C = tc::Cfg<Grad, CW, kGradBN>;
  static_assert(CW * Grad::kStagedBytes<kGradBN> <=
                    C::kStages * C::kStageBytes,
                "the staged pairs do not fit the mainloop's stages");
  tc::run<Grad, CW, kGradBN>(p);
}

template <int CW>
__global__ void __launch_bounds__(tc::Cfg<Dx, CW, 128>::kThreads,
                      tc::Cfg<Dx, CW, 128>::kBlocksPerSM)
ffn_bwd_dx_tc_kernel(const __grid_constant__ tc::Params p) {
  tc::run<Dx, CW, 128>(p);
}

// (c) dWg, dWu bf16 [D, F] in out0, out1 and dWd bf16 [F, D] in out2, from
// xᵀ·dg, xᵀ·du and dyᵀ·h over K = N rows of the hi planes (segment 0) and
// N rows of the lo planes (segment 1): a [BM, 64] tile of [D, F] (M = D,
// ncols = F).  With K split, split z's f32 partials go to ws[z] as
// [3][D*F], the third in dWd's [F, D] order, for ffn_dw_reduce_kernel.
struct Dw {
  static constexpr int NA = 2, NP = 3, NSEG = 2;
  static constexpr bool kAMnMajor = true;
  __host__ __device__ static constexpr int a_of(int q) { return q == 2; }
  __host__ __device__ static constexpr bool mn_major(int) { return true; }
  template <int BN>
  __device__ static void epilogue(const tc::Params& p,
                                  float (&acc)[3][BN / 2], int row0,
                                  int col0, int split) {
    const int64_t MN = static_cast<int64_t>(p.M) * p.ncols;
    const bool partial = gridDim.z > 1;
    float* ws = p.ws + static_cast<int64_t>(split) * 3 * MN;
    tc::for_each_pair<BN>(row0, col0, [&](int i, int r, int c) {
      if (r >= p.M || c >= p.ncols) return;  // c + 1 < ncols: F % 8 == 0
      const int64_t at = static_cast<int64_t>(r) * p.ncols + c;
      const int64_t t0 = static_cast<int64_t>(c) * p.M + r, t1 = t0 + p.M;
      if (partial) {
        *reinterpret_cast<float2*>(ws + at) =
            make_float2(acc[0][i], acc[0][i + 1]);
        *reinterpret_cast<float2*>(ws + MN + at) =
            make_float2(acc[1][i], acc[1][i + 1]);
        ws[2 * MN + t0] = acc[2][i];
        ws[2 * MN + t1] = acc[2][i + 1];
      } else {
        tc::store_bf16x2(p.out0, at, acc[0][i], acc[0][i + 1]);
        tc::store_bf16x2(p.out1, at, acc[1][i], acc[1][i + 1]);
        auto* dwd = static_cast<__nv_bfloat16*>(p.out2);
        dwd[t0] = __float2bfloat16(acc[2][i]);
        dwd[t1] = __float2bfloat16(acc[2][i + 1]);
      }
    });
  }
};
constexpr int kDwBN = 64;  // three accumulators of 64 columns

template <int CW>
__global__ void __launch_bounds__(tc::Cfg<Dw, CW, kDwBN>::kThreads,
                      tc::Cfg<Dw, CW, kDwBN>::kBlocksPerSM)
ffn_bwd_dw_tc_kernel(const __grid_constant__ tc::Params p) {
  tc::run<Dw, CW, kDwBN>(p);
}

template <int CW>
cudaError_t launch_grad_tc(const void* x, const void* wg, const void* wu,
                           const void* wd, const void* dy, void* dg,
                           void* du, void* h, int N, int D, int F,
                           cudaStream_t stream) {
  cudaError_t err;
  tc::Params p{};
  p.out0 = dg;
  p.out1 = du;
  p.out2 = h;
  p.M = N;
  p.ncols = F;
  p.kt_seg = (D + tc::kBK - 1) / tc::kBK;
  p.kt_split = p.kt_seg;
  if ((err = tc::map_a<CW>(&p.a[0][0], x, N, D)) != cudaSuccess) return err;
  if ((err = tc::map_a<CW>(&p.a[0][1], dy, N, D)) != cudaSuccess) return err;
  if ((err = tc::map_b<kGradBN>(&p.b[0][0], wg, true, D, F)) != cudaSuccess)
    return err;
  if ((err = tc::map_b<kGradBN>(&p.b[0][1], wu, true, D, F)) != cudaSuccess)
    return err;
  // Wd [F, D] is dh's B read K-major: [N = F, K = D]
  if ((err = tc::map_b<kGradBN>(&p.b[0][2], wd, false, D, F)) != cudaSuccess)
    return err;
  return tc::launch<Grad, CW, kGradBN>(ffn_bwd_grad_tc_kernel<CW>, p, 1,
                                       stream);
}

template <int CW>
cudaError_t launch_dx_tc(const void* wg, const void* wu, const void* dg,
                         const void* du, void* dx, float* ws, int N, int D,
                         int F, int splits, int kt_split,
                         cudaStream_t stream) {
  cudaError_t err;
  tc::Params q{};
  q.out0 = dx;
  q.ws = ws;
  q.M = N;
  q.ncols = D;
  q.kt_seg = (F + tc::kBK - 1) / tc::kBK;
  q.kt_split = kt_split;
  // segment 0: dg·Wgᵀ, segment 1: du·Wuᵀ; Wg/Wu [D, F] read K-major
  if ((err = tc::map_a<CW>(&q.a[0][0], dg, N, F)) != cudaSuccess) return err;
  if ((err = tc::map_a<CW>(&q.a[1][0], du, N, F)) != cudaSuccess) return err;
  if ((err = tc::map_b<128>(&q.b[0][0], wg, false, F, D)) != cudaSuccess)
    return err;
  if ((err = tc::map_b<128>(&q.b[1][0], wu, false, F, D)) != cudaSuccess)
    return err;
  err = tc::launch<Dx, CW, 128>(ffn_bwd_dx_tc_kernel<CW>, q, splits, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<__nv_bfloat16>(ws, dx, (int64_t)N * D, splits,
                                      stream);
}

template <int CW>
cudaError_t launch_dw_tc(const void* x, const void* dy, const void* dg,
                         const void* du, const void* h, void* dwg, void* dwu,
                         void* dwd, float* ws, int N, int D, int F,
                         int splits, int kt_split, cudaStream_t stream) {
  cudaError_t err;
  tc::Params p{};
  p.out0 = dwg;
  p.out1 = dwu;
  p.out2 = dwd;
  p.ws = ws;
  p.M = D;
  p.ncols = F;
  p.kt_seg = (N + tc::kBK - 1) / tc::kBK;
  p.kt_split = kt_split;
  const int64_t plane = (int64_t)N * F;
  const void* bs[3] = {dg, du, h};
  for (int seg = 0; seg < 2; ++seg) {
    // A: xᵀ and dyᵀ, the row-major [N, D] tensors read MN-major
    if ((err = tc::map_a<CW>(&p.a[seg][0], x, D, N, true)) != cudaSuccess)
      return err;
    if ((err = tc::map_a<CW>(&p.a[seg][1], dy, D, N, true)) != cudaSuccess)
      return err;
    // B: plane seg (hi, lo) of the dg, du, h pairs, [N, F] MN-major
    for (int q = 0; q < 3; ++q)
      if ((err = tc::map_b<kDwBN>(
               &p.b[seg][q],
               static_cast<const __nv_bfloat16*>(bs[q]) + seg * plane, true,
               N, F)) != cudaSuccess)
        return err;
  }
  err = tc::launch<Dw, CW, kDwBN>(ffn_bwd_dw_tc_kernel<CW>, p, splits,
                                  stream);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t DF = (int64_t)D * F;
  const int blocks = (int)std::min<int64_t>((3 * DF + 255) / 256, 2048);
  ffn_dw_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
      ws, static_cast<__nv_bfloat16*>(dwg), static_cast<__nv_bfloat16*>(dwu),
      static_cast<__nv_bfloat16*>(dwd), DF, splits);
  return cudaGetLastError();
}

}  // namespace

// f32 (SIMT): x, dy, dx [N,D]; wg/wu [D,F]; wd [F,D]; all contiguous.  br
// rows per block (8, 16 or 32).
extern "C" int repro_swiglu_ffn_bwd_dx(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       const void* dy, void* dx, int N, int D,
                                       int F, int br, void* stream) {
  return dispatch_dx<float>(br, x, wg, wu, wd, dy, dx, N, D, F,
                            static_cast<cudaStream_t>(stream));
}

// bf16 (tensor cores), (a): x, dy [N,D]; wg/wu [D,F]; wd [F,D] -> dg, du,
// h bf16 (hi, lo) pairs [2,N,F].  cw consumer warpgroups a block (64 rows
// each).  All pointers 16-byte aligned, D and F multiples of 8.
extern "C" int repro_swiglu_ffn_bwd_grad_tc(const void* x, const void* wg,
                                            const void* wu, const void* wd,
                                            const void* dy, void* dg,
                                            void* du, void* h, int N, int D,
                                            int F, int cw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cw == 1)
    return launch_grad_tc<1>(x, wg, wu, wd, dy, dg, du, h, N, D, F, s);
  if (cw == 2)
    return launch_grad_tc<2>(x, wg, wu, wd, dy, dg, du, h, N, D, F, s);
  return cudaErrorInvalidValue;
}

// bf16, (b): dx [N,D] from dg, du [N,F] (the pairs' hi planes) and wg/wu
// [D,F]; the dx kernel's K (2F, in 64-deep tiles, F's tiles for dg then
// for du) split into `splits` ranges of kt_split tiles, with ws
// [splits,N,D] f32 when splits > 1.
extern "C" int repro_swiglu_ffn_bwd_dx_tc(const void* wg, const void* wu,
                                          const void* dg, const void* du,
                                          void* dx, float* ws, int N, int D,
                                          int F, int cw, int splits,
                                          int kt_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cw == 1)
    return launch_dx_tc<1>(wg, wu, dg, du, dx, ws, N, D, F, splits, kt_split,
                           s);
  if (cw == 2)
    return launch_dx_tc<2>(wg, wu, dg, du, dx, ws, N, D, F, splits, kt_split,
                           s);
  return cudaErrorInvalidValue;
}

// bf16, (c): dwg/dwu [D,F] and dwd [F,D] from x, dy [N,D] and the dg, du,
// h pairs [2,N,F]; cw consumer warpgroups a block (64 rows of D each);
// K (2N: the hi rows' 64-row tiles, then the lo rows') split into
// `splits` ranges of kt_split tiles, with ws [splits,3,D*F] f32 when
// splits > 1.
extern "C" int repro_swiglu_ffn_bwd_dw_tc(const void* x, const void* dy,
                                          const void* dg, const void* du,
                                          const void* h, void* dwg,
                                          void* dwu, void* dwd, float* ws,
                                          int N, int D, int F, int cw,
                                          int splits, int kt_split,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cw == 1)
    return launch_dw_tc<1>(x, dy, dg, du, h, dwg, dwu, dwd, ws, N, D, F,
                           splits, kt_split, s);
  if (cw == 2)
    return launch_dw_tc<2>(x, dy, dg, du, h, dwg, dwu, dwd, ws, N, D, F,
                           splits, kt_split, s);
  return cudaErrorInvalidValue;
}

// f32 (SIMT): dwg/dwu [D,F], dwd [F,D], contiguous; bf the F tile (1-16, a
// power of two); rows_per_split a multiple of the chunk 512/bf; ws f32
// [splits, 3, D*F] (unused when splits == 1).
extern "C" int repro_swiglu_ffn_bwd_dw(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       const void* dy, void* dwg, void* dwu,
                                       void* dwd, float* ws, int N, int D,
                                       int F, int bf, int rows_per_split,
                                       int splits, void* stream) {
  return dispatch_dw<float>(bf, x, wg, wu, wd, dy, dwg, dwu, dwd, ws, N, D, F,
                            rows_per_split, splits,
                            static_cast<cudaStream_t>(stream));
}
