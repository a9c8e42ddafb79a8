// Fused SwiGLU FFN forward for Hopper, sm_90a:
//   y = (silu(x·Wg) ⊙ x·Wu)·Wd,   x [N,D], Wg/Wu [D,F], Wd [F,D].
//
// Replaces: src/repro/kernels/fused_ffn.py:50 _ffn_kernel (reached through
// _forward:71, pallas_call at :74).
//
// What bounds it on this card: at prefill (N in the thousands) the three
// products are O(N*D*F) operations against O((N+F)*D) bytes, so it is bound
// by operations, and only the tensor cores (wgmma, 989 TFLOP/s in bf16
// against 67 TFLOP/s of f32 FMAs) come near that bound; at decode
// (N = num_slots, 16) every weight byte is used N times only, so it is
// bound by the bytes of Wg, Wu and Wd.
//
// What the design does about it.  bf16, the serving and training dtype,
// runs on the tensor cores in two launches over the mainloop of
// gemm_sm90.cuh (TMA ring, wgmma, f32 accumulators in registers):
// (a) ffn_gate_up_tc_kernel: a [BM, BN] tile of the hidden, two products
//     g = x·Wg and u = x·Wu over K = D from one x tile a stage; the
//     epilogue stores h = silu(g)·u, rounded once to bf16, into an [N, F]
//     scratch.  The TPU kernel kept each hidden tile in VMEM and carried an
//     f32 [br, D] accumulator across the F grid; at d_model 4096 a 64-row
//     f32 accumulator is 1 MB, past a block's 227 KB, so the hidden makes
//     one round trip through device memory instead (2·N·F bytes, small
//     against the 6·N·D·F operations at prefill).
// (b) ffn_down_tc_kernel: y = h·Wd over K = F.  When the output tiles alone
//     would leave SMs idle (decode), K is split across blocks that write
//     f32 partials, added in split order by ffn_reduce_kernel
//     (deterministic, no atomics), so that enough blocks stream Wd.
// Blocks walk the row tiles fastest, so the blocks in flight share weight
// tiles through L2 and each weight byte comes from device memory about
// once.
//
// f32 stays on the first SIMT version (ffn_fwd_kernel), kept for the f32
// parity checks: one block owns BR rows (32, 16, 8, or 4 where D is wide)
// and a range of F.  The [BR,D] rows are staged once in shared memory as
// f32 and reused by every F tile; for each 32-wide F tile the block
// computes the [BR,32] hidden tile silu(g)·u (each lane one column, each
// warp BR/8 rows), parks it in shared memory and folds it into an f32
// [BR,D] accumulator that also lives in shared memory, so the [N,F] hidden
// never reaches device memory.  When there are too few row tiles to fill
// the card (decode), F is split across blocks: each split writes an f32
// [N,D] partial to a [splits,N,D] workspace and ffn_reduce_kernel adds the
// splits in order.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBF = 32;        // F tile: one column per lane

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

template <typename T, int BR>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ wd,
               T* __restrict__ out, float* __restrict__ ws, int N, int D,
               int F, int f_per_split, int splits) {
  // hidden rows per warp; below 8 rows (wide D: jamba's 4096 takes BR 4)
  // only the first BR warps compute hidden rows, one each
  constexpr int RPW = BR >= 8 ? BR / 8 : 1;
  constexpr int kHiddenWarps = BR / RPW;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [BR][D]
  float* acc = xs + BR * D;     // [BR][D]
  float* hs = acc + BR * D;     // [BR][kBF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BR;
  const int split = blockIdx.y;
  const int f_begin = split * f_per_split;
  const int f_end = min(F, f_begin + f_per_split);

  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    xs[i] = row0 + r < N ? to_f32(x[(int64_t)(row0 + r) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  __syncthreads();

  for (int f0 = f_begin; f0 < f_end; f0 += kBF) {
    // hidden tile: lane -> column f0 + lane, warp -> rows warp*RPW + i
    const int f = f0 + lane;
    float g[RPW], u[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) g[i] = u[i] = 0.f;
    if (warp < kHiddenWarps && f < f_end) {
      const T* pg = wg + f;
      const T* pu = wu + f;
      for (int d = 0; d < D; d += 4) {  // D % 4 == 0 (checked by the wrapper)
        float a[4], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = to_f32(pg[(int64_t)(d + e) * F]);
          b[e] = to_f32(pu[(int64_t)(d + e) * F]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (warp * RPW + i) * D + d);
          g[i] = fmaf(xv.x, a[0], g[i]); u[i] = fmaf(xv.x, b[0], u[i]);
          g[i] = fmaf(xv.y, a[1], g[i]); u[i] = fmaf(xv.y, b[1], u[i]);
          g[i] = fmaf(xv.z, a[2], g[i]); u[i] = fmaf(xv.z, b[2], u[i]);
          g[i] = fmaf(xv.w, a[3], g[i]); u[i] = fmaf(xv.w, b[3], u[i]);
        }
      }
    }
    if (warp < kHiddenWarps) {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        hs[(warp * RPW + i) * kBF + lane] =
            f < f_end ? silu(g[i]) * u[i] : 0.f;
    }
    __syncthreads();

    // fold the hidden tile into the accumulator: thread -> columns d
    const int nf = min(kBF, f_end - f0);
    for (int d = tid; d < D; d += kThreads) {
      float w[kBF];
#pragma unroll
      for (int j = 0; j < kBF; ++j)
        w[j] = j < nf ? to_f32(wd[(int64_t)(f0 + j) * D + d]) : 0.f;
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {
        const float4* h4 = reinterpret_cast<const float4*>(hs + r * kBF);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kBF / 4; ++j) {
          const float4 h = h4[j];
          s = fmaf(h.x, w[4 * j], s);
          s = fmaf(h.y, w[4 * j + 1], s);
          s = fmaf(h.z, w[4 * j + 2], s);
          s = fmaf(h.w, w[4 * j + 3], s);
        }
        acc[r * D + d] += s;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (row0 + r >= N) continue;
    if (splits == 1)
      out[(int64_t)(row0 + r) * D + d] = from_f32<T>(acc[i]);
    else
      ws[((int64_t)split * N + row0 + r) * D + d] = acc[i];
  }
}

template <typename T, int BR>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* out, float* ws, int N, int D, int F,
                   int f_per_split, int splits, cudaStream_t stream) {
  auto kern = ffn_fwd_kernel<T, BR>;
  const int smem = (2 * BR * D + BR * kBF) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BR - 1) / BR, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), ws, N, D, F, f_per_split, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(ws, out, (int64_t)N * D, splits, stream);
}

template <typename T>
cudaError_t dispatch_br(int br, const void* x, const void* wg, const void* wu,
                        const void* wd, void* out, float* ws, int N, int D,
                        int F, int fps, int splits, cudaStream_t s) {
  switch (br) {
    case 4: return launch<T, 4>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
    case 8: return launch<T, 8>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
    case 16: return launch<T, 16>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
    case 32: return launch<T, 32>(x, wg, wu, wd, out, ws, N, D, F, fps, splits, s);
  }
  return cudaErrorInvalidValue;
}

// -- bf16 on the tensor cores -------------------------------------------------

// (a) h = silu(x·Wg) ⊙ x·Wu, bf16 [N, F] in out0.
struct GateUp {
  static constexpr int NA = 1, NP = 2, NSEG = 1;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr bool mn_major(int) { return true; }
  template <int BN>
  __device__ static void epilogue(const tc::Params& p,
                                  float (&acc)[2][BN / 2], int row0,
                                  int col0, int) {
    tc::for_each_pair<BN>(row0, col0, [&](int i, int r, int c) {
      if (r >= p.M || c >= p.ncols) return;
      tc::store_bf16x2(p.out0, static_cast<int64_t>(r) * p.ncols + c,
                       silu(acc[0][i]) * acc[1][i],
                       silu(acc[0][i + 1]) * acc[1][i + 1]);
    });
  }
};
using Down = tc::Linear<1>;  // (b) y = h·Wd

template <int CW, int BN>
__global__ void __launch_bounds__(tc::Cfg<GateUp, CW, BN>::kThreads,
                      tc::Cfg<GateUp, CW, BN>::kBlocksPerSM)
ffn_gate_up_tc_kernel(const __grid_constant__ tc::Params p) {
  tc::run<GateUp, CW, BN>(p);
}

template <int CW>
__global__ void __launch_bounds__(tc::Cfg<Down, CW, 128>::kThreads,
                      tc::Cfg<Down, CW, 128>::kBlocksPerSM)
ffn_down_tc_kernel(const __grid_constant__ tc::Params p) {
  tc::run<Down, CW, 128>(p);
}

template <int CW>
cudaError_t launch_tc(const void* x, const void* wg, const void* wu,
                      const void* wd, void* h, void* out, float* ws, int N,
                      int D, int F, int bn_gate_up, int splits,
                      int kt_split, cudaStream_t stream) {
  cudaError_t err;
  tc::Params p{};
  p.out0 = h;
  p.M = N;
  p.ncols = F;
  p.kt_seg = (D + tc::kBK - 1) / tc::kBK;
  p.kt_split = p.kt_seg;
  if ((err = tc::map_a<CW>(&p.a[0][0], x, N, D)) != cudaSuccess) return err;
  // Wg, Wu [D, F] are MN-major B: the map's box does not depend on BN
  if ((err = tc::map_b<64>(&p.b[0][0], wg, true, D, F)) != cudaSuccess)
    return err;
  if ((err = tc::map_b<64>(&p.b[0][1], wu, true, D, F)) != cudaSuccess)
    return err;
  err = bn_gate_up == 128
            ? tc::launch<GateUp, CW, 128>(ffn_gate_up_tc_kernel<CW, 128>, p,
                                          1, stream)
            : tc::launch<GateUp, CW, 64>(ffn_gate_up_tc_kernel<CW, 64>, p, 1,
                                         stream);
  if (err != cudaSuccess) return err;

  tc::Params q{};
  q.out0 = out;
  q.ws = ws;
  q.M = N;
  q.ncols = D;
  q.kt_seg = (F + tc::kBK - 1) / tc::kBK;
  q.kt_split = kt_split;
  if ((err = tc::map_a<CW>(&q.a[0][0], h, N, F)) != cudaSuccess) return err;
  if ((err = tc::map_b<128>(&q.b[0][0], wd, true, F, D)) != cudaSuccess)
    return err;
  err = tc::launch<Down, CW, 128>(ffn_down_tc_kernel<CW>, q, splits, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<__nv_bfloat16>(ws, out, (int64_t)N * D, splits,
                                      stream);
}

}  // namespace

// f32 (SIMT): x [N,D], wg/wu [D,F], wd [F,D], out [N,D], all contiguous;
// ws [splits,N,D] f32 (unused when splits == 1).  br rows per block,
// f_per_split a multiple of 32.
extern "C" int repro_swiglu_ffn_fwd(const void* x, const void* wg,
                                    const void* wu, const void* wd, void* out,
                                    float* ws, int N, int D, int F, int br,
                                    int f_per_split, int splits,
                                    void* stream) {
  return dispatch_br<float>(br, x, wg, wu, wd, out, ws, N, D, F, f_per_split,
                            splits, static_cast<cudaStream_t>(stream));
}

// bf16 (tensor cores): as above, with h [N,F] bf16 scratch and, when
// splits > 1, ws [splits,N,D] f32.  cw consumer warpgroups a block (64
// rows each), bn_gate_up the gate/up kernel's F tile (64 or 128); the down
// kernel's K (= F, in 64-deep tiles) split into `splits` ranges of
// kt_split tiles.  All pointers 16-byte aligned, D and F multiples of 8.
extern "C" int repro_swiglu_ffn_fwd_tc(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       void* h, void* out, float* ws, int N,
                                       int D, int F, int cw, int bn_gate_up,
                                       int splits, int kt_split,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn_gate_up != 64 && bn_gate_up != 128) return cudaErrorInvalidValue;
  if (cw == 1)
    return launch_tc<1>(x, wg, wu, wd, h, out, ws, N, D, F, bn_gate_up,
                        splits, kt_split, s);
  if (cw == 2)
    return launch_tc<2>(x, wg, wu, wd, h, out, ws, N, D, F, bn_gate_up,
                        splits, kt_split, s);
  return cudaErrorInvalidValue;
}
