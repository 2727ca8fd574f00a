// Pattern-sparse linear layer: y = act(x_c @ w_c + bias), f32, for sm_90a.
//
// Replaces the TPU kernel `matmul_compact_pallas` (body `_mm_kernel`) of
// src/repro/kernels/pattern_matmul/pattern_matmul.py.  As there, the
// static m-of-4 mask is applied outside the kernel: the wrapper
// (pattern_matmul/ops.py) gathers the kept activation lanes and the layer
// compacts its weight rows once, when it is built, so the kernel is a
// dense matmul over the shrunken contraction dimension Kc with the shared
// `act(acc + bias)` epilogue of kernels/epilogue.py fused in.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
//   * serving buckets (M = 2..16; vikin-mixed 72->304 relu and Kc=16 ->96,
//     vikin-mlp3 72->304 relu and Kc=228 ->96): the weight matrix is the
//     traffic (87.6 KB for 72x304 f32), 26 ns of memory time against
//     0.35 MFLOP (5 ns) at M=8.  What a call really costs is latency: the
//     launch, and every global-memory round trip the block waits for in
//     sequence.  The first design walked Kc in 16-deep slabs with one
//     round trip between two barriers each (about 1.55 us a slab on the
//     card) in a 64x64 tile that wasted 56 of 64 rows at M=8;
//   * M = 8192, vikin-mixed's 72->304 relu and 16->96: 16 MB moved
//     (4.8 us) against 387 MFLOP (5.8 us) -- operations bound.
// Design (CUDA cores only: no tensor cores, no TF32, the port holds IEEE
// f32 against the reference):
//   * launch-time tiles bm x bn x bk (the wrapper resolves them: explicit,
//     autotune cache, or a default by M bucket).  At serving buckets bm =
//     8 or 16 and bn = 8 put 38 blocks on N=304 instead of 5, so the
//     weight panel is fetched by 38 SMs, not 5;
//   * a ring of up to 16 bk-deep slabs in dynamic shared memory, filled
//     with cp.async: every slab the ring holds is requested before the
//     first is waited for, so a serving-size call (Kc <= 304) waits for
//     one latency, not one per slab; at large M the ring double-buffers;
//   * at least 128 threads a block: threads past the register tile's
//     (16 at an 8x8 tile) only stage slabs;
//   * 16-byte cp.async where a row allows it (rows of 72 and 228 floats
//     start 16-byte aligned), 4-byte cp.async on a ragged edge (Kc = 37);
//     x is staged K-contiguous with a 4-float pad, so neither the copies
//     nor the float4 operand reads conflict on banks; staging takes no
//     integer division a slab (staging.cuh, Walk);
//   * each thread keeps a TM x TN register tile (up to 8x8 on a 128x64
//     block); its rows are bm/TM apart and its columns float4 groups
//     bn/(TN/4) apart, so a warp's float4 operand reads either broadcast
//     or hit distinct banks, and its epilogue's float4 stores are runs of
//     contiguous 16-byte words.  A tile of 16 accumulators or fewer loads
//     the next 4-deep group's operands while it multiplies the current
//     one; the 8x4 tile is compiled for five 128-thread blocks an SM, so
//     the 640 tiles of M = 8192, N = 304 run in one wave.
// What still bounds it at M = 8192: each block loads, multiplies and
// stores in turn, and a one-wave grid runs those phases in lockstep, so
// they add up instead of overlapping; and every column tile reads its x
// rows again from L2 (ten times at bn = 32).
// The order of summation is part of the contract: each output is fmaf
// over k = 0..Kc-1 ascending, one term at a time, from 0, then
// __fadd_rn(acc, bias), then the activation.  It depends on nothing else:
// not M, not the tiles, not the cache.  So every knob gives bitwise the
// same output and a row does not depend on its batch (batched == single).
// Zero padding past Kc adds fmaf(0, 0, acc) == acc: the accumulator starts
// at +0 and round-to-nearest never makes it -0.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "staging.cuh"

namespace {

using pm::apply_act;
using pm::cp_async;
using pm::cp_async_commit;
using pm::cp_async_wait;
using pm::MAX_SMEM;
using pm::Walk;

constexpr int MAX_STAGES = 16;
constexpr int STAGE_BUDGET = 32 * 1024;   // bytes the ring aims to fill
constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 128;   // a block stages with at least these

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The operands of a 4-deep group of k for one thread's TM x TN tile:
// a[i] holds rows ty + i * ty_n at k..k+3, b[kk][g] columns
// g * gstride + tx * 4 .. + 3 at k + kk.
template <int TM, int TN>
struct Frag {
  static constexpr int NG = TN / 4;
  float4 a[TM];
  float4 b[4][NG];

  __device__ __forceinline__ void load(const float* As, const float* Bs,
                                       int k, int lda, int bn, int ty,
                                       int ty_n, int col, int gstride) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + i * ty_n) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        b[kk][g] = *reinterpret_cast<const float4*>(
            Bs + (k + kk) * bn + g * gstride + col);
  }

  // One fmaf a term, k ascending: acc[i][j] += a(k) * b(k) for k..k+3.
  __device__ __forceinline__ void fma(float (&acc)[TM][TN]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = lane4(a[i], kk);
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][g * 4 + jj] =
                fmaf(av, lane4(b[kk][g], jj), acc[i][g * 4 + jj]);
      }
  }
};

// Register tile per thread, by tile: pattern_matmul/ops.py
// (kernel_threads) mirrors these two rules.
constexpr int tile_m(int bm) { return bm >= 64 ? 8 : bm / 8; }
constexpr int tile_n(int bn) { return bn >= 64 ? 8 : 4; }

// Occupancy a register tile asks of the compiler: an 8x4 tile runs at
// 128 threads a block (bm = 128 or 64, bn = 32), and five blocks an SM
// take the 640 tiles of M = 8192, N = 304 in one wave; the rest are
// left to the compiler.
template <int TM, int TN>
struct Bounds {
  static constexpr int threads = TM * TN == 32 && TN == 4 ? 128 : MAX_THREADS;
  static constexpr int blocks = TM * TN == 32 && TN == 4 ? 5 : 1;
};

template <int TM, int TN>
__global__ void __launch_bounds__(Bounds<TM, TN>::threads,
                                  Bounds<TM, TN>::blocks)
pattern_matmul_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ y, int M, int K, int N, int act,
                      int bm, int bk, int bn, int stages, int vec_x,
                      int vec_w, int vec_y) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NG = TN / 4;          // float4 column groups a thread owns
  const int lda = bk + 4;             // x slab: [bm][bk + 4], k contiguous
  const int a_elems = bm * lda;
  const int slab = a_elems + bk * bn; // w slab: [bk][bn], n contiguous
  const int tx_n = bn / TN;
  const int ty_n = bm / TM;           // a thread's rows are ty_n apart
  const int gstride = bn / NG;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int tx = tid % tx_n;
  const int ty = tid / tx_n;
  // Threads past the tile's tx_n * ty_n only help to stage the slabs.
  const bool computes = ty < ty_n;
  const int row0 = blockIdx.x * bm;
  const int col0 = blockIdx.y * bn;
  const int nslabs = (K + bk - 1) / bk;

  const Walk walk_x(vec_x ? bk / 4 : bk, tid, nthreads);
  const Walk walk_w(vec_w ? bn / 4 : bn, tid, nthreads);
  // Copy slab s into ring stage st.
  auto load = [&](int s, int st) {
    float* As = smem + st * slab;
    float* Bs = As + a_elems;
    const int k0 = s * bk;
    if (vec_x) {
      walk_x.run(bm, [&](int m, int kq) {
        const int gm = row0 + m, gk = k0 + kq * 4;
        const bool ok = gm < M && gk < K;
        cp_async<16>(As + m * lda + kq * 4, ok ? x + (size_t)gm * K + gk : x,
                   ok);
      });
    } else {
      walk_x.run(bm, [&](int m, int k) {
        const int gm = row0 + m, gk = k0 + k;
        const bool ok = gm < M && gk < K;
        cp_async<4>(As + m * lda + k, ok ? x + (size_t)gm * K + gk : x, ok);
      });
    }
    if (vec_w) {
      walk_w.run(bk, [&](int k, int nq) {
        const int gk = k0 + k, gn = col0 + nq * 4;
        const bool ok = gk < K && gn < N;
        cp_async<16>(Bs + k * bn + nq * 4, ok ? w + (size_t)gk * N + gn : w,
                   ok);
      });
    } else {
      walk_w.run(bk, [&](int k, int n) {
        const int gk = k0 + k, gn = col0 + n;
        const bool ok = gk < K && gn < N;
        cp_async<4>(Bs + k * bn + n, ok ? w + (size_t)gk * N + gn : w, ok);
      });
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Prologue: request the first stages - 1 slabs before waiting for any.
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nslabs) load(s, s);
    cp_async_commit();
  }
  int st_use = 0, st_load = stages - 1;   // t % stages, (t - 1) % stages
  for (int t = 0; t < nslabs; ++t) {
    // Slab t + stages - 1 refills the stage slab t - 1 used; the barrier
    // that ended iteration t - 1 freed it.
    const int s = t + stages - 1;
    if (s < nslabs) load(s, st_load);
    cp_async_commit();
    cp_async_wait(stages - 1);        // slab t has landed (this thread's)
    __syncthreads();                  // ... and every other thread's
    const float* As = smem + st_use * slab;
    const float* Bs = As + a_elems;
    if (computes) {
      if (TM * TN <= 16) {
        // A small register tile has too few FMAs to hide shared-memory
        // latency (at M = 8 a few warps an SM): the next 4-deep group's
        // fragments load while the current one is multiplied.
        Frag<TM, TN> f0, f1;
        f0.load(As, Bs, 0, lda, bn, ty, ty_n, tx * 4, gstride);
        for (int k = 0; k < bk; k += 8) {
          const bool more = k + 4 < bk;
          if (more) f1.load(As, Bs, k + 4, lda, bn, ty, ty_n, tx * 4, gstride);
          f0.fma(acc);
          if (!more) break;
          if (k + 8 < bk)
            f0.load(As, Bs, k + 8, lda, bn, ty, ty_n, tx * 4, gstride);
          f1.fma(acc);
        }
      } else {
        // A large one has enough; a second set of fragments would cost
        // the registers that keep two blocks on an SM.
#pragma unroll 2
        for (int k = 0; k < bk; k += 4) {
          Frag<TM, TN> f;
          f.load(As, Bs, k, lda, bn, ty, ty_n, tx * 4, gstride);
          f.fma(acc);
        }
      }
    }
    // The next iteration refills this stage only if a slab is left for it.
    if (t + stages < nslabs) __syncthreads();
    st_load = st_use;
    st_use = st_use + 1 == stages ? 0 : st_use + 1;
  }

  // Epilogue, in bias_act's order: add the bias to the finished
  // accumulator, then the activation; float4 stores where the row allows.
  if (!computes) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + i * ty_n;
    if (gm >= M) continue;
    float* yrow = y + (size_t)gm * N;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int gn = col0 + g * gstride + tx * 4;
      if (gn >= N) continue;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        v[jj] = acc[i][g * 4 + jj];
        if (bias != nullptr && gn + jj < N)
          v[jj] = __fadd_rn(v[jj], bias[gn + jj]);
        v[jj] = apply_act(v[jj], act);
      }
      if (vec_y) {  // N % 4 == 0: the whole float4 lies inside the row
        *reinterpret_cast<float4*>(yrow + gn) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (gn + jj < N) yrow[gn + jj] = v[jj];
      }
    }
  }
}

template <int TM, int TN>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream,
                   const float* x, const float* w, const float* bias,
                   float* y, int M, int K, int N, int act, int bm, int bk,
                   int bn, int stages, int vec_x, int vec_w, int vec_y) {
  // Once per instantiation: allow dynamic shared memory above 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      pattern_matmul_kernel<TM, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  pattern_matmul_kernel<TM, TN><<<grid, threads, smem, stream>>>(
      x, w, bias, y, M, K, N, act, bm, bk, bn, stages, vec_x, vec_w, vec_y);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (M, K) row-major, w: (K, N) row-major, bias: (N,) or NULL,
// y: (M, N).  All f32, contiguous, on the stream's device.  Tiles:
// bm in {8, 16, 32, 64, 128}, bn in {8, 16, 32, 64, 128}, bk a multiple
// of 4; the ring holds min(ceil(K / bk), 16, max(2, 64 KB / slab)) slabs
// and must fit in 227 KB (pattern_matmul/ops.py kernel_smem mirrors this).
extern "C" int pattern_matmul_f32(const float* x, const float* w,
                                  const float* bias, float* y, int M, int K,
                                  int N, int act, int bm, int bk, int bn,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const bool bm_ok = bm == 8 || bm == 16 || bm == 32 || bm == 64 || bm == 128;
  const bool bn_ok = bn == 8 || bn == 16 || bn == 32 || bn == 64 || bn == 128;
  if (!bm_ok || !bn_ok || bk <= 0 || bk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int tm = tile_m(bm), tn = tile_n(bn);
  int threads = (bm / tm) * (bn / tn);
  if (threads < MIN_THREADS) threads = MIN_THREADS;
  const long long slab_bytes = 4LL * ((long long)bm * (bk + 4) + (long long)bk * bn);
  const int nslabs = (int)(((long long)K + bk - 1) / bk);
  long long fit = STAGE_BUDGET / slab_bytes;
  if (fit < 2) fit = 2;
  int stages = nslabs < 1 ? 1 : nslabs;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages > fit) stages = (int)fit;
  const long long smem = stages * slab_bytes;
  const long long gy = (N + bn - 1) / bn;
  if (smem > MAX_SMEM || threads > MAX_THREADS || gy > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + bm - 1) / bm, (unsigned)gy);
  const int vec_x = K % 4 == 0 && aligned16(x);
  const int vec_w = N % 4 == 0 && aligned16(w);
  const int vec_y = N % 4 == 0 && aligned16(y);
  cudaStream_t s = (cudaStream_t)stream;
#define PM_LAUNCH(TM_, TN_)                                                  \
  if (tm == TM_ && tn == TN_)                                                \
    return (int)launch<TM_, TN_>(grid, threads, (int)smem, s, x, w, bias, y, \
                                 M, K, N, act, bm, bk, bn, stages, vec_x,    \
                                 vec_w, vec_y);
  PM_LAUNCH(1, 4) PM_LAUNCH(1, 8) PM_LAUNCH(2, 4) PM_LAUNCH(2, 8)
  PM_LAUNCH(4, 4) PM_LAUNCH(4, 8) PM_LAUNCH(8, 4) PM_LAUNCH(8, 8)
#undef PM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
