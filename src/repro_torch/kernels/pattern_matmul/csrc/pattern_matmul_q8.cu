// Int8 pattern-sparse matmul: y = x_q @ w_q, int32 accumulate, f32 out,
// for sm_90a.
//
// Replaces the TPU kernel `matmul_q8_pallas` (body `_mm_kernel_q8`) of
// src/repro/kernels/pattern_matmul/pattern_matmul.py.  As there, the
// static m-of-4 mask is applied outside the kernel (the int8 lane gather
// in pattern_matmul/ops.py and the weight rows the layer compacts once),
// and so is the epilogue: the kernel writes the raw accumulator
// sum_k x_q[m,k] * w_q[k,n] and the wrapper applies the shared
// `scale_bias_act` of kernels/epilogue.py.
//
// Exactness: every product is at most 127^2 and the sum is kept in int32,
// so it is the exact integer in any order; while Kc * 127^2 < 2^24
// (vikin's Kc <= 304 gives 4.9e6) the f32 it is written as is exact too,
// and equal to what the reference's f32 accumulation of the widened codes
// gives.  Kernel and plain version (pattern_matmul/ref.py) are therefore
// bitwise equal whatever the tiles, and a row's result does not depend on
// its batch.
//
// What bounds it on an H100 (3.35 TB/s, 1979 TOP/s dense int8):
//   * serving buckets (M = 2..16; vikin-mixed 72->304 and Kc=16 ->96):
//     23 KB of int8 weights and 13 KB of f32 output at M=8, 11 ns of
//     memory time against 0.35 MOP: in fact latency bound, by the launch
//     and by every global round trip the block waits for in sequence;
//   * M = 8192, the same two layers: 13 MB of f32 output dominate the
//     14 MB moved (4.1 us) against 0.38 GOP (0.2 us) -- bytes bound.  The
//     first design staged one byte per thread per load, multiplied byte by
//     byte in scalar int32 and stored 64-byte half-warp runs.
// Design:
//   * s8 tensor cores: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32,
//     one warp on a (MT*16) x (NT*8) tile (32x32, or 16x16 at bm = 16);
//   * launch-time tiles bm x bn x bk, bk a multiple of 32; Kc is padded to
//     the slab with zero codes in shared memory (16->32, 72->96, 228->256),
//     which add nothing.  The default bk covers all of Kc, so a block
//     issues every load of its x rows and weight panel before it waits
//     once;
//   * x rows are copied with cp.async as wide as their alignment allows
//     (16, 8 or 4 bytes: rows of 72 codes are 8-byte aligned, rows of 228
//     only 4-byte; bytes on a ragged Kc), k contiguous;
//   * operand B of the MMA is "col" (k contiguous per n) but w_q is (Kc, N)
//     row-major, and ldmatrix.trans is b16 only: each thread loads a 4x4
//     block of codes as four 32-bit words and transposes it in registers
//     with __byte_perm before storing it k-major; rows of both operands
//     are padded by 16 bytes, so the fragment loads hit 32 distinct banks;
//   * staging takes no integer division an element (staging.cuh, Walk);
//   * the int32 tile goes through shared memory as f32 and leaves in
//     16-byte coalesced stores (rows of N=304 and N=96 f32 are 16-byte
//     aligned).  At M = 8 the m16 fragment's rows 8..15 are zero codes.
#include <cstdint>

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

using pm::cp_async;
using pm::MAX_SMEM;
using pm::Walk;

constexpr int MAX_THREADS = 512;
constexpr int PAD = 16;                   // bytes after each staged row
constexpr int CPAD = 8;                   // floats after each output row

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int BYTES>
__device__ __forceinline__ void stage_x(int8_t* As, int lda,
                                        const int8_t* __restrict__ x,
                                        int M, int K, int row0, int k0,
                                        int bm, const Walk& walk) {
  walk.run(bm, [&](int m, int kq) {
    const int gm = row0 + m, gk = k0 + kq * BYTES;
    const bool ok = gm < M && gk < K;   // K % BYTES == 0: all in or out
    cp_async<BYTES>(As + m * lda + kq * BYTES,
                    ok ? x + (size_t)gm * K + gk : x, ok);
  });
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp tile by block tile: pattern_matmul/ops.py (kernel_threads)
// mirrors this rule.
constexpr int warp_mt(int bm) { return bm == 16 ? 1 : 2; }   // m16 tiles
constexpr int warp_nt(int bm) { return bm == 16 ? 2 : 4; }   // n8 tiles

template <int MT, int NT>
__global__ void __launch_bounds__(MAX_THREADS)
pattern_matmul_q8_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         float* __restrict__ y, int M, int K, int N, int bm,
                         int bk, int bn, int x_vec, int w_vec, int y_vec) {
  extern __shared__ float4 smem4[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem4);
  constexpr int WM = MT * 16, WN = NT * 8;
  const int lda = bk + PAD;                 // As: [bm][bk + PAD], k contig.
  int8_t* As = smem;
  int8_t* Bt = smem + bm * lda;             // Bt: [bn][bk + PAD], k contig.
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warps_n = bn / WN;
  const int wm0 = (warp / warps_n) * WM, wn0 = (warp % warps_n) * WN;
  const int row0 = blockIdx.x * bm;
  const int col0 = blockIdx.y * bn;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const Walk walk_x(bk / x_vec, tid, nthreads);
  const Walk walk_w(w_vec ? bn / 4 : bn, tid, nthreads);
  for (int k0 = 0; k0 < K; k0 += bk) {
    // x rows: asynchronous copies, as wide as alignment allows.
    if (x_vec == 16) {
      stage_x<16>(As, lda, x, M, K, row0, k0, bm, walk_x);
    } else if (x_vec == 8) {
      stage_x<8>(As, lda, x, M, K, row0, k0, bm, walk_x);
    } else if (x_vec == 4) {
      stage_x<4>(As, lda, x, M, K, row0, k0, bm, walk_x);
    } else {
      walk_x.run(bm, [&](int m, int k) {
        const int gm = row0 + m, gk = k0 + k;
        As[m * lda + k] = (gm < M && gk < K) ? x[(size_t)gm * K + gk]
                                              : int8_t(0);
      });
    }
    // w panel, transposed to k-major while it is staged.
    if (w_vec) {
      // 4x4 blocks of codes (cells of a bk/4 x bn/4 grid): four 32-bit
      // words (rows k..k+3, columns n..n+3) in, four words (columns
      // n..n+3, rows k..k+3) out.  Four blocks a thread a round, so 16
      // loads are in flight before the first store.
      const int kblocks = bk / 4;
      for (int rr = walk_w.r, cc = walk_w.c; rr < kblocks;) {
        unsigned r[4][4];
        int kb[4], nb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          kb[u] = rr * 4;
          nb[u] = cc * 4;
          const int gk = k0 + kb[u], gn = col0 + nb[u];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = rr < kblocks && gk + q < K && gn < N;
            r[u][q] = ok ? *reinterpret_cast<const unsigned*>(
                               w + (size_t)(gk + q) * N + gn)
                         : 0u;
          }
          walk_w.step(rr, cc);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (kb[u] >= bk) break;
          const unsigned t0 = __byte_perm(r[u][0], r[u][1], 0x5140);
          const unsigned t1 = __byte_perm(r[u][2], r[u][3], 0x5140);
          const unsigned t2 = __byte_perm(r[u][0], r[u][1], 0x7362);
          const unsigned t3 = __byte_perm(r[u][2], r[u][3], 0x7362);
          unsigned* dst = reinterpret_cast<unsigned*>(Bt + nb[u] * lda + kb[u]);
          const int step = lda / 4;
          dst[0] = __byte_perm(t0, t1, 0x5410);
          dst[step] = __byte_perm(t0, t1, 0x7632);
          dst[2 * step] = __byte_perm(t2, t3, 0x5410);
          dst[3 * step] = __byte_perm(t2, t3, 0x7632);
        }
      }
    } else {
      walk_w.run(bk, [&](int k, int n) {
        const int gk = k0 + k, gn = col0 + n;
        Bt[n * lda + k] = (gk < K && gn < N) ? w[(size_t)gk * N + gn]
                                              : int8_t(0);
      });
    }
    cp_async_wait_all();
    __syncthreads();

    for (int kk = 0; kk < bk; kk += 32) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm0 + i * 16 + g) * lda + kk + tig * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * lda);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * lda + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bt + (wn0 + j * 8 + g) * lda + kk + tig * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // The int32 tile as f32 through shared memory (it reuses the operand
  // space: the last barrier above freed it), then 16-byte stores.
  const int ldc = bn + CPAD;
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wm0 + i * 16 + g, c = wn0 + j * 8 + tig * 2;
      *reinterpret_cast<float2*>(Cs + r * ldc + c) = make_float2(
          __int2float_rn(acc[i][j][0]), __int2float_rn(acc[i][j][1]));
      *reinterpret_cast<float2*>(Cs + (r + 8) * ldc + c) = make_float2(
          __int2float_rn(acc[i][j][2]), __int2float_rn(acc[i][j][3]));
    }
  __syncthreads();
  Walk(bn / 4, tid, nthreads).run(bm, [&](int m, int nq) {
    const int gm = row0 + m, gn = col0 + nq * 4;
    if (gm >= M || gn >= N) return;
    const float4 v = *reinterpret_cast<const float4*>(Cs + m * ldc + nq * 4);
    float* dst = y + (size_t)gm * N + gn;
    if (y_vec) {  // N % 4 == 0: the whole float4 lies inside the row
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (gn + 1 < N) dst[1] = v.y;
      if (gn + 2 < N) dst[2] = v.z;
      if (gn + 3 < N) dst[3] = v.w;
    }
  });
}

template <int MT, int NT>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream,
                   const int8_t* x, const int8_t* w, float* y, int M, int K,
                   int N, int bm, int bk, int bn, int x_vec, int w_vec,
                   int y_vec) {
  // Once per instantiation: allow dynamic shared memory above 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      pattern_matmul_q8_kernel<MT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  pattern_matmul_q8_kernel<MT, NT><<<grid, threads, smem, stream>>>(
      x, w, y, M, K, N, bm, bk, bn, x_vec, w_vec, y_vec);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// x: (M, K) int8 row-major, w: (K, N) int8 row-major, y: (M, N) f32.
// All contiguous, on the stream's device.  Tiles: bm in {16, 32, 64, 128},
// bn in {32, 64, 128}, bk a positive multiple of 32; shared memory is
// max((bm + bn) * (bk + 16), 4 * bm * (bn + 8)) bytes and must fit in
// 227 KB (pattern_matmul/ops.py kernel_smem mirrors this).
extern "C" int pattern_matmul_s8(const int8_t* x, const int8_t* w, float* y,
                                 int M, int K, int N, int bm, int bk, int bn,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const bool bm_ok = bm == 16 || bm == 32 || bm == 64 || bm == 128;
  const bool bn_ok = bn == 32 || bn == 64 || bn == 128;
  if (!bm_ok || !bn_ok || bk <= 0 || bk % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int mt = warp_mt(bm), nt = warp_nt(bm);
  const int threads = (bm / (mt * 16)) * (bn / (nt * 8)) * 32;
  const long long operands = (long long)(bm + bn) * (bk + PAD);
  const long long out_tile = 4LL * bm * (bn + CPAD);
  const long long smem = operands > out_tile ? operands : out_tile;
  const long long gy = (N + bn - 1) / bn;
  if (smem > MAX_SMEM || threads > MAX_THREADS || gy > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + bm - 1) / bm, (unsigned)gy);
  int x_vec = 1;
  if (K % 16 == 0 && aligned(x, 16)) {
    x_vec = 16;
  } else if (K % 8 == 0 && aligned(x, 8)) {
    x_vec = 8;
  } else if (K % 4 == 0 && aligned(x, 4)) {
    x_vec = 4;
  }
  const int w_vec = N % 4 == 0 && aligned(w, 4);
  const int y_vec = N % 4 == 0 && aligned(y, 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (mt == 1)
    return (int)launch<1, 2>(grid, threads, (int)smem, s, x, w, y, M, K, N,
                             bm, bk, bn, x_vec, w_vec, y_vec);
  return (int)launch<2, 4>(grid, threads, (int)smem, s, x, w, y, M, K, N, bm,
                           bk, bn, x_vec, w_vec, y_vec);
}
