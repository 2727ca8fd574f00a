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
// so it is the exact integer; while Kc * 127^2 < 2^24 (vikin's Kc <= 304
// gives 4.9e6) the f32 it is written as is exact too, and equal to what
// the reference's f32 accumulation of the widened codes gives in any
// order.  Kernel and plain version (pattern_matmul/ref.py) are therefore
// bitwise equal, and a row's result does not depend on its batch.
//
// What bounds it on an H100 (3.35 TB/s, 1979 TOP/s dense int8):
//   * serving buckets (M = 2..16; vikin-mixed 72->304 and Kc=16 ->96):
//     23 KB of int8 weights and 13 KB of f32 output at M=8, 11 ns of
//     memory time against 0.35 MOP -- bytes bound in principle, and in
//     fact bound by the launch, which costs microseconds;
//   * M = 8192, the same two layers: 13 MB of f32 output dominate the
//     14 MB moved (4.1 us) against 0.38 GOP (0.2 us) -- bytes bound.
// Design: the simple shared-memory tiled matmul of pattern_matmul.cu on
// bytes and integers.  A 256-thread block owns a 64x64 output tile and
// walks Kc in 32-deep slabs staged as int8 in shared memory; each thread
// keeps a 4x4 tile of int32 accumulators, so every operand it loads feeds
// four integer multiply-adds.  Ragged M, Kc and N are bounds-checked and
// padded with zero codes, which add nothing.  dp4a and the s8 tensor-core
// MMA are later work.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;            // 16 thread columns
constexpr int TY = BM / TM;            // 16 thread rows
constexpr int THREADS = TX * TY;       // 256

__global__ void __launch_bounds__(THREADS)
pattern_matmul_q8_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         float* __restrict__ y, int M, int K, int N) {
  __shared__ int8_t As[BK][BM];
  __shared__ int8_t Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads read consecutive k of one row.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : int8_t(0);
    }
    // w tile: consecutive threads read consecutive n of one row.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : int8_t(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + j * TX;
      if (gn < N) y[(size_t)gm * N + gn] = __int2float_rn(acc[i][j]);
    }
  }
}

}  // namespace

// x: (M, K) int8 row-major, w: (K, N) int8 row-major, y: (M, N) f32.
// All contiguous, on the stream's device.
extern "C" int pattern_matmul_s8(const int8_t* x, const int8_t* w, float* y,
                                 int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pattern_matmul_q8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, y, M, K, N);
  return (int)cudaGetLastError();
}
