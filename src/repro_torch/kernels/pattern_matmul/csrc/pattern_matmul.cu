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
//     0.35 MFLOP (5 ns) at M=8 -- bytes bound in principle, and in fact
//     bound by the launch itself, which costs microseconds;
//   * M = 8192, vikin-mixed's 72->304 relu and 16->96: 16 MB moved
//     (4.8 us) against 387 MFLOP (5.8 us) -- operations bound.
// Design: a plain shared-memory tiled matmul on CUDA cores (no tensor
// cores, no TF32: the port holds IEEE f32 against the reference).  A
// 256-thread block owns a 64x64 output tile and walks Kc in 16-deep
// slabs; each thread keeps a 4x4 register tile of accumulators, so every
// shared-memory operand it loads feeds four FMAs.  Each output is summed
// over k = 0..Kc-1 in ascending order with one FMA per term, whatever M,
// the block's other rows or the bucket are, so a row's result does not
// depend on the batch it was served in (batched == single, bitwise).
// Zero padding of the ragged edges only ever adds 0*0.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;            // 16 thread columns
constexpr int TY = BM / TM;            // 16 thread rows
constexpr int THREADS = TX * TY;       // 256

// Activation codes: kernels/epilogue.py ACT_CODES.
__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:  // relu
      return v < 0.f ? 0.f : v;
    case 2: {  // gelu, tanh form (jax.nn.gelu's default)
      const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float kKappa = 0.044715f;
      float inner = kBeta * (v + kKappa * v * v * v);
      return 0.5f * v * (1.f + tanhf(inner));
    }
    case 3:  // silu
      return v * (1.f / (1.f + expf(-v)));
    default:
      return v;
  }
}

__global__ void __launch_bounds__(THREADS)
pattern_matmul_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ y,
                      int M, int K, int N, int act) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads read consecutive k of one row.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    // w tile: consecutive threads read consecutive n of one row.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue, in bias_act's order: add the bias to the finished
  // accumulator, then the activation.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + j * TX;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
      y[(size_t)gm * N + gn] = apply_act(v, act);
    }
  }
}

}  // namespace

// x: (M, K) row-major, w: (K, N) row-major, bias: (N,) or NULL,
// y: (M, N).  All f32, contiguous, on the stream's device.
extern "C" int pattern_matmul_f32(const float* x, const float* w,
                                  const float* bias, float* y, int M, int K,
                                  int N, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pattern_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, bias, y, M, K, N, act);
  return (int)cudaGetLastError();
}
