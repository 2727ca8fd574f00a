// The SPU stage, `spu()`, of the port's spline kernels, for sm_90a: the
// interval location and the stage-buffer de Boor recursion of one input,
// shared by the KAN layer kernels' body (kan_split.cuh) and the spline-
// basis kernels (spline_basis.cuh).  `spu<false>` is the f32 recursion,
// `spu<true>` the bf16 one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kan_fused {

constexpr int KMAX = 4;                // SplineSpec.VALID_K

// `v` rounded to the nearest bf16 (ties to even) and widened back: one
// bf16 rounding of an f32 result, as torch rounds each bf16 op.  The
// packed convert (F2FP) gives the scalar one's bits and issues at a
// higher rate.
__device__ __forceinline__ float bf16_round(float v) {
  return __low2float(__floats2bfloat162_rn(v, 0.f));
}

// The f32 value of a bf16 bit pattern (exact).
__device__ __forceinline__ float bf16_widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16)
    return bf16_round(v);
  else
    return v;
}

template <bool BF16>
__device__ __forceinline__ float inv_lut(int j) {
  // core/splines.INV_LUT: 1/j as f32, or as bf16 (1/3 rounds to
  // 0.333984375 there)
  const float third = BF16 ? 0.333984375f : 0.3333333432674408f;
  return j == 1 ? 1.f : j == 2 ? 0.5f : j == 3 ? third : 0.25f;
}

// SPU: interval location on `xv` as given (core/splines.locate_cell; the
// caller clips first where the function clips) and the stage-buffer de
// Boor recursion (core/splines.bases_local).  Writes the K+1 values into
// vals[0..K] (vals[K+1..KMAX] = 0) and returns the cell.  Every operation
// is one round-to-nearest f32 op, so nvcc contracts none of them into an
// FMA and the values equal the plain version's bit for bit.  With BF16
// (`xv` a bf16 value, widened) the location stays in f32 and every op of
// the recursion -- r, the stage buffer, each product and sum -- is
// rounded to bf16 after it, as torch's bf16 ops round each result: the
// plain version on a bf16 tensor.
template <bool BF16 = false>
__device__ __forceinline__ int spu(float xv, float x0, float inv_h, int G,
                                   int K, float vals[KMAX + 1]) {
  const float u = __fmul_rn(__fsub_rn(xv, x0), inv_h);
  const float cf = fminf(fmaxf(floorf(u), 0.f), (float)(G - 1));
  const float r = rnd<BF16>(__fsub_rn(u, cf));

  float right[KMAX], left[KMAX];
#pragma unroll
  for (int d = 0; d < KMAX; ++d) {
    right[d] = rnd<BF16>(__fsub_rn((float)(d + 1), r));
    left[d] = rnd<BF16>(__fadd_rn(r, (float)d));
  }
  vals[0] = 1.f;
#pragma unroll
  for (int j = 1; j <= KMAX; ++j) {
    vals[j] = 0.f;
    if (j > K) continue;
    const float inv = inv_lut<BF16>(j);
    float saved = 0.f;
#pragma unroll
    for (int rr = 0; rr < j; ++rr) {
      const float temp = rnd<BF16>(__fmul_rn(vals[rr], inv));
      vals[rr] = rnd<BF16>(
          __fadd_rn(saved, rnd<BF16>(__fmul_rn(right[rr], temp))));
      saved = rnd<BF16>(__fmul_rn(left[j - rr - 1], temp));
    }
    vals[j] = saved;
  }
  return (int)cf;
}

}  // namespace kan_fused
