// The SPU stage, `spu()`, of the port's spline kernels, for sm_90a: the
// interval location and the stage-buffer de Boor recursion of one input,
// shared by the KAN layer kernels' body (kan_split.cuh) and the spline-
// basis kernel (spline_basis.cu).
#pragma once

#include <cuda_runtime.h>

namespace kan_fused {

constexpr int KMAX = 4;                // SplineSpec.VALID_K

__device__ __forceinline__ float inv_lut(int j) {
  // core/splines.INV_LUT: 1/j as f32
  return j == 1 ? 1.f : j == 2 ? 0.5f : j == 3 ? 0.3333333432674408f : 0.25f;
}

// SPU: interval location on `xv` as given (core/splines.locate_cell; the
// caller clips first where the function clips) and the stage-buffer de
// Boor recursion (core/splines.bases_local).  Writes the K+1 values into
// vals[0..K] (vals[K+1..KMAX] = 0) and returns the cell.  Every operation
// is one round-to-nearest f32 op, so nvcc contracts none of them into an
// FMA and the values equal the plain version's bit for bit.
__device__ __forceinline__ int spu(float xv, float x0, float inv_h, int G,
                                   int K, float vals[KMAX + 1]) {
  const float u = __fmul_rn(__fsub_rn(xv, x0), inv_h);
  const float cf = fminf(fmaxf(floorf(u), 0.f), (float)(G - 1));
  const float r = __fsub_rn(u, cf);

  float right[KMAX], left[KMAX];
#pragma unroll
  for (int d = 0; d < KMAX; ++d) {
    right[d] = __fsub_rn((float)(d + 1), r);
    left[d] = __fadd_rn(r, (float)d);
  }
  vals[0] = 1.f;
#pragma unroll
  for (int j = 1; j <= KMAX; ++j) {
    vals[j] = 0.f;
    if (j > K) continue;
    const float inv = inv_lut(j);
    float saved = 0.f;
#pragma unroll
    for (int rr = 0; rr < j; ++rr) {
      const float temp = __fmul_rn(vals[rr], inv);
      vals[rr] = __fadd_rn(saved, __fmul_rn(right[rr], temp));
      saved = __fmul_rn(left[j - rr - 1], temp);
    }
    vals[j] = saved;
  }
  return (int)cf;
}

}  // namespace kan_fused
