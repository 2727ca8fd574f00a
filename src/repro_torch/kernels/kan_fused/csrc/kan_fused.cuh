// The SPU stage of the port's spline kernels, for sm_90a: `spu()`, the
// interval location and the stage-buffer de Boor recursion of one input
// in f32 (the f32 KAN layer body, kan_split.cuh, and the f32 spline-basis
// kernel, spline_basis.cuh), and `spu_bf16x2`, the same recursion on two
// inputs with every op rounded to bf16 (the bf16 spline-basis kernel and
// the tensor-core KAN body, kan_mma.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kan_fused {

constexpr int KMAX = 4;                // SplineSpec.VALID_K

// The f32 value of a bf16 bit pattern (exact).
__device__ __forceinline__ float bf16_widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

// core/splines.INV_LUT: 1/j as f32.
__device__ __forceinline__ float inv_lut(int j) {
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

// Native bf16x2 arithmetic (sm_90): each half is the exact result rounded
// once to bf16.  That is the f32 result rounded to bf16 -- what torch's
// bf16 ops give -- because f32 has at least 2p + 2 significand bits for
// bf16's p = 8, so rounding twice never differs from rounding once for
// +, - and *.  The explicit .rn keeps ptxas from contracting a product and
// a sum into one FMA.
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_sub(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Both halves the bf16 bit pattern `v`.
__host__ __device__ constexpr unsigned bf2_splat(unsigned v) {
  return v | (v << 16);
}

// The bf16 bits of d = 0..4 (exact), and of core/splines.INV_LUT[j] at
// bf16 (1, 0.5, 0.333984375, 0.25).
__host__ __device__ constexpr unsigned bf16_int(int d) {
  return d == 0 ? 0x0000u : d == 1 ? 0x3f80u : d == 2 ? 0x4000u
       : d == 3 ? 0x4040u : 0x4080u;
}
__host__ __device__ constexpr unsigned bf16_inv(int j) {
  return j == 1 ? 0x3f80u : j == 2 ? 0x3f00u : j == 3 ? 0x3eabu : 0x3e80u;
}

// spu()'s recursion on bf16 tensors, two inputs at once, packed in
// bf16x2 (the low half one input, the high half the other): `r2` the two
// positions in their cells (located in f32 as spu() locates them), each
// rounded to bf16.  Every op is spu()'s, in its order, as one bf16x2 op
// rounded to bf16 with no convert (the constants 1/j are core/splines.
// INV_LUT rounded to bf16: 1/3 is 0.333984375), so each half of vals2[j]
// is bitwise the plain version's value on a bf16 tensor (every op of
// core/splines.bases_local rounded to bf16).  K is a template parameter:
// the loops unroll to what K needs.
template <int K>
__device__ __forceinline__ void spu_bf16x2(unsigned r2,
                                           unsigned vals2[K + 1]) {
  unsigned right[K], left[K];
#pragma unroll
  for (int d = 0; d < K; ++d) {
    right[d] = bf2_sub(bf2_splat(bf16_int(d + 1)), r2);
    left[d] = bf2_add(r2, bf2_splat(bf16_int(d)));
  }
  vals2[0] = bf2_splat(bf16_int(1));
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    const unsigned inv = bf2_splat(bf16_inv(j));
    unsigned saved = 0u;
#pragma unroll
    for (int rr = 0; rr < j; ++rr) {
      const unsigned temp = bf2_mul(vals2[rr], inv);
      vals2[rr] = bf2_add(saved, bf2_mul(right[rr], temp));
      saved = bf2_mul(left[j - rr - 1], temp);
    }
    vals2[j] = saved;
  }
}

}  // namespace kan_fused
