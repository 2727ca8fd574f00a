// The v1 KAN layer kernel (kan_fused_v1.cu) and the SPU stage, `spu()`,
// shared with spline_basis.cu and with the v2 kernels' body
// (kan_split.cuh), for sm_90a.
//
// The body walks a weight-layout policy, `F32Split`: `w_b` and `t_flat` as
// two arrays, summed into two accumulators (silu branch, spline branch)
// that are added once at the end, as the plain version's `dot(s, w_b) +
// dot(act, t_flat)` does.  A block owns 16 rows x 32 outputs and walks
// every input feature in chunks of 32: silu, the cell and the K+1 de Boor
// values of each (row, feature) are staged once in shared memory, and
// each output is summed in one fixed order (features ascending, the silu
// term, then j = 0..K), so batched == single holds bitwise.  See
// kan_fused_v1.cu for the function and what bounds it.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace kan_fused {

constexpr int KMAX = 4;                // SplineSpec.VALID_K
constexpr int BN = 32;                 // outputs per block: one per lane
constexpr int WARPS = 8;
constexpr int RPW = 2;                 // rows per warp
constexpr int BM = WARPS * RPW;        // 16 rows per block
constexpr int PC = 32;                 // input features per staged chunk

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

// v1: `w_b` (n_in, n_out) and `t_flat` (n_in*nbk, n_out), f32, each
// branch summed in its own accumulator.
struct F32Split {
  int nbk;
  const float* x;
  const float* w_b;
  const float* t_flat;
  static constexpr bool kTwoAcc = true;
  __device__ __forceinline__ float load_x(size_t i) const { return x[i]; }
  __device__ __forceinline__ int spline_row(int p, int slot) const {
    return p * nbk + slot;
  }
  __device__ __forceinline__ float silu_w(int p, int n, int n_out) const {
    return __ldg(&w_b[(size_t)p * n_out + n]);
  }
  __device__ __forceinline__ float spline_w(int row, int, int n,
                                            int n_out) const {
    return __ldg(&t_flat[(size_t)row * n_out + n]);
  }
};

template <class Op>
__global__ void __launch_bounds__(BN * WARPS)
kan_fused_kernel(Op op, const int* __restrict__ slot_of,
                 float* __restrict__ out, int B, int n_in, int n_out, int G,
                 int K, float x0, float hi, float inv_h) {
  __shared__ float s_silu[BM][PC];
  __shared__ float s_val[BM][PC][KMAX + 1];
  __shared__ int s_row[BM][PC][KMAX + 1];

  const int tid = threadIdx.y * BN + threadIdx.x;
  const int n = blockIdx.x * BN + threadIdx.x;
  const int b0 = blockIdx.y * BM;

  // acc: the whole sum (v2), or the silu branch (v1); acc_t: v1's
  // spline branch.
  float acc[RPW], acc_t[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = acc_t[r] = 0.f;

  for (int p0 = 0; p0 < n_in; p0 += PC) {
    const int pc = min(PC, n_in - p0);
    // SIMD + SPU + TSE: once per (row, feature) of the chunk.
    for (int e = tid; e < BM * PC; e += BN * WARPS) {
      const int bl = e / PC, pl = e % PC;
      const int b = b0 + bl, p = p0 + pl;
      if (b >= B || pl >= pc) {
        s_silu[bl][pl] = 0.f;
#pragma unroll
        for (int j = 0; j <= KMAX; ++j) {
          s_val[bl][pl][j] = 0.f;
          s_row[bl][pl][j] = -1;
        }
        continue;
      }
      const float xv = op.load_x((size_t)b * n_in + p);
      s_silu[bl][pl] = xv * (1.f / (1.f + expf(-xv)));

      // The KAN layer evaluates its bases on x clipped to [x0, x1 - eps).
      float vals[KMAX + 1];
      const int cell = spu(fminf(fmaxf(xv, x0), hi), x0, inv_h, G, K, vals);
      // TSE: the weight row each non-zero value multiplies, or -1.
#pragma unroll
      for (int j = 0; j <= KMAX; ++j) {
        const int slot = j <= K ? __ldg(&slot_of[cell + j]) : -1;
        s_val[bl][pl][j] = vals[j];
        s_row[bl][pl][j] = slot >= 0 ? op.spline_row(p, slot) : -1;
      }
    }
    __syncthreads();

    // PE: accumulate in registers, features ascending; per feature the
    // silu term first, then j = 0..K.
    if (n < n_out) {
      for (int pl = 0; pl < pc; ++pl) {
        const int p = p0 + pl;
        const float wb = op.silu_w(p, n, n_out);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int bl = threadIdx.y * RPW + r;
          const float a = fmaf(s_silu[bl][pl], wb, acc[r]);
          float c = Op::kTwoAcc ? acc_t[r] : a;
#pragma unroll
          for (int j = 0; j <= KMAX; ++j) {
            const int row = s_row[bl][pl][j];
            if (row >= 0)
              c = fmaf(s_val[bl][pl][j], op.spline_w(row, p, n, n_out), c);
          }
          if constexpr (Op::kTwoAcc) {
            acc[r] = a;
            acc_t[r] = c;
          } else {
            acc[r] = c;
          }
        }
      }
    }
    __syncthreads();
  }

  if (n < n_out) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int b = b0 + threadIdx.y * RPW + r;
      if (b < B)
        out[(size_t)b * n_out + n] =
            Op::kTwoAcc ? __fadd_rn(acc[r], acc_t[r]) : acc[r];
    }
  }
}

// Checks the sizes and launches on `stream`; returns cudaGetLastError().
template <class Op>
int launch(Op op, const int* slot_of, float* out, int B, int n_in, int n_out,
           int nbk, int G, int K, float x0, float hi, float inv_h,
           void* stream) {
  if (B <= 0 || n_out <= 0 || n_in < 0 || nbk < 0 || nbk > G + K || G < 1 ||
      K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  dim3 block(BN, WARPS);
  dim3 grid((n_out + BN - 1) / BN, (B + BM - 1) / BM);
  kan_fused_kernel<Op><<<grid, block, 0, (cudaStream_t)stream>>>(
      op, slot_of, out, B, n_in, n_out, G, K, x0, hi, inv_h);
  return (int)cudaGetLastError();
}

}  // namespace kan_fused
