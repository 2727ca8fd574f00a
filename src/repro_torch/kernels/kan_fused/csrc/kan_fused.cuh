// The fused KAN layer kernel shared by kan_fused.cu (f32) and
// kan_fused_q8.cu (int8 codes), for sm_90a.
//
// One template body; the operand policy `Op` says how an input value and
// a fused weight are read: as f32 (`F32`), or as int8 codes dequantized
// on load (`Q8`: x times the layer's static scale, each weight times the
// scale of its row slot -- silu row 0, kept basis 1 + slot).  Everything
// else -- the staging of silu, the cell and the K+1 de Boor values, the
// round-to-nearest spline arithmetic and the fixed summation order -- is
// the same code for both, so each keeps batched == single bitwise.  See
// kan_fused.cu for the function, the design and what bounds it.
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

// f32 operands, read as they are.
struct F32 {
  const float* x;
  const float* wt;
  __device__ __forceinline__ float load_x(size_t i) const { return x[i]; }
  __device__ __forceinline__ float load_w(size_t i, int) const {
    return __ldg(&wt[i]);
  }
};

// int8 codes, dequantized on load as the reference does (`dequantize`,
// `_dequant_wt`): one round-to-nearest product each, never fused into the
// multiply-add that consumes it.
struct Q8 {
  const int8_t* x;
  const int8_t* wt;
  const float* slot_scales;            // (nbk+1,): silu row, kept bases
  float x_scale;
  __device__ __forceinline__ float load_x(size_t i) const {
    return __fmul_rn((float)x[i], x_scale);
  }
  __device__ __forceinline__ float load_w(size_t i, int slot) const {
    return __fmul_rn((float)__ldg(&wt[i]), __ldg(&slot_scales[slot]));
  }
};

template <class Op>
__global__ void __launch_bounds__(BN * WARPS)
kan_fused_v2_kernel(Op op, const int* __restrict__ slot_of,
                    float* __restrict__ out, int B, int n_in, int n_out,
                    int nbk, int G, int K, float x0, float hi, float inv_h) {
  __shared__ float s_silu[BM][PC];
  __shared__ float s_val[BM][PC][KMAX + 1];
  __shared__ int s_row[BM][PC][KMAX + 1];

  const int tid = threadIdx.y * BN + threadIdx.x;
  const int n = blockIdx.x * BN + threadIdx.x;
  const int b0 = blockIdx.y * BM;
  const int stride = nbk + 1;
  const float cell_max = (float)(G - 1);

  float acc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = 0.f;

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

      // Interval location on the clipped input (core/splines.locate_cell).
      const float xc = fminf(fmaxf(xv, x0), hi);
      const float u = __fmul_rn(__fsub_rn(xc, x0), inv_h);
      const float cf = fminf(fmaxf(floorf(u), 0.f), cell_max);
      const float r = __fsub_rn(u, cf);
      const int cell = (int)cf;

      // Stage-buffer de Boor recursion (core/splines.bases_local).
      float right[KMAX], left[KMAX], vals[KMAX + 1];
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
      // TSE: the weight row each non-zero value multiplies, or -1.
#pragma unroll
      for (int j = 0; j <= KMAX; ++j) {
        const int slot = j <= K ? __ldg(&slot_of[cell + j]) : -1;
        s_val[bl][pl][j] = vals[j];
        s_row[bl][pl][j] = slot >= 0 ? p * stride + 1 + slot : -1;
      }
    }
    __syncthreads();

    // PE: accumulate in registers, features ascending.
    if (n < n_out) {
      for (int pl = 0; pl < pc; ++pl) {
        const int base = (p0 + pl) * stride;   // the feature's silu row
        const float wb = op.load_w((size_t)base * n_out + n, 0);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int bl = threadIdx.y * RPW + r;
          float a = fmaf(s_silu[bl][pl], wb, acc[r]);
#pragma unroll
          for (int j = 0; j <= KMAX; ++j) {
            const int row = s_row[bl][pl][j];
            if (row >= 0)
              a = fmaf(s_val[bl][pl][j],
                       op.load_w((size_t)row * n_out + n, row - base), a);
          }
          acc[r] = a;
        }
      }
    }
    __syncthreads();
  }

  if (n < n_out) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int b = b0 + threadIdx.y * RPW + r;
      if (b < B) out[(size_t)b * n_out + n] = acc[r];
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
  kan_fused_v2_kernel<Op><<<grid, block, 0, (cudaStream_t)stream>>>(
      op, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h);
  return (int)cudaGetLastError();
}

}  // namespace kan_fused
