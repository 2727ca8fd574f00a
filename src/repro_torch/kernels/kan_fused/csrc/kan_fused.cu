// One KAN layer (paper Eq. 3) with two-stage sparsity, f32, for sm_90a.
//
// Replaces the TPU kernel `kan_fused_pallas_v2` (body `_kan_kernel_v2`,
// with `_spu_tile` and `_tse_scatter`) of
// src/repro/kernels/kan_fused/kan_fused.py.  It computes the same
// function:
//
//   out[b, n] = sum_p  silu(x[b,p]) * wt[p*(nbk+1), n]
//             + sum_p  sum_{j=0..K, slot_of[cell+j] >= 0}
//                      B_{cell+j}(x[b,p]) * wt[p*(nbk+1) + 1 + slot_of[cell+j], n]
//
// with silu on the raw x, the K+1 de Boor values and their cell on x
// clipped to [x0, x1 - eps), and `wt` the row-interleaved [w_b ; t[kb]]
// weights of kan_fused/ops.fuse_wt.  `slot_of` (length G+K) maps a basis
// index to its kept slot, -1 for a basis the stage-2 mask dropped.
//
// The TPU kernel scatters the K+1 values into a dense (bm, bi*(nbk+1))
// tile only because the MXU wants a dense operand; most of that tile is
// zero.  Here the form is the paper's zero-free one: each (row, feature)
// contributes at most K+2 multiply-adds, read straight from the weight
// rows its cell selects, and the (B, n_in*(nbk+1)) activation never
// exists, in device memory or anywhere else.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
//   * serving buckets (B = 2..16; vikin-mixed 304->32 and vikin-kan2
//     72->96, both kb = (0,2,4,5,6), nbk = 5): the fused weights are the
//     traffic (304*6*32*4 = 233 KB, 70 ns) against 0.73 MFLOP (11 ns) at
//     B=8 -- bytes bound in principle; in fact the grid is a single block
//     at B <= 16, n_out <= 32, so one SM's latency sets the time;
//   * B = 8192, 304->32: 0.75 GFLOP (multiply-adds plus the spline
//     evaluation, 11 us) against 11 MB of traffic (3.4 us) -- operations
//     bound.
// Design: a block owns 16 rows x 32 outputs (one warp per two rows, one
// lane per output) and walks the input features in chunks of 32.  For
// each chunk it evaluates silu, the cell and the K+1 basis values of its
// 16x32 (row, feature) pairs once, into shared memory, together with the
// weight row each value multiplies (or -1).  Every lane then accumulates
// its outputs in f32 registers, reading each weight row coalesced across
// the warp.  Each output is summed in one fixed order -- features
// ascending, the silu term first, then j = 0..K -- that depends on
// nothing but the row's own inputs, so batched == single holds bitwise.
// The spline arithmetic uses round-to-nearest intrinsics, so no FMA
// contraction makes it differ from the plain version (kan_fused/ref.py).
#include <cuda_runtime.h>

namespace {

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

__global__ void __launch_bounds__(BN * WARPS)
kan_fused_v2_kernel(const float* __restrict__ x,
                    const float* __restrict__ wt,
                    const int* __restrict__ slot_of,
                    float* __restrict__ out,
                    int B, int n_in, int n_out, int nbk, int G, int K,
                    float x0, float hi, float inv_h) {
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
      const float xv = x[(size_t)b * n_in + p];
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
        const float wb = __ldg(&wt[(size_t)(p0 + pl) * stride * n_out + n]);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int bl = threadIdx.y * RPW + r;
          float a = fmaf(s_silu[bl][pl], wb, acc[r]);
#pragma unroll
          for (int j = 0; j <= KMAX; ++j) {
            const int row = s_row[bl][pl][j];
            if (row >= 0)
              a = fmaf(s_val[bl][pl][j], __ldg(&wt[(size_t)row * n_out + n]),
                       a);
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

}  // namespace

// x: (B, n_in), wt: (n_in*(nbk+1), n_out), slot_of: (G+K,) int32,
// out: (B, n_out).  All contiguous, on the stream's device.  `hi` is the
// clip bound x1 - 1e-6*(x1 - x0) and `inv_h` = G / (x1 - x0), both f32.
extern "C" int kan_fused_v2_f32(const float* x, const float* wt,
                                const int* slot_of, float* out, int B,
                                int n_in, int n_out, int nbk, int G, int K,
                                float x0, float hi, float inv_h,
                                void* stream) {
  if (B <= 0 || n_out <= 0 || n_in < 0 || nbk < 0 || nbk > G + K || G < 1 ||
      K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  dim3 block(BN, WARPS);
  dim3 grid((n_out + BN - 1) / BN, (B + BM - 1) / BM);
  kan_fused_v2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, wt, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h);
  return (int)cudaGetLastError();
}
