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
// The kernel body is kan_fused.cuh, shared with the int8 kernel
// (kan_fused_q8.cu) and the v1 kernel (kan_fused_v1.cu).
#include "kan_fused.cuh"

// x: (B, n_in), wt: (n_in*(nbk+1), n_out), slot_of: (G+K,) int32,
// out: (B, n_out).  All contiguous, on the stream's device.  `hi` is the
// clip bound x1 - 1e-6*(x1 - x0) and `inv_h` = G / (x1 - x0), both f32.
extern "C" int kan_fused_v2_f32(const float* x, const float* wt,
                                const int* slot_of, float* out, int B,
                                int n_in, int n_out, int nbk, int G, int K,
                                float x0, float hi, float inv_h,
                                void* stream) {
  return kan_fused::launch(kan_fused::F32{{nbk}, x, wt}, slot_of, out, B,
                           n_in, n_out, nbk, G, K, x0, hi, inv_h, stream);
}
