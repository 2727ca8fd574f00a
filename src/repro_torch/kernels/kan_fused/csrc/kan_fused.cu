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
//     B=8 -- bytes bound in principle.  In fact latency: the first design
//     ran one block of 16 rows x 32 outputs over all 304 features (one SM
//     of 132) and waited on dependent global loads for every feature
//     (about 400 ns each);
//   * B = 8192, 304->32: 0.75 GFLOP (multiply-adds plus the spline
//     evaluation, 11 us) against 11 MB of traffic (3.4 us) -- operations
//     bound.  Each multiply-add reads its weight from shared memory (the
//     row a cell picks differs per input row, so a weight is reused only
//     across the 4 columns of a float4), so shared-memory bandwidth caps
//     it near a quarter of the f32 peak.
// Design (kan_split.cuh): launch-time knobs bm x bn outputs a block and bi
// features a block walk; the feature loop is split over a thread-block
// cluster along grid.z (at B=8, bi=32 and bn=8 give vikin-mixed's layer
// 40 blocks, not 1), and rank 0 adds the members' chunk partials in chunk
// order through distributed shared memory, inside the one launch.  Each
// chunk's weight rows and x tile are staged with cp.async before any
// multiply-add, the next chunk's in flight; silu, the cell and the K+1
// de Boor values of each (row, feature) are evaluated once into shared
// memory with the staged row each value multiplies; every compute thread
// then runs TM rows x 4 columns, one float4 of weights a multiply-add
// group, the silu row's float4 shared by its TM rows.
// The summation order is fixed by the layer alone -- features in chunks of
// 32, each chunk's partial one fmaf chain (features ascending, silu term
// first, then j = 0..K), the partials added in chunk order -- so every
// knob gives the same bits and batched == single holds bitwise.  The
// spline arithmetic uses round-to-nearest intrinsics (kan_fused.cuh's
// spu()), so no FMA contraction makes it differ from the plain version
// (kan_fused/ref.py).  The int8 kernel (kan_fused_q8.cu) and the version-1
// kernel (kan_fused_v1.cu) share the body.
#include "kan_split.cuh"

// x: (B, n_in), wt: (n_in*(nbk+1), n_out), slot_of: (G+K,) int32,
// out: (B, n_out).  All contiguous, on the stream's device.  `hi` is the
// clip bound x1 - 1e-6*(x1 - x0) and `inv_h` = G / (x1 - x0), both f32.
// bm, bn: rows and outputs a block, each one of 8, 16, 32, 64, 128, with
// bm * bn <= 8192; bi: features a block walks, a multiple of 32 or >= n_in.
extern "C" int kan_fused_v2_f32(const float* x, const float* wt,
                                const int* slot_of, float* out, int B,
                                int n_in, int n_out, int nbk, int G, int K,
                                float x0, float hi, float inv_h, int bm,
                                int bi, int bn, void* stream) {
  kan_split::Params p = {};
  p.x = x;
  p.wt = wt;
  p.slot_of = slot_of;
  p.out = out;
  p.B = B;
  p.n_in = n_in;
  p.n_out = n_out;
  p.nbk = nbk;
  p.n_bases = G + K;
  p.G = G;
  p.K = K;
  p.x0 = x0;
  p.hi = hi;
  p.inv_h = inv_h;
  return kan_split::launch<kan_split::F32>(p, bm, bi, bn, stream);
}
