// One KAN layer (paper Eq. 3) with two-stage sparsity, version 1: the
// silu and spline branches against two weight arrays, f32, for sm_90a.
//
// Replaces the TPU kernel `kan_fused_pallas` (v1, body `_kan_kernel`) of
// src/repro/kernels/kan_fused/kan_fused.py.  It computes
//
//   out[b, n] = sum_p silu(x[b,p]) * w_b[p, n]
//             + sum_p sum_{j=0..K, slot_of[cell+j] >= 0}
//                     B_{cell+j}(x[b,p]) * t_flat[p*nbk + slot_of[cell+j], n]
//
// with silu on the raw x and the de Boor values and their cell on x
// clipped to [x0, x1 - eps): kan_fused.cu's function on the unfused
// weights `w_b` (n_in, n_out) and `t_flat` (n_in*nbk, n_out, rows
// feature-major, kept bases only).  The TPU kernel issues two MXU
// contractions per grid step, `silu(x) @ w_b` and `scattered_bases @
// t_flat`, into one accumulator; it is the reference's baseline for v2's
// single fused contraction.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
// the same work as the v2 kernel, with the same weight bytes split over
// two arrays -- at vikin-mixed's 304->32 layer, bytes bound in principle
// at B = 8 (233 KB of weights, 70 ns; in fact the latency of a chain of
// dependent steps sets the time) and operations bound at B = 8192 (0.75
// GFLOP, 11 us; shared memory and instruction issue cap it, as they cap
// the v2 kernel).
// Design: the v2 kernels' body (kan_split.cuh, see kan_fused.cu) with the
// `Split` operand policy, and the same launch-time knobs (bm, bi, bn).
// Each chunk's rows of w_b and t_flat are copied with cp.async into the
// fused layout the v2 kernel stages (the silu row of a feature, then its
// kept-basis rows), so the SPU pass, the feature split over a cluster and
// the FMA pass are the v2 kernel's.  The FMA pass keeps two chains a
// chunk: the silu terms in one, the basis terms in the other.  Each is
// summed in chunks of 32 features (one fmaf chain a chunk, the partials
// added in chunk order), and the output is the two totals added once, as
// the plain version (kan_fused/ref.py, kan_fused_v1_ref) adds its two
// products.  The order depends on the layer alone: every knob gives the
// same bits and batched == single holds bitwise.
#include "kan_split.cuh"

// x: (B, n_in), w_b: (n_in, n_out), t_flat: (n_in*nbk, n_out), slot_of:
// (G+K,) int32, out: (B, n_out).  All f32 unless noted, contiguous, on the
// stream's device.  `hi`, `inv_h` and bm, bi, bn as for kan_fused_v2_f32.
extern "C" int kan_fused_v1_f32(const float* x, const float* w_b,
                                const float* t_flat, const int* slot_of,
                                float* out, int B, int n_in, int n_out,
                                int nbk, int G, int K, float x0, float hi,
                                float inv_h, int bm, int bi, int bn,
                                void* stream) {
  kan_split::Params p = {};
  p.x = x;
  p.wt = w_b;
  p.t_flat = t_flat;
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
  return kan_split::launch<kan_split::Split>(p, bm, bi, bn, stream);
}
