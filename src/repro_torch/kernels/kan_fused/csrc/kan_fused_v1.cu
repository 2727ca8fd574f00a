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
// at B = 8 (233 KB of weights, 70 ns; in fact one block's latency sets
// the time) and operations bound at B = 8192 (0.75 GFLOP, 11 us).
// Design: kan_fused.cuh's body with the `F32Split` policy: the same zero-
// free form (at most K+2 multiply-adds per row and feature, no (B,
// n_in*nbk) activation anywhere), the silu weight read from w_b[p, n] and
// each kept basis's from t_flat[p*nbk + slot, n].  Each output keeps two
// f32 accumulators, the silu branch and the spline branch, each summed
// features ascending (the spline terms j = 0..K within a feature), and
// adds them once at the end, as the plain version (kan_fused/ref.py,
// kan_fused_v1_ref) adds its two products.  The order depends on nothing
// but the row's own inputs, so batched == single holds bitwise.
#include "kan_fused.cuh"

// x: (B, n_in), w_b: (n_in, n_out), t_flat: (n_in*nbk, n_out), slot_of:
// (G+K,) int32, out: (B, n_out).  All f32 unless noted, contiguous, on the
// stream's device.  `hi` and `inv_h` as for kan_fused_v2_f32.
extern "C" int kan_fused_v1_f32(const float* x, const float* w_b,
                                const float* t_flat, const int* slot_of,
                                float* out, int B, int n_in, int n_out,
                                int nbk, int G, int K, float x0, float hi,
                                float inv_h, void* stream) {
  return kan_fused::launch(kan_fused::F32Split{nbk, x, w_b, t_flat}, slot_of,
                           out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h,
                           stream);
}
