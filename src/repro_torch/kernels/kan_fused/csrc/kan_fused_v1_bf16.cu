// One KAN layer (paper Eq. 3) with two-stage sparsity, version 1 (the
// silu and spline branches against w_b and t_flat apart), bf16 operands,
// f32 accumulation, bf16 or f32 out, for sm_90a.
//
// Replaces the TPU kernel `kan_fused_pallas` (v1, body `_kan_kernel`) of
// src/repro/kernels/kan_fused/kan_fused.py on bf16 operands, with its
// `out_dtype`.  It computes kan_fused_v1.cu's function with
// kan_fused_bf16.cu's bf16 numerics (silu rounded once to bf16, the bf16
// de Boor recursion, exact products, f32 sums, one rounding of the total),
// as the plain version (kan_fused/ref.py, kan_fused_v1_ref) does on bf16
// tensors: the silu and spline totals are summed apart and added once.
//
// What bounds it on an H100: the v1 f32 kernel's work with half the
// weight bytes (kan_fused.cu says what bounds that): at B = 8192 its
// multiply-adds run as f32 FMAs on CUDA cores, where the bf16 version-2
// kernel (kan_fused_bf16.cu) runs them on tensor cores.
// Design: kan_split.cuh's body with the `BF16` operand policy: the
// chunk's rows of w_b and t_flat are staged raw into the fused layout and
// widened once a chunk, and the FMA pass keeps v1's two chains (silu and
// spline) in the fixed order, so every knob gives the same bits and
// batched == single holds bitwise.
#include "kan_split.cuh"

// x: (B, n_in) bf16, w_b: (n_in, n_out) bf16, t_flat: (n_in*nbk, n_out)
// bf16, slot_of: (G+K,) int32, out: (B, n_out) bf16, or f32 where
// out_f32 != 0.  All contiguous, on the stream's device.  `hi`, `inv_h`
// and bm, bi, bn as for kan_fused_v1_f32.
extern "C" int kan_fused_v1_bf16(const void* x, const void* w_b,
                                 const void* t_flat, const int* slot_of,
                                 void* out, int B, int n_in, int n_out,
                                 int nbk, int G, int K, float x0, float hi,
                                 float inv_h, int out_f32, int bm, int bi,
                                 int bn, void* stream) {
  kan_split::Params p = {};
  p.x = x;
  p.wt = w_b;
  p.t_flat = t_flat;
  p.slot_of = slot_of;
  p.out = out;
  p.out_bf16 = !out_f32;
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
  return kan_split::launch<kan_split::BF16>(p, bm, bi, bn, stream);
}
