// One KAN layer (paper Eq. 3) with two-stage sparsity on int8 codes:
// dequantize on load, f32 spline arithmetic and accumulation, f32 out,
// for sm_90a.
//
// Replaces the TPU kernel `kan_fused_pallas_v2_q8` (body
// `_kan_kernel_v2_q8`) of src/repro/kernels/kan_fused/kan_fused.py.  It
// computes kan_fused.cu's function on
//
//   x[b, p]   = x_q[b, p] * x_scale                      (one rounding)
//   wt[row, n] = wt_q[row, n] * slot_scales[row % (nbk+1)] (one rounding)
//
// with `x_scale` the layer's static input scale and `slot_scales` the
// (nbk+1,) per-slot weight scales of the fused [w_b ; t[kb]] rows (the
// silu row's scale, then each kept basis's), as the reference's
// `dequantize` and `_dequant_wt` do.  The activation tile is real-valued
// (silu and the de Boor values of the dequantized input), so unlike the
// int8 matmul there is no integer-exact form: the kernel is held to its
// plain version (kan_fused/ref.py, kan_fused_v2_q8_ref) within 1e-5.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
//   * serving buckets (B = 2..16; vikin-mixed 304->32 and vikin-kan2
//     72->96, nbk = 5): the int8 fused weights are the traffic, a quarter
//     of the f32 kernel's (304*6*32 = 58 KB, 17 ns) against 0.8 MFLOP
//     (12 ns) at B=8 -- bytes bound in principle, latency in fact: the
//     first design's one block also waited on a dependent load of the
//     slot scale for every weight (about 650 ns a feature);
//   * B = 8192, 304->32: 0.75 GFLOP (11 us) against 3.6 MB (1.1 us) --
//     operations bound.
// Design: the f32 kernel's body (kan_split.cuh, see kan_fused.cu) with the
// `Q8` operand policy: the (nbk+1) slot scales are read into shared
// memory once a block; the chunk's x and weight codes are copied raw with
// cp.async and dequantized once a chunk in shared memory, x by x_scale
// and each weight by its slot's scale.  Every product is
// `__fmul_rn`, so no FMA contraction changes a dequantized value; the
// summation order is the f32 kernel's (chunks of 32 features, each one
// fmaf chain, the partials added in chunk order), so every knob gives the
// same bits and batched == single holds bitwise.
#include "kan_split.cuh"

// x_q: (B, n_in) int8, wt_q: (n_in*(nbk+1), n_out) int8, slot_scales:
// (nbk+1,) f32, slot_of: (G+K,) int32, out: (B, n_out) f32.  All
// contiguous, on the stream's device.  `hi` and `inv_h` as for
// kan_fused_v2_f32; `x_scale` is the f32 input scale; bm, bi, bn as there.
extern "C" int kan_fused_v2_q8(const int8_t* x_q, const int8_t* wt_q,
                               const float* slot_scales, const int* slot_of,
                               float* out, int B, int n_in, int n_out,
                               int nbk, int G, int K, float x_scale, float x0,
                               float hi, float inv_h, int bm, int bi, int bn,
                               void* stream) {
  kan_split::Params p = {};
  p.x = x_q;
  p.wt = wt_q;
  p.slot_scales = slot_scales;
  p.slot_of = slot_of;
  p.out = out;
  p.B = B;
  p.n_in = n_in;
  p.n_out = n_out;
  p.nbk = nbk;
  p.n_bases = G + K;
  p.G = G;
  p.K = K;
  p.x_scale = x_scale;
  p.x0 = x0;
  p.hi = hi;
  p.inv_h = inv_h;
  return kan_split::launch<kan_split::Q8>(p, bm, bi, bn, stream);
}
