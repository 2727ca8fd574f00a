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
//     (12 ns) at B=8 -- bytes bound in principle; in fact, as for the f32
//     kernel, one block's latency sets the time;
//   * B = 8192, 304->32: 0.75 GFLOP (11 us) against 3.6 MB (1.1 us) --
//     operations bound.
// Design: the f32 kernel's body (kan_fused.cuh) with the `Q8` operand
// policy: each (row, feature) is dequantized once when it is staged, and
// each weight a lane reads is dequantized by its slot's scale right before
// the multiply-add that uses it.  The products are `__fmul_rn`, so no FMA
// contraction changes the dequantized values; the summation order is the
// f32 kernel's (features ascending, silu first, then j = 0..K), so
// batched == single holds bitwise.
#include "kan_fused.cuh"

// x_q: (B, n_in) int8, wt_q: (n_in*(nbk+1), n_out) int8, slot_scales:
// (nbk+1,) f32, slot_of: (G+K,) int32, out: (B, n_out) f32.  All
// contiguous, on the stream's device.  `hi` and `inv_h` as for
// kan_fused_v2_f32; `x_scale` is the f32 input scale.
extern "C" int kan_fused_v2_q8(const int8_t* x_q, const int8_t* wt_q,
                               const float* slot_scales, const int* slot_of,
                               float* out, int B, int n_in, int n_out,
                               int nbk, int G, int K, float x_scale, float x0,
                               float hi, float inv_h, void* stream) {
  return kan_fused::launch(kan_fused::Q8{x_q, wt_q, slot_scales, x_scale},
                           slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi,
                           inv_h, stream);
}
