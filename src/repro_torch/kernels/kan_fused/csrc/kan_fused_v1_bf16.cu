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
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s for products of bf16
// operands on tensor cores, 67 TFLOP/s f32 on CUDA cores): the bf16
// version-2 kernel's work (kan_fused_bf16.cu says what bounds that) --
// at B = 8192, 304->32, 0.96 GFLOP of multiply-adds in the dense tile
// (1.0 us on tensor cores) and the SPU work, 1.6 us at the f32 rate:
// operations bound.  The first design ran the multiply-adds as f32 FMAs
// on CUDA cores (0.0978 ms on an H100, 43x its bound).
// Design: kan_mma.cuh's tensor-core body at version 1: per chunk of 32
// features the raw bf16 x tile, w_b's 32 rows and t_flat's 32 * nbk rows
// are staged with cp.async (the next chunk's in flight), the SPU pass
// writes the A tile [32 silu columns | 32 * nbk kept-basis columns], and
// mma.sync m16n8k16 contracts the silu columns with the w_b rows into
// one accumulator set and the basis columns with the t_flat rows into
// another.  Each chain's chunk partials are added in chunk order (over a
// thread-block cluster where bi < n_in), and the two totals once, so
// every knob gives the same bits and batched == single holds bitwise.
#include "kan_mma.cuh"

// x: (B, n_in) bf16, w_b: (n_in, n_out) bf16, t_flat: (n_in*nbk, n_out)
// bf16, slot_of: (G+K,) int32, out: (B, n_out) bf16, or f32 where
// out_f32 != 0.  All contiguous, on the stream's device.  `hi`, `inv_h`
// and bm, bi, bn as for kan_fused_v2_bf16 (bm * bn up to 8192).
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
  return kan_mma::launch<kan_mma::BF16_V1>(p, bm, bi, bn, stream);
}
