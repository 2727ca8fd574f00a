// One KAN layer (paper Eq. 3) with two-stage sparsity, bf16 operands, f32
// accumulation, bf16 or f32 out, for sm_90a.
//
// Replaces the TPU kernel `kan_fused_pallas_v2` (body `_kan_kernel_v2`)
// of src/repro/kernels/kan_fused/kan_fused.py on bf16 x and fused weights,
// with its `out_dtype` (x's dtype by default, or f32).  It computes
// kan_fused.cu's function the way the plain version (kan_fused/ref.py,
// kan_fused_v2_ref) does on bf16 tensors:
//
//   silu(x) in f32, rounded once to bf16; the input clipped and rounded
//   to bf16, its cell located in f32 and its K+1 de Boor values by the
//   bf16 recursion (every op rounded to bf16, kan_fused.cuh's spu<true>);
//   the products against the bf16 weights summed in f32; the total
//   rounded once to bf16 (or written as f32).
//
// Each product of two bf16 values is exact in f32, so the kernel and the
// plain version (an f32 matmul of the widened operands) differ only in
// the order of their f32 sums: within 1e-5 * (1 + max|out|) at f32 out,
// one bf16 ulp at bf16 out.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
// the f32 kernel's work with half the weight bytes -- at vikin-mixed's
// 304->32 layer, 117 KB of bf16 weights (35 ns) at B = 8, bytes bound in
// principle and latency bound in fact; 0.75 GFLOP (11 us) at B = 8192,
// operations bound.  The arithmetic stays on CUDA cores: the activation
// of a (row, feature) selects K+1 of its nbk+1 weight rows, which a dense
// bf16 tensor-core tile would multiply by zeros.
// Design: kan_split.cuh's body with the `BF16<false>` operand policy:
// the chunk's raw bf16 x and weight rows are staged with 8-byte cp.async
// (4 elements; a ragged row an element at a time) and widened to f32 in
// shared memory once a chunk, as the int8 kernel dequantizes, so the SPU
// pass, the feature split over a cluster, the FMA pass and its fixed
// order (chunks of 32 features, partials added in chunk order) are the
// f32 kernel's.  Every knob gives the same bits and batched == single
// holds bitwise.
#include "kan_split.cuh"

// x: (B, n_in) bf16, wt: (n_in*(nbk+1), n_out) bf16, slot_of: (G+K,)
// int32, out: (B, n_out) bf16, or f32 where out_f32 != 0.  All contiguous,
// on the stream's device.  `hi`, `inv_h` and bm, bi, bn as for
// kan_fused_v2_f32.
extern "C" int kan_fused_v2_bf16(const void* x, const void* wt,
                                 const int* slot_of, void* out, int B,
                                 int n_in, int n_out, int nbk, int G, int K,
                                 float x0, float hi, float inv_h, int out_f32,
                                 int bm, int bi, int bn, void* stream) {
  kan_split::Params p = {};
  p.x = x;
  p.wt = wt;
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
  return kan_split::launch<kan_split::BF16<false>>(p, bm, bi, bn, stream);
}
