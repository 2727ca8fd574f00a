// One KAN layer (paper Eq. 3) with two-stage sparsity on a bf16 x against
// f32 fused weights, f32 accumulation, bf16 or f32 out, for sm_90a.
//
// Replaces the TPU kernel `kan_fused_pallas_v2` (body `_kan_kernel_v2`)
// of src/repro/kernels/kan_fused/kan_fused.py where the reference's
// bf16 model meets it: the reference's kan_init draws the spline
// coefficients t in f32 in a bf16 model (a numpy float64 scale promotes
// them), so its fused [w_b ; t[kb]] rows are f32 and `_kan_linear_jnp`
// contracts the bf16 activations against them in a promoted f32 product.
// It computes kan_fused.cu's function the way the plain version
// (kan_fused/ref.py, kan_fused_v2_ref) does on these operands:
//
//   silu(x) in f32, rounded once to bf16; the input clipped and rounded
//   to bf16, its cell located in f32 and its K+1 de Boor values by the
//   bf16 recursion (kan_fused.cuh's spu<true>); each activation widened
//   exactly and multiplied with the f32 weights in IEEE f32 (fmaf on CUDA
//   cores: no TF32, no tensor cores); the total rounded once to bf16 (or
//   written as f32).
//
// The kernel and the plain version (an f32 matmul of the widened
// activations) differ only in the order of their f32 sums: within 1e-5 *
// (1 + max|out|) at f32 out, one bf16 ulp at bf16 out.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
// the f32 kernel's work (kan_fused.cu says what bounds that) on half its
// x bytes.  At an LM train step's 1024 x 896 -> 608 (kept bases 0, 2, 4,
// 5, 6) the multiply-adds, 2 * 1024 * 608 * (896 + the kept hits) FLOP
// at the f32 rate, bound it: operations, as at every M > 16.
// Design: kan_split.cuh's body with the `Mixed` operand policy: the f32
// weight rows staged as the f32 kernel stages them, the bf16 x tile
// copied raw and read raw by the bf16 SPU pass; the FMA pass and its
// summation order are the f32 kernel's (chunks of 32 features, each one
// fmaf chain, the partials added in chunk order), so every knob gives the
// same bits and batched == single holds bitwise.  A tensor-core design
// (the f32 weights split once into three bf16 planes, whose products are
// exact) is queued in ROADMAP.md.
#include "kan_split.cuh"

// x: (B, n_in) bf16, wt: (n_in*(nbk+1), n_out) f32, slot_of: (G+K,)
// int32, out: (B, n_out) bf16, or f32 where out_f32 != 0.  All contiguous,
// on the stream's device.  `hi`, `inv_h` and bm, bi, bn as for
// kan_fused_v2_f32.
extern "C" int kan_fused_v2_mixed(const void* x, const float* wt,
                                  const int* slot_of, void* out, int B,
                                  int n_in, int n_out, int nbk, int G, int K,
                                  float x0, float hi, float inv_h,
                                  int out_f32, int bm, int bi, int bn,
                                  void* stream) {
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
  return kan_split::launch<kan_split::Mixed>(p, bm, bi, bn, stream);
}
