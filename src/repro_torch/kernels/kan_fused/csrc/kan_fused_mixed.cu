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
//   bf16 recursion (every op rounded to bf16, kan_fused.cuh's
//   spu_bf16x2); each activation widened exactly and multiplied with the
//   f32 weights, the products summed in f32; the total rounded once to
//   bf16 (or written as f32).
//
// The plane split.  Each f32 weight w is hi + mid + lo exactly, three
// bf16 values (kan_mma.cuh: hi is w with its low 16 bits cleared, mid the
// same of w - hi, lo = w - hi - mid, which has at most 8 significant
// bits), so a * w = a * hi + a * mid + a * lo for a bf16 activation a, and
// each of those products of two bf16 values is exact in f32: three bf16
// tensor-core products give the f32 product with no rounding, and only
// the order and rounding of the f32 sums differ from the plain version
// (an f32 matmul of the widened activations): within 1e-5 * (1 +
// max|out|) at f32 out, one bf16 ulp at bf16 out.  No TF32 anywhere: the
// activation tile is exactly bf16 and the weights are split exactly.
// The underflow edge (|w| below about
// 2^-110, where lo may need bits under bf16's subnormal step) costs a
// product less than 2^-125 |a|; an inf or NaN weight makes its column
// NaN, where the plain version's is inf or NaN (kan_mma.cuh says why).
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s for products of bf16
// operands on tensor cores, 67 TFLOP/s f32 on CUDA cores): the
// multiply-adds this input needs (the silu term and one per kept local
// basis value, 2 * M * n_out flops each), at the cheaper of two costs --
// f32 FMAs at the f32 rate, or three bf16 products at the bf16 rate, the
// cheaper by 989 / (3 * 67) = 4.9x -- plus the SPU work at the f32 rate,
// against the bytes (bf16 x and out, f32 rows).  At an LM train step's
// 1024 x 896 -> 608 (kept bases 0, 2, 4, 5, 6): operations, as at every
// M > 16.  The first design ran the multiply-adds as IEEE f32 FMAs on
// CUDA cores (kan_split.cuh's body): 11-12x that bound at M = 1024.
// Design: kan_mma.cuh's tensor-core body with f32 rows (`F32_PLANES`):
// per chunk of 32 features the raw bf16 x tile and the chunk's f32 rows
// are staged with cp.async (the next chunk's in flight), pass (2) writes
// the bf16 A tile (two features a thread, bf16x2 recursion) and splits
// the staged rows into a plane tile [hi | mid | lo], and each k16 step
// runs mma.sync m16n8k16 three times, lo, mid, hi, from a zero
// accumulator, added to the chunk's partial in IEEE f32 (kan_mma.cuh says
// why not one accumulator a chunk).  The chunk partials are added in
// chunk order (over a thread-block cluster where bi < n_in), so every
// knob gives the same bits and batched == single holds bitwise.  The f32
// rows and their planes cost 10 bytes a weight column a stage, so a
// block keeps two f32 row buffers but one plane tile and one A tile (two
// barriers a chunk): 64 x 64 at nbk = 5 (ops.kernel_smem), where the bf16
// kernel takes 64 x 128.
#include "kan_mma.cuh"

// x: (B, n_in) bf16, wt: (n_in*(nbk+1), n_out) f32, slot_of: (G+K,)
// int32, out: (B, n_out) bf16, or f32 where out_f32 != 0.  All contiguous,
// on the stream's device.  `hi`, `inv_h` and bm, bi, bn as for
// kan_fused_v2_bf16 (the shared memory a block differs).
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
  return kan_mma::launch<kan_mma::F32_PLANES>(p, bm, bi, bn, stream);
}
