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
//   bf16 recursion (every op rounded to bf16, kan_fused.cuh's spu_bf16x2);
//   the products against the bf16 weights summed in f32; the total
//   rounded once to bf16 (or written as f32).
//
// Each product of two bf16 values is exact in f32, so the kernel and the
// plain version (an f32 matmul of the widened operands) differ only in
// the order and the rounding of their f32 sums (the tensor cores' adds
// need not round to nearest at each step): within 1e-5 * (1 + max|out|)
// at f32 out, one bf16 ulp at bf16 out.
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s for products of bf16
// operands on tensor cores, 67 TFLOP/s f32 on CUDA cores):
//   * serving buckets (vikin-mixed's 304->32 layer at B = 8): 117 KB of
//     bf16 weights (35 ns), bytes bound in principle, latency bound in
//     fact: the launch, the staged copies and the cluster combine;
//   * B = 8192, 304->32: the multiply-adds are products of two bf16 values
//     summed in f32 -- 0.96 GFLOP in the dense tile (1.0 us on tensor
//     cores), which the first design ran as f32 FMAs on CUDA cores (0.097
//     ms, 43x its bound, its shared memory and its issue rate the limit)
//     -- and the SPU work, 1.6 us at the f32 rate: operations bound.  The
//     SPU pass and the A-tile writes, not the multiply-adds, set the pace.
// Design: kan_mma.cuh's tensor-core body: per chunk of 32 features the
// raw bf16 x and weight rows are staged with cp.async (the next chunk's
// in flight), the SPU pass writes the dense [silu | kept bases] A tile in
// bf16, and mma.sync m16n8k16 contracts it with the staged rows; the
// chunk partials are added in chunk order (over a thread-block cluster
// where bi < n_in), so every knob gives the same bits and batched ==
// single holds bitwise.
#include "kan_mma.cuh"

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
  return kan_mma::launch<kan_mma::BF16_V2>(p, bm, bi, bn, stream);
}
