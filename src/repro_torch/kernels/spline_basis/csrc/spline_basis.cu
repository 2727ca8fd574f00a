// Dense B-spline basis values of a flat input (the VIKIN SPU array), f32,
// for sm_90a.
//
// Replaces the TPU kernel `spline_basis_pallas` (body `_kernel`) of
// src/repro/kernels/spline_basis/spline_basis.py.  For each input x[i]:
//
//   u = (x - x0) * inv_h,  cell = clamp(floor u, 0, G-1),  r = u - cell,
//   the K+1 de Boor values of the stage-buffer recursion (INV_LUT
//   reciprocals, no division), and
//   out[i, c] = value j = c - cell for 0 <= j <= K, else 0,  c < G+K.
//
// x is NOT clipped: the cell is located on the raw input and only the cell
// is clamped, so an input outside [x0, x1) gives the extrapolated values of
// its edge cell (possibly negative or above 1), as the TPU kernel and the
// plain version (spline_basis/ref.py, spline_basis_plain) do.  Every value
// is computed with the same round-to-nearest f32 operations in the same
// order as the plain version (the SPU stage of kan_fused.cuh), and the
// scatter only adds zeros, so kernel and plain version agree bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each input
// costs 4 bytes in and 4*(G+K) out against 4 + 2K + 5K(K+1)/2 operations
// (core/splines.spu_op_count): 32 bytes and 40 operations per input at
// G4K3, far below the card's 20 operations per byte.  At n = 8192*304 (2.5 M
// inputs, G4K3) that is 80 MB, 24 us.
// Design: one thread per input, `block_n` threads per block (the launch's
// one knob, autotuned; it changes no result).  A thread evaluates its
// input's K+1 values in registers and writes its whole (G+K)-wide row,
// zeros outside cell..cell+K.  Neighbouring threads write neighbouring
// rows, so a warp's stores cover one contiguous stretch but each store
// instruction is strided by the row width; staging the block's output tile
// in shared memory and storing it contiguously is the obvious later
// improvement.
#include "../../kan_fused/csrc/kan_fused.cuh"

namespace {

using kan_fused::KMAX;

__global__ void spline_basis_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int n, int G,
                                    int K, float x0, float inv_h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float vals[KMAX + 1];
  const int cell = kan_fused::spu(x[i], x0, inv_h, G, K, vals);
  const int nb = G + K;
  float* row = out + (size_t)i * nb;
  for (int c = 0; c < cell; ++c) row[c] = 0.f;
  // 0 + v, as the plain version's scatter sums it (a -0 becomes +0).
#pragma unroll
  for (int j = 0; j <= KMAX; ++j)
    if (j <= K) row[cell + j] = __fadd_rn(0.f, vals[j]);
  for (int c = cell + K + 1; c < nb; ++c) row[c] = 0.f;
}

}  // namespace

// x: (n,) f32, out: (n, G+K) f32, both contiguous on the stream's device.
// `inv_h` = G / (x1 - x0) as f32; `block_n` threads per block, 1..1024.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for bad sizes.
extern "C" int spline_basis_f32(const float* x, float* out, int n, int G,
                                int K, float x0, float inv_h, int block_n,
                                void* stream) {
  if (n <= 0 || G < 1 || K < 1 || K > KMAX || block_n < 1 || block_n > 1024)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + block_n - 1) / block_n;
  spline_basis_kernel<<<grid, block_n, 0, (cudaStream_t)stream>>>(
      x, out, n, G, K, x0, inv_h);
  return (int)cudaGetLastError();
}
