// Dense B-spline basis values of a flat f32 input, for sm_90a.  Replaces
// the TPU kernel `spline_basis_pallas` of
// src/repro/kernels/spline_basis/spline_basis.py on f32: the f32 instance
// of spline_basis.cuh, which says what it computes, what bounds it and
// how it is laid out.
#include "spline_basis.cuh"

// x: (n,) f32, contiguous; out: (n, G+K) f32, contiguous, 4-byte aligned
// (any 16-byte alignment); both on the stream's device.  `inv_h` = G /
// (x1 - x0) as f32; `block_n` inputs a block, a power of two in 32..4096
// whose output stretch fits in shared memory.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for bad sizes (ops.check_block_n checks the
// same).
extern "C" int spline_basis_f32(const float* x, float* out, int n, int G,
                                int K, float x0, float inv_h, int block_n,
                                void* stream) {
  return launch_f32(x, out, n, G, K, x0, inv_h, block_n, stream);
}
