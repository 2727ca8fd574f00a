// Dense B-spline basis values of a flat bf16 input, bf16 out, for sm_90a.
// Replaces the TPU kernel `spline_basis_pallas` of
// src/repro/kernels/spline_basis/spline_basis.py on bf16: the bf16
// instance of spline_basis.cuh (which says what it computes, what bounds
// it and how it is laid out).  As the TPU kernel and the plain version
// (spline_basis/ref.py) do on a bf16 input, the cell is located in f32 on
// the widened input and every op of the de Boor recursion is rounded to
// bf16 (kan_fused.cuh's spu<true>), so kernel and plain version agree bit
// for bit, in range and out of it.  Half the bytes of the f32 instance:
// at n = 8192*304, G4K3, 40 MB, 12 us at 3.35 TB/s.
#include "spline_basis.cuh"

// x: (n,) bf16, contiguous; out: (n, G+K) bf16, contiguous, 2-byte
// aligned (any 16-byte alignment); both on the stream's device.  `inv_h`
// and `block_n` as for spline_basis_f32 (the output stretch is half as
// large in shared memory).
extern "C" int spline_basis_bf16(const void* x, void* out, int n, int G,
                                 int K, float x0, float inv_h, int block_n,
                                 void* stream) {
  return launch<unsigned short>(static_cast<const unsigned short*>(x),
                                static_cast<unsigned short*>(out), n, G, K,
                                x0, inv_h, block_n, stream);
}
