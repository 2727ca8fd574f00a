// Dense B-spline basis values of a flat bf16 input, bf16 out, for sm_90a.
// Replaces the TPU kernel `spline_basis_pallas` of
// src/repro/kernels/spline_basis/spline_basis.py on bf16.  It computes
// spline_basis.cuh's function as the TPU kernel and the plain version
// (spline_basis/ref.py) do on a bf16 input: the cell located in f32 on
// the widened input, every op of the de Boor recursion rounded to bf16
// (kan_fused.cuh's spu_bf16x2), each output 0 + v_j inside cell..cell+K
// and +0 outside it -- bit for bit, in range and out of it.
//
// What bounds it on an H100 (3.35 TB/s): bytes, 2 in and 2 (G+K) out an
// input: at n = 8192*304, G4K3, 40 MB, 12 us.  The first design ran the
// recursion as f32 ops, each followed by an f32 -> bf16 convert (F2FP):
// 33 converts an input at K = 3, on a pipe that issues 16 a clock an SM,
// about 22 us of the 27 it took at that n on an H100 -- issue bound, not
// byte bound (the f32 instance, twice the bytes and no converts, came
// within 1.24x of its bound).
// Design: two consecutive inputs a thread, loaded as one 4-byte word and
// evaluated together in one bf16x2 register each step: every recursion op
// is one native bf16x2 op (mul/add/sub.rn.bf16x2, kan_fused.cuh's
// spu_bf16x2) and needs no convert -- one rounding of the exact result is
// the f32 result rounded, so the bits are the plain version's. The location
// stays in f32; only the two positions are packed (one convert a pair). K
// is a template parameter, so the recursion unrolls to what K needs. The
// block's output stretch (block_n * (G+K) elements) is zeroed in shared
// memory with 16-byte stores, each pair's 2 (K+1) values are written into
// it (lanes' pairs sit G+K words apart, an odd stride at G4K3, so a warp's
// writes spread over the banks), and the stretch goes out with coalesced
// 16-byte streaming stores (spline_basis.cuh). `block_n` (inputs a block)
// stays the one knob: a block has min(block_n / 2, 256) threads, each with
// block_n / (2 * threads) pairs whose loads all go out before the first
// value is computed; it changes no bit.
#include "spline_basis.cuh"

namespace {

using kan_fused::bf16_widen;

// The cell of input `b` (bf16 bits) and its position in it, in f32, as
// spu() locates it; `r` not yet rounded.
__device__ __forceinline__ int locate(unsigned short b, float x0,
                                      float inv_h, int G, float* r) {
  const float u = __fmul_rn(__fsub_rn(bf16_widen(b), x0), inv_h);
  const float cf = fminf(fmaxf(floorf(u), 0.f), (float)(G - 1));
  *r = __fsub_rn(u, cf);
  return (int)cf;
}

template <int K, int PPT>
__global__ void __launch_bounds__(THREADS)
spline_basis_bf16_kernel(const unsigned short* __restrict__ x,
                         unsigned short* __restrict__ out, int n, int G,
                         float x0, float inv_h, int block_n) {
  extern __shared__ __align__(16) unsigned char s_bytes[];
  unsigned short* s_out = reinterpret_cast<unsigned short*>(s_bytes);
  const int nb = G + K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long i0 = (long long)blockIdx.x * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - i0);
  unsigned short* dst = out + i0 * nb;
  int head;
  unsigned short* row0 = stretch_start(s_out, dst, &head);
  const int elems = rows * nb;

  // pair q = k * nthr + tid: inputs 2q and 2q + 1 of the block (i0 is
  // even, so the pair is one aligned word where x is 4-byte aligned)
  const bool wide = (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  unsigned xw[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int il = 2 * (k * nthr + tid);
    const unsigned short* xp = x + i0 + il;
    if (il + 1 < rows && wide)
      xw[k] = __ldcs(reinterpret_cast<const unsigned*>(xp));
    else
      xw[k] = (il < rows ? __ldcs(xp) : 0u) |
              (il + 1 < rows ? (unsigned)__ldcs(xp + 1) << 16 : 0u);
  }
  // the stretch zeroed: elements off row0 - s_out .. of it, whole 16-byte
  // units (the slack smem_bytes holds covers the last)
  {
    const int nz = (int)(row0 - s_out) + elems;
    uint4* z = reinterpret_cast<uint4*>(s_out);
    for (int v = tid; v < (nz + 7) >> 3; v += nthr)
      z[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int il = 2 * (k * nthr + tid);
    if (il >= rows) continue;
    float ra, rb;
    const int ca = locate((unsigned short)(xw[k] & 0xffffu), x0, inv_h, G,
                          &ra);
    const int cb = locate((unsigned short)(xw[k] >> 16), x0, inv_h, G, &rb);
    // r rounded to bf16 (the recursion's first rounding), both in one convert
    const __nv_bfloat162 r2 = __floats2bfloat162_rn(ra, rb);
    unsigned vals2[K + 1];
    kan_fused::spu_bf16x2<K>(*reinterpret_cast<const unsigned*>(&r2),
                             vals2);
    unsigned short* pa = row0 + il * nb + ca;
    unsigned short* pb = row0 + (il + 1) * nb + cb;
    const bool has_b = il + 1 < rows;
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      // 0 + v, as the plain version's scatter sums it (a -0 becomes +0)
      const unsigned v = kan_fused::bf2_add(0u, vals2[j]);
      pa[j] = (unsigned short)(v & 0xffffu);
      if (has_b) pb[j] = (unsigned short)(v >> 16);
    }
  }
  __syncthreads();
  store_stretch(row0, dst, elems, head, tid, nthr);
}

template <int K, int PPT>
int run_bf16(const unsigned short* x, unsigned short* out, int n, int G,
             float x0, float inv_h, int block_n, int threads, int smem,
             cudaStream_t stream) {
  static unsigned configured = 0;
  return run(spline_basis_bf16_kernel<K, PPT>, &configured,
             ((long long)n + block_n - 1) / block_n, threads, smem, stream,
             x, out, n, G, x0, inv_h, block_n);
}

template <int K>
int run_k(const unsigned short* x, unsigned short* out, int n, int G,
          float x0, float inv_h, int block_n, int smem, cudaStream_t s) {
  const int threads = block_n / 2 < THREADS ? block_n / 2 : THREADS;
  switch (block_n / (2 * threads)) {
    case 1:
      return run_bf16<K, 1>(x, out, n, G, x0, inv_h, block_n, threads, smem,
                            s);
    case 2:
      return run_bf16<K, 2>(x, out, n, G, x0, inv_h, block_n, threads, smem,
                            s);
    case 4:
      return run_bf16<K, 4>(x, out, n, G, x0, inv_h, block_n, threads, smem,
                            s);
    default:
      return run_bf16<K, 8>(x, out, n, G, x0, inv_h, block_n, threads, smem,
                            s);
  }
}

}  // namespace

// x: (n,) bf16, contiguous; out: (n, G+K) bf16, contiguous, 2-byte
// aligned (any 16-byte alignment); both on the stream's device.  `inv_h`
// and `block_n` as for spline_basis_f32 (the output stretch is half as
// large in shared memory).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for bad sizes.
extern "C" int spline_basis_bf16(const void* x, void* out, int n, int G,
                                 int K, float x0, float inv_h, int block_n,
                                 void* stream) {
  const unsigned short* xs = static_cast<const unsigned short*>(x);
  unsigned short* os = static_cast<unsigned short*>(out);
  const long smem = checked_smem(os, n, G, K, block_n);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1:
      return run_k<1>(xs, os, n, G, x0, inv_h, block_n, (int)smem, s);
    case 2:
      return run_k<2>(xs, os, n, G, x0, inv_h, block_n, (int)smem, s);
    case 3:
      return run_k<3>(xs, os, n, G, x0, inv_h, block_n, (int)smem, s);
    default:
      return run_k<4>(xs, os, n, G, x0, inv_h, block_n, (int)smem, s);
  }
}
