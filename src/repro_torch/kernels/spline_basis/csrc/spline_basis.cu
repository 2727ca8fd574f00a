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
// order as the plain version (the SPU stage of kan_fused.cuh), and each
// output word is __fadd_rn(0, v_j) inside cell..cell+K and +0 outside it,
// as the plain version's scatter sums it, so kernel and plain version
// agree bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each input
// costs 4 bytes in and 4*(G+K) out against 4 + 2K + 5K(K+1)/2 operations
// (core/splines.spu_op_count): 32 bytes and 40 operations per input at
// G4K3, far below the card's 20 operations per byte.  At n = 8192*304 (2.5 M
// inputs, G4K3) that is 80 MB, 24 us; the 70 MB output does not fit in the
// 50 MB L2, so it is written at the device memory's rate or not at all.
// Design: a block takes `block_n` consecutive inputs (the launch's one
// knob, autotuned; it changes no result), 256 threads, each with
// block_n / 256 inputs whose loads all go out before the first value is
// computed.  A thread evaluates each of its inputs' cell and K+1 values
// with spu() and writes the input's whole (G+K)-wide row into shared
// memory.  The block's output is one contiguous stretch of block_n*(G+K)
// floats, which the block then writes with coalesced 16-byte streaming
// stores (st.global.cs: nothing rereads the output), so a warp's store
// covers 512 contiguous bytes instead of touching a sector per row.  The
// stretch is placed in shared memory so that its first 16-byte aligned
// word in device memory sits on a 16-byte boundary there too; the words
// before it and the tail are written one at a time, so an output that is
// not 16-byte aligned and a short last tile are handled alike.
#include <cstdint>

#include "../../kan_fused/csrc/kan_fused.cuh"

namespace {

using kan_fused::KMAX;

constexpr int THREADS = 256;
constexpr int MIN_BLOCK_N = 32;
constexpr int MAX_BLOCK_N = 4096;
constexpr int MAX_SMEM = 232448;      // 227 KB of shared memory a block

// Shared memory of a block (ops.kernel_smem mirrors it): its output
// stretch and up to 3 words of alignment slack, rounded to 16 bytes.
inline long smem_bytes(int block_n, int nb) {
  return 4L * ((long)block_n * nb + 4);
}

template <int IPT>
__global__ void __launch_bounds__(THREADS)
spline_basis_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, int G, int K, float x0, float inv_h,
                    int block_n) {
  extern __shared__ __align__(16) float s_out[];
  const int nb = G + K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long i0 = (long long)blockIdx.x * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - i0);
  float* dst = out + i0 * nb;
  // words of the stretch before its first 16-byte aligned one, and where
  // the stretch starts in shared memory so that word sits on 16 bytes
  const int head =
      (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  float* row0 = s_out + ((4 - head) & 3);

  float xv[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int il = k * nthr + tid;
    xv[k] = il < rows ? __ldcs(x + i0 + il) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int il = k * nthr + tid;
    if (il < rows) {
      float vals[KMAX + 1];
      const int cell = kan_fused::spu(xv[k], x0, inv_h, G, K, vals);
      float* row = row0 + il * nb;
      for (int c = 0; c < nb; ++c) row[c] = 0.f;
      // 0 + v, as the plain version's scatter sums it (a -0 becomes +0)
#pragma unroll
      for (int j = 0; j <= KMAX; ++j)
        if (j <= K) row[cell + j] = __fadd_rn(0.f, vals[j]);
    }
  }
  __syncthreads();

  const int words = rows * nb;
  const int hd = min(head, words);
  const int nvec = (words - hd) >> 2;
  if (tid < hd) __stcs(dst + tid, row0[tid]);
  const float4* src4 = reinterpret_cast<const float4*>(row0 + hd);
  float4* dst4 = reinterpret_cast<float4*>(dst + hd);
#pragma unroll 4
  for (int v = tid; v < nvec; v += nthr) __stcs(dst4 + v, src4[v]);
  const int t = hd + 4 * nvec + tid;
  if (t < words) __stcs(dst + t, row0[t]);
}

template <int IPT>
int run(const float* x, float* out, int n, int G, int K, float x0,
        float inv_h, int block_n, int threads, int smem,
        cudaStream_t stream) {
  void (*kern)(const float*, float*, int, int, int, float, float, int) =
      spline_basis_kernel<IPT>;
  static unsigned configured = 0;     // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) configured |= 1u << dev;
  }
  const long long grid = ((long long)n + block_n - 1) / block_n;
  kern<<<(unsigned)grid, threads, smem, stream>>>(x, out, n, G, K, x0,
                                                  inv_h, block_n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n,) f32, contiguous; out: (n, G+K) f32, contiguous, 4-byte aligned
// (any 16-byte alignment); both on the stream's device.  `inv_h` = G /
// (x1 - x0) as f32; `block_n` inputs a block, a power of two in 32..4096
// whose output stretch fits in shared memory.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for bad sizes (ops.check_block_n checks the
// same).
extern "C" int spline_basis_f32(const float* x, float* out, int n, int G,
                                int K, float x0, float inv_h, int block_n,
                                void* stream) {
  if (n <= 0 || G < 1 || K < 1 || K > KMAX || block_n < MIN_BLOCK_N ||
      block_n > MAX_BLOCK_N || (block_n & (block_n - 1)) != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes(block_n, G + K);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int threads = block_n < THREADS ? block_n : THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block_n / threads) {
    case 1:
      return run<1>(x, out, n, G, K, x0, inv_h, block_n, threads, (int)smem,
                    s);
    case 2:
      return run<2>(x, out, n, G, K, x0, inv_h, block_n, threads, (int)smem,
                    s);
    case 4:
      return run<4>(x, out, n, G, K, x0, inv_h, block_n, threads, (int)smem,
                    s);
    case 8:
      return run<8>(x, out, n, G, K, x0, inv_h, block_n, threads, (int)smem,
                    s);
    default:
      return run<16>(x, out, n, G, K, x0, inv_h, block_n, threads,
                     (int)smem, s);
  }
}
