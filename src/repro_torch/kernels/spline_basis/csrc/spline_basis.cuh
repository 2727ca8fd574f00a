// Dense B-spline basis values of a flat input (the VIKIN SPU array), for
// sm_90a: the f32 kernel body of spline_basis.cu, and the launch checks,
// the shared-memory stretch and its coalesced write that the bf16 kernel
// (spline_basis_bf16.cu, its own packed body) shares.
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
// output element is 0 + v_j inside cell..cell+K and +0 outside it, as the
// plain version's scatter sums it, so kernel and plain version agree bit
// for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each input
// costs one element in and G+K out against 4 + 2K + 5K(K+1)/2 operations
// (core/splines.spu_op_count): 32 bytes and 40 operations per input at
// G4K3, far below the card's 20 operations per byte.  At n = 8192*304
// (2.5 M inputs, G4K3) that is 80 MB, 24 us; the 70 MB output does not
// fit in the 50 MB L2, so it is written at the device memory's rate or
// not at all.
// Design: a block takes `block_n` consecutive inputs (the launch's one
// knob, autotuned; it changes no result), 256 threads, each with
// block_n / 256 inputs whose loads all go out before the first value is
// computed.  A thread evaluates each of its inputs' cell and K+1 values
// with spu() and writes the input's whole (G+K)-wide row into shared
// memory.  The block's output is one contiguous stretch of block_n*(G+K)
// elements, which the block then writes with coalesced 16-byte streaming
// stores (st.global.cs: nothing rereads the output), so a warp's store
// covers 512 contiguous bytes instead of touching a sector per row.  The
// stretch is placed in shared memory so that its first 16-byte aligned
// element in device memory sits on a 16-byte boundary there too; the
// elements before it and the tail are written one at a time, so an output
// that is not 16-byte aligned and a short last tile are handled alike.
#pragma once

#include <cstdint>

#include "../../kan_fused/csrc/kan_fused.cuh"

namespace {

using kan_fused::KMAX;

constexpr int THREADS = 256;
constexpr int MIN_BLOCK_N = 32;
constexpr int MAX_BLOCK_N = 4096;
constexpr int MAX_SMEM = 232448;      // 227 KB of shared memory a block

// The element type: f32, or bf16 held as its bit pattern.  `kLog` is
// log2 of the elements a 16-byte store `V` takes.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using V = float4;
  static constexpr int kLog = 2;
};

template <>
struct Elem<unsigned short> {
  using V = uint4;
  static constexpr int kLog = 3;
};

// Shared memory of a block (ops.kernel_smem mirrors it): its output
// stretch and up to one 16-byte store of alignment slack.
template <typename T>
inline long smem_bytes(int block_n, int nb) {
  return (long)sizeof(T) * ((long)block_n * nb + (1 << Elem<T>::kLog));
}

// Where a block's output stretch starts in shared memory `s_out`: its
// element that lands on dst's first 16-byte boundary sits on a 16-byte
// boundary there too.  `head` gets the elements before that boundary.
template <typename T>
__device__ __forceinline__ T* stretch_start(T* s_out, const T* dst,
                                            int* head) {
  constexpr int PER = 1 << Elem<T>::kLog;   // elements a 16-byte store
  *head = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) /
          (int)sizeof(T);
  return s_out + ((PER - *head) & (PER - 1));
}

// Writes the `elems` elements of the stretch at `row0` to `dst` with
// coalesced 16-byte streaming stores (st.global.cs: nothing rereads the
// output), the `head` elements before dst's first 16-byte boundary and
// the tail one at a time.  After a barrier that publishes the stretch.
template <typename T>
__device__ __forceinline__ void store_stretch(const T* row0, T* dst,
                                              int elems, int head, int tid,
                                              int nthr) {
  using V = typename Elem<T>::V;
  constexpr int PER = 1 << Elem<T>::kLog;
  const int hd = min(head, elems);
  const int nvec = (elems - hd) >> Elem<T>::kLog;
  if (tid < hd) __stcs(dst + tid, row0[tid]);
  const V* src4 = reinterpret_cast<const V*>(row0 + hd);
  V* dst4 = reinterpret_cast<V*>(dst + hd);
#pragma unroll 4
  for (int v = tid; v < nvec; v += nthr) __stcs(dst4 + v, src4[v]);
  const int t = hd + PER * nvec + tid;
  if (t < elems) __stcs(dst + t, row0[t]);
}

template <int IPT>
__global__ void __launch_bounds__(THREADS)
spline_basis_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int n, int G, int K, float x0, float inv_h,
                        int block_n) {
  extern __shared__ __align__(16) unsigned char s_bytes[];
  float* s_out = reinterpret_cast<float*>(s_bytes);
  const int nb = G + K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long i0 = (long long)blockIdx.x * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - i0);
  float* dst = out + i0 * nb;
  int head;
  float* row0 = stretch_start(s_out, dst, &head);

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
  store_stretch(row0, dst, rows * nb, head, tid, nthr);
}

// Sets `kern`'s dynamic shared-memory limit once a device (`configured`:
// a bit per device) and launches it on `grid` blocks; returns
// cudaGetLastError().
template <typename... P, typename... A>
int run(void (*kern)(P...), unsigned* configured, long long grid,
        int threads, int smem, cudaStream_t stream, A... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(*configured & (1u << dev))) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) *configured |= 1u << dev;
  }
  kern<<<(unsigned)grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The sizes either kernel takes (ops.check_block_n checks the same):
// returns the block's shared memory, or -1.
template <typename T>
long checked_smem(const T* out, int n, int G, int K, int block_n) {
  if (n <= 0 || G < 1 || K < 1 || K > KMAX || block_n < MIN_BLOCK_N ||
      block_n > MAX_BLOCK_N || (block_n & (block_n - 1)) != 0 ||
      reinterpret_cast<uintptr_t>(out) % sizeof(T) != 0)
    return -1;
  const long smem = smem_bytes<T>(block_n, G + K);
  return smem > MAX_SMEM ? -1 : smem;
}

template <int IPT>
int run_f32(const float* x, float* out, int n, int G, int K, float x0,
            float inv_h, int block_n, int threads, int smem,
            cudaStream_t stream) {
  static unsigned configured = 0;
  return run(spline_basis_f32_kernel<IPT>, &configured,
             ((long long)n + block_n - 1) / block_n, threads, smem, stream,
             x, out, n, G, K, x0, inv_h, block_n);
}

// Checks the sizes and launches the f32 kernel on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue.
inline int launch_f32(const float* x, float* out, int n, int G, int K,
                      float x0, float inv_h, int block_n, void* stream) {
  const long smem = checked_smem(out, n, G, K, block_n);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int threads = block_n < THREADS ? block_n : THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block_n / threads) {
    case 1:
      return run_f32<1>(x, out, n, G, K, x0, inv_h, block_n, threads,
                        (int)smem, s);
    case 2:
      return run_f32<2>(x, out, n, G, K, x0, inv_h, block_n, threads,
                        (int)smem, s);
    case 4:
      return run_f32<4>(x, out, n, G, K, x0, inv_h, block_n, threads,
                        (int)smem, s);
    case 8:
      return run_f32<8>(x, out, n, G, K, x0, inv_h, block_n, threads,
                        (int)smem, s);
    default:
      return run_f32<16>(x, out, n, G, K, x0, inv_h, block_n, threads,
                         (int)smem, s);
  }
}

}  // namespace
