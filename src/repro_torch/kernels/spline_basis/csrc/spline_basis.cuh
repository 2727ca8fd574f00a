// Dense B-spline basis values of a flat input (the VIKIN SPU array), for
// sm_90a: the kernel body of spline_basis.cu (f32) and
// spline_basis_bf16.cu (bf16), one template over the element type.
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
// order as the plain version (the SPU stage of kan_fused.cuh; at bf16 the
// location in f32 and every op of the recursion rounded to bf16, as the
// plain version runs on a bf16 tensor), and each output element is
// 0 + v_j inside cell..cell+K and +0 outside it, as the plain version's
// scatter sums it, so kernel and plain version agree bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each input
// costs one element in and G+K out against 4 + 2K + 5K(K+1)/2 operations
// (core/splines.spu_op_count): 32 bytes (f32; 16 at bf16) and 40
// operations per input at G4K3, far below the card's 20 operations per
// byte.  At n = 8192*304 (2.5 M inputs, G4K3) that is 80 MB in f32, 24 us
// (40 MB, 12 us, in bf16); the 70 MB f32 output does not fit in the 50 MB
// L2, so it is written at the device memory's rate or not at all.
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
  static constexpr bool kBF16 = false;
  __device__ static float load(const float* p) { return __ldcs(p); }
  __device__ static float put(float v) { return v; }
};

template <>
struct Elem<unsigned short> {
  using V = uint4;
  static constexpr int kLog = 3;
  static constexpr bool kBF16 = true;
  __device__ static float load(const unsigned short* p) {
    return kan_fused::bf16_widen(__ldcs(p));
  }
  __device__ static unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// Shared memory of a block (ops.kernel_smem mirrors it): its output
// stretch and up to one 16-byte store of alignment slack.
template <typename T>
inline long smem_bytes(int block_n, int nb) {
  return (long)sizeof(T) * ((long)block_n * nb + (1 << Elem<T>::kLog));
}

template <typename T, int IPT>
__global__ void __launch_bounds__(THREADS)
spline_basis_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                    int G, int K, float x0, float inv_h, int block_n) {
  using E = Elem<T>;
  using V = typename E::V;
  constexpr int PER = 1 << E::kLog;   // elements a 16-byte store
  extern __shared__ __align__(16) unsigned char s_bytes[];
  T* s_out = reinterpret_cast<T*>(s_bytes);
  const int nb = G + K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long i0 = (long long)blockIdx.x * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - i0);
  T* dst = out + i0 * nb;
  // elements of the stretch before its first 16-byte aligned one, and
  // where the stretch starts in shared memory so that element sits on 16
  // bytes
  const int head =
      (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) /
      (int)sizeof(T);
  T* row0 = s_out + ((PER - head) & (PER - 1));

  float xv[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int il = k * nthr + tid;
    xv[k] = il < rows ? E::load(x + i0 + il) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int il = k * nthr + tid;
    if (il < rows) {
      float vals[KMAX + 1];
      const int cell =
          kan_fused::spu<E::kBF16>(xv[k], x0, inv_h, G, K, vals);
      T* row = row0 + il * nb;
      for (int c = 0; c < nb; ++c) row[c] = T(0);
      // 0 + v, as the plain version's scatter sums it (a -0 becomes +0)
#pragma unroll
      for (int j = 0; j <= KMAX; ++j)
        if (j <= K) row[cell + j] = E::put(__fadd_rn(0.f, vals[j]));
    }
  }
  __syncthreads();

  const int elems = rows * nb;
  const int hd = min(head, elems);
  const int nvec = (elems - hd) >> E::kLog;
  if (tid < hd) __stcs(dst + tid, row0[tid]);
  const V* src4 = reinterpret_cast<const V*>(row0 + hd);
  V* dst4 = reinterpret_cast<V*>(dst + hd);
#pragma unroll 4
  for (int v = tid; v < nvec; v += nthr) __stcs(dst4 + v, src4[v]);
  const int t = hd + PER * nvec + tid;
  if (t < elems) __stcs(dst + t, row0[t]);
}

template <typename T, int IPT>
int run(const T* x, T* out, int n, int G, int K, float x0, float inv_h,
        int block_n, int threads, int smem, cudaStream_t stream) {
  void (*kern)(const T*, T*, int, int, int, float, float, int) =
      spline_basis_kernel<T, IPT>;
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

// Checks the sizes (ops.check_block_n checks the same) and launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue.
template <typename T>
int launch(const T* x, T* out, int n, int G, int K, float x0, float inv_h,
           int block_n, void* stream) {
  if (n <= 0 || G < 1 || K < 1 || K > KMAX || block_n < MIN_BLOCK_N ||
      block_n > MAX_BLOCK_N || (block_n & (block_n - 1)) != 0 ||
      reinterpret_cast<uintptr_t>(out) % sizeof(T) != 0)
    return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes<T>(block_n, G + K);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int threads = block_n < THREADS ? block_n : THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block_n / threads) {
    case 1:
      return run<T, 1>(x, out, n, G, K, x0, inv_h, block_n, threads,
                       (int)smem, s);
    case 2:
      return run<T, 2>(x, out, n, G, K, x0, inv_h, block_n, threads,
                       (int)smem, s);
    case 4:
      return run<T, 4>(x, out, n, G, K, x0, inv_h, block_n, threads,
                       (int)smem, s);
    case 8:
      return run<T, 8>(x, out, n, G, K, x0, inv_h, block_n, threads,
                       (int)smem, s);
    default:
      return run<T, 16>(x, out, n, G, K, x0, inv_h, block_n, threads,
                        (int)smem, s);
  }
}

}  // namespace
