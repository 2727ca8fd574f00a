// Pattern-sparse linear layer on bf16 operands: y = act(x_c @ w_c + bias),
// f32 accumulation, bf16 or f32 out, for sm_90a.
//
// Replaces the TPU kernel `matmul_compact_pallas` (body `_mm_kernel`) of
// src/repro/kernels/pattern_matmul/pattern_matmul.py on bf16 operands,
// with its `out_dtype` (x's dtype by default, or f32).  As in the f32
// kernel (pattern_matmul.cu), the static m-of-4 mask is applied outside:
// the wrapper gathers the kept activation lanes and the layer compacts
// its weight rows once.  The epilogue is the shared `bias_act` of
// kernels/epilogue.py in its order: the bias (bf16, widened exactly) is
// added to the finished f32 accumulator, then the activation, then one
// rounding to bf16 (or the f32 value as it is).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16 on tensor
// cores):
//   * serving buckets (M = 2..16; vikin-mixed 72->304 relu and Kc=16 ->96,
//     vikin-mlp3 72->304 relu and Kc=228 ->96): the bf16 weights are the
//     traffic (43.8 KB for 72x304), 13 ns of memory time against 0.35
//     MFLOP (0.4 ns) at M=8 -- bytes bound in principle, latency bound in
//     fact: the launch and every global round trip the block waits for;
//   * M = 8192, vikin-mixed's 72->304 relu and 16->96: 8.0 MB moved at
//     bf16 out (2.4 us), 6.6 MB of it the output, against 387 MFLOP
//     (0.4 us) -- bytes bound.  The first design (one block a 128 x 64
//     tile, 320 of them at 72->304) restaged w_c in every block, loaded,
//     multiplied and stored in lockstep, and stored 4 bytes a thread
//     straight from the accumulator fragments.
// Design:
//   * bf16 tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.
//     f32, f32 accumulators, one warp on a (MT*16) x (NT*8) tile (32x32 at
//     the largest block tiles, 16x8 at bm = 16, bn = 8); at least 128
//     threads a block, the warps past the tile only stage.  The bytes,
//     not the MMA rate, bound it, so mma.sync suffices;
//   * a persistent grid: grid.y the bn-wide column tiles, grid.x about
//     two blocks an SM between them (at most the row tiles), each block
//     walking the bm-row tiles blockIdx.x, + gridDim.x, ...  It stages
//     its column tile of w_c, all Kc rows (rounded up to 16, zero past
//     Kc), once and keeps it in shared memory (where that does not fit,
//     a bk-row slab of it rides with each x slab);
//   * x comes through a ring of two bk-deep slabs with cp.async groups:
//     the next slab's copies (of this row tile, or the next one's) are in
//     flight while this one multiplies and its tile is stored.  Copies
//     are as wide as the rows' length and alignment allow (16, 8 or 4
//     bytes; an element at a time on a ragged row); past Kc and M the
//     slab is zero-filled in shared memory;
//   * fragments by ldmatrix: A (x4) from x rows padded by 16 bytes, B
//     (x2.trans, "col": k pairs per n) from the row-major w_c rows padded
//     to an odd number of 16-byte units, both free of bank conflicts;
//   * the epilogue writes each warp's finished tile to shared memory, in
//     the output's dtype, and the warp stores it with 16-byte coalesced
//     stores (whole 32-byte sectors from bn = 16 on; an element at a time
//     where N or y's alignment do not allow them), with no block barrier.
//     The activation is a compile-time constant of the epilogue's loop
//     (with a run-time one switched there the kernel took 28% longer at
//     M = 8192);
//   * where M is one row tile (every serving bucket: M <= 16, bm = 16) a
//     second kernel runs the first design on the same grid: each bk slab
//     of x and w_c staged, waited for and multiplied in turn, the bias
//     read after the MMAs, the fragments stored straight to the output.
//     The persistent kernel's prologue (w_c's column tile and the bias
//     preload before the first wait) and its staged output put 8-11% on
//     such a launch, with nothing to reuse.  (Where each block has one
//     of several row tiles, as the 16->96 layer at M = 8192 with 128 x
//     64 tiles, the persistent kernel's stores keep it the faster.)
// The order of summation is part of the contract: each output is the
// chain of m16n8k16 steps over k = 0, 16, 32, .. ascending, up to Kc
// rounded up to 16 (a slab's zero steps past that are skipped), from a
// zero accumulator; an MMA's output element depends on its row of x, its
// column of w_c and its accumulator alone.  So every tile (bm, bk, bn)
// and every grid gives bitwise the same output, the first design's, and
// a row does not depend on its batch (batched == single).  The plain
// version (pattern_matmul/ref.py) sums the exact products in another
// order (an f32 matmul of the widened operands): kernel and plain version
// agree within a bf16 ulp at bf16 out and within 1e-5 * (1 + max|out|)
// at f32 out.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_bf16.cuh"

namespace {

using pm::apply_act;
using pm::bpad;
using pm::MAX_SMEM;
using pm::Walk;

constexpr int MAX_THREADS = 512;
constexpr int MIN_THREADS = 128;   // a block stages with at least these
constexpr int APAD = 8;            // bf16 elements after each staged x row
constexpr int STAGES = 2;          // x slabs in the ring
constexpr int OPAD = 16;           // bytes after each staged output row
constexpr int SM_SMEM = 233472;    // shared memory an SM, sm_90
constexpr int SM_REGS = 65536;
constexpr int SM_THREADS = 2048;

// Warp tile by block tile: pattern_matmul/ops.py (kernel_threads)
// mirrors this rule.
constexpr int warp_mt(int bm) { return bm == 16 ? 1 : 2; }         // m16s
constexpr int warp_nt(int bn) { return bn >= 32 ? 4 : bn / 8; }    // n8s

// Dynamic shared memory of a block (ops.kernel_smem mirrors it): the
// output tile (sized for f32 out), the column tile's bias (f32), the w_c
// rows -- all Kc rounded up to 16 where `resident`, else STAGES slabs of
// bk -- and STAGES x slabs.
long long smem_bytes(int bm, int bk, int bn, int k16, bool resident) {
  const long long wrows = resident ? k16 : (long long)STAGES * bk;
  return (long long)bm * (4 * bn + OPAD) + 4LL * bn +
         2LL * wrows * (bn + bpad(bn)) + 2LL * STAGES * bm * (bk + APAD);
}

struct Args {
  const unsigned short* x;
  const unsigned short* w;
  const unsigned short* bias;   // or NULL
  void* y;
  int M, K, N, act, out_f32, bm, bk, bn;
  int x_vec, w_vec, y_vec;      // copy bytes of x and w rows; 16-byte stores
  int y_pair;                   // two-column stores (the one-tile kernel)
  int resident;                 // w_c's column tile stays in shared memory
  int nslab;                    // bk slabs a row tile
  int tq, tr;                   // row tiles a block: tq, one more below tr
};

// A warp's staged output tile `o` (`ldo` bytes a row) to the output at `y`
// (`ldy` bytes a row): `rows` (at most ROWS) rows of CHUNKS 16-byte
// chunks, E elements each, with 16-byte stores; a chunk at or past `cols`
// elements is skipped (N a multiple of E: a chunk is all in or all out).
template <int ROWS, int CHUNKS, int E>
__device__ __forceinline__ void store_rows(unsigned char* y, size_t ldy,
                                           const unsigned char* o, int ldo,
                                           int rows, int cols, int lane) {
#pragma unroll
  for (int idx = lane; idx < ROWS * CHUNKS; idx += 32) {
    const int r = idx / CHUNKS, cq = idx % CHUNKS;
    if (r < rows && cq * E < cols)
      *reinterpret_cast<uint4*>(y + r * ldy + 16 * cq) =
          *reinterpret_cast<const uint4*>(o + r * ldo + 16 * cq);
  }
}

// The same an element at a time, COLS columns of T (f32, or bf16 bits).
template <int ROWS, int COLS, class T>
__device__ __forceinline__ void store_elems(unsigned char* y, size_t ldy,
                                            const unsigned char* o, int ldo,
                                            int rows, int cols, int lane) {
  for (int idx = lane; idx < ROWS * COLS; idx += 32) {
    const int r = idx / COLS, c = idx % COLS;
    if (r < rows && c < cols)
      *reinterpret_cast<T*>(y + r * ldy + c * sizeof(T)) =
          *reinterpret_cast<const T*>(o + r * ldo + c * sizeof(T));
  }
}

// acc += a warp's part of one staged slab: the 16-deep steps kk = 0, 16,
// .. below kend, A rows wm0.. of the x slab As, B columns wn0.. of the
// w_c rows Bs.
template <int MT, int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[MT][NT][4],
                                         const unsigned short* As, int lda,
                                         const unsigned short* Bs, int ldb,
                                         int kend, int wm0, int wn0,
                                         int lane) {
  for (int kk = 0; kk < kend; kk += 16) {
    unsigned af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      pm::ldmatrix_a(af[i], As + (wm0 + i * 16) * lda + kk, lda, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      pm::ldmatrix_b(bf[j], Bs + kk * ldb + wn0 + j * 8, ldb, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) pm::mma_bf16(acc[i][j], af[i], bf[j]);
  }
}

// Where M is one row tile: the first design.  Shared memory:
// one x slab [bm][bk + APAD] and one w_c slab [bk][bn + bpad].  The
// minimum of one resident block an SM: without it ptxas spilled two ints
// of the (1, 1) instance (bm = 16, bn = 8) across the k-loop.
template <int MT, int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
pattern_matmul_bf16_tile(const Args a) {
  extern __shared__ float4 smem4[];
  unsigned short* smem = reinterpret_cast<unsigned short*>(smem4);
  constexpr int WM = MT * 16, WN = NT * 8;
  const int bm = a.bm, bk = a.bk, bn = a.bn;
  const int lda = bk + APAD, ldb = bn + bpad(bn);
  unsigned short* As = smem;
  unsigned short* Bs = smem + bm * lda;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warps_n = bn / WN;
  // Warps past the tile's only help to stage the slabs.
  const bool computes = warp < (bm / WM) * warps_n;
  const int wm0 = (warp / warps_n) * WM, wn0 = (warp % warps_n) * WN;
  const int row0 = blockIdx.x * bm, col0 = blockIdx.y * bn;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const Walk walk_x(bk / (a.x_vec / 2), tid, blockDim.x);
  const Walk walk_w(bn / (a.w_vec / 2), tid, blockDim.x);
  for (int k0 = 0; k0 < a.K; k0 += bk) {
    pm::stage_any(a.x_vec, As, lda, a.x, a.K, a.M, a.K, row0, k0, bm,
                  walk_x);
    pm::stage_any(a.w_vec, Bs, ldb, a.w, a.N, a.K, a.N, k0, col0, bk,
                  walk_w);
    pm::cp_async_commit();
    pm::cp_async_wait_n<0>();
    __syncthreads();
    // the 16-deep steps up to Kc rounded up to 16
    if (computes)
      mma_slab<MT, NT>(acc, As, lda, Bs, ldb,
                       min(bk, (a.K - k0 + 15) / 16 * 16), wm0, wn0, lane);
    __syncthreads();
  }

  // Epilogue, in bias_act's order: the bias added to the finished
  // accumulator, then the activation, then one rounding (bf16 out).
  if (!computes) return;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = row0 + wm0 + i * 16 + g + 8 * h;
        const int gn = col0 + wn0 + j * 8 + 2 * tig;
        if (gm >= a.M || gn >= a.N) continue;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v[q] = acc[i][j][2 * h + q];
          if (a.bias != nullptr && gn + q < a.N)
            v[q] = __fadd_rn(v[q], pm::widen(a.bias[gn + q]));
          v[q] = apply_act(v[q], a.act);
        }
        const size_t at = (size_t)gm * a.N + gn;
        if (a.out_f32) {
          float* dst = static_cast<float*>(a.y) + at;
          if (a.y_pair) {  // N even: both columns lie inside the row
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            dst[0] = v[0];
            if (gn + 1 < a.N) dst[1] = v[1];
          }
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.y) + at;
          if (a.y_pair) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            dst[0] = __float2bfloat16_rn(v[0]);
            if (gn + 1 < a.N) dst[1] = __float2bfloat16_rn(v[1]);
          }
        }
      }
}

// The persistent kernel.  The minimum of one resident block an SM, as
// above.
template <int MT, int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
pattern_matmul_bf16_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  constexpr int WM = MT * 16, WN = NT * 8;
  const int bm = a.bm, bk = a.bk, bn = a.bn;
  const int k16 = (a.K + 15) / 16 * 16;
  const int nslab = a.nslab;
  const int lda = bk + APAD;              // x slab: [bm][bk + APAD]
  const int ldb = bn + bpad(bn);          // w_c rows: [k][bn + bpad]
  const int osz = a.out_f32 ? 4 : 2;
  const int ldo = bn * osz + OPAD;        // output tile: bytes a row
  unsigned char* s_out = smem;
  float* s_bias = reinterpret_cast<float*>(smem + bm * (4 * bn + OPAD));
  unsigned short* s_w = reinterpret_cast<unsigned short*>(s_bias + bn);
  unsigned short* s_x = s_w + (a.resident ? k16 : STAGES * bk) * ldb;
  const int xsz = bm * lda, wsz = bk * ldb;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warps_n = bn / WN;
  // Warps past the tile's only help to stage and store.
  const bool computes = warp < (bm / WM) * warps_n;
  const int wm0 = (warp / warps_n) * WM, wn0 = (warp % warps_n) * WN;
  const int col0 = blockIdx.y * bn;
  // row tiles blockIdx.x, + gridDim.x, ...: tq or tq + 1 of them
  const int steps = (a.tq + ((int)blockIdx.x < a.tr)) * nslab;
  const Walk walk_x(bk / (a.x_vec / 2), tid, nthreads);
  const Walk walk_w(bn / (a.w_vec / 2), tid, nthreads);

  // The next step to stage: its row tile and slab.  Every call commits a
  // group, empty past the last step, so the waits below count the same.
  int i_tile = 0, i_slab = 0, i_step = 0;
  auto issue = [&]() {
    if (i_step < steps) {
      const int buf = i_step % STAGES;
      const int row0 = ((int)blockIdx.x + i_tile * (int)gridDim.x) * bm;
      pm::stage_any(a.x_vec, s_x + buf * xsz, lda, a.x, a.K, a.M, a.K,
                    row0, i_slab * bk, bm, walk_x);
      if (!a.resident)
        pm::stage_any(a.w_vec, s_w + buf * wsz, ldb, a.w, a.N, a.K, a.N,
                      i_slab * bk, col0, bk, walk_w);
      if (++i_slab == nslab) {
        i_slab = 0;
        ++i_tile;
      }
    }
    ++i_step;
    pm::cp_async_commit();
  };
  // The column tile of w_c goes out with the first slab, in its group.
  if (a.resident)
    pm::stage_any(a.w_vec, s_w, ldb, a.w, a.N, a.K, a.N, 0, col0, k16,
                  walk_w);
  for (int s = 0; s < STAGES - 1; ++s) issue();
  // The column tile's bias, widened once, while the first slab is in
  // flight: the epilogue waits on no global load.  The first barrier
  // publishes it.
  for (int c = tid; c < bn; c += nthreads)
    s_bias[c] = a.bias != nullptr && col0 + c < a.N
                    ? pm::widen(a.bias[col0 + c])
                    : 0.f;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  int tile = 0, slab = 0;
  for (int s = 0; s < steps; ++s) {
    // step s's slab has landed; every thread is done with step s - 1, so
    // its buffer takes step s + STAGES - 1
    pm::cp_async_wait_n<STAGES - 2>();
    __syncthreads();
    issue();
    const int buf = s % STAGES;
    if (computes) {
      const unsigned short* As = s_x + buf * xsz;
      const unsigned short* Bs =
          a.resident ? s_w + slab * bk * ldb : s_w + buf * wsz;
      // the 16-deep steps up to Kc rounded up to 16: the same steps
      // whatever bk is
      mma_slab<MT, NT>(acc, As, lda, Bs, ldb, min(bk, k16 - slab * bk),
                       wm0, wn0, lane);
    }
    if (++slab < nslab) continue;
    slab = 0;
    const int row0 = ((int)blockIdx.x + tile * (int)gridDim.x) * bm;
    ++tile;
    // Epilogue, in bias_act's order: the bias added to the finished
    // accumulator, then the activation, then one rounding (bf16 out),
    // into the warp's part of the staged output tile, which the warp then
    // stores itself: no block barrier.  Its previous tile's stores
    // finished before this step's barrier.
    if (computes) {
      unsigned char* o = s_out + wm0 * ldo + wn0 * osz;
      // The activation is a constant of each copy of this loop: with a
      // run-time act switched in it the kernel took 28% longer at
      // M = 8192.
      auto finish = [&](auto act) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int c = j * 8 + 2 * tig;    // column in the warp tile
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v[2];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                // past N the value is never stored
                v[q] = acc[i][j][2 * h + q];
                if (a.bias != nullptr)
                  v[q] = __fadd_rn(v[q], s_bias[wn0 + c + q]);
                v[q] = apply_act(v[q], decltype(act)::value);
              }
              unsigned char* orow = o + (i * 16 + g + 8 * h) * ldo;
              if (a.out_f32)
                *reinterpret_cast<float2*>(orow + 4 * c) =
                    make_float2(v[0], v[1]);
              else
                *reinterpret_cast<__nv_bfloat162*>(orow + 2 * c) =
                    __floats2bfloat162_rn(v[0], v[1]);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
          }
      };
      switch (a.act) {
        case 1:
          finish(std::integral_constant<int, 1>());
          break;
        case 2:
          finish(std::integral_constant<int, 2>());
          break;
        case 3:
          finish(std::integral_constant<int, 3>());
          break;
        default:
          finish(std::integral_constant<int, 0>());
      }
      __syncwarp();
      const int rows = min(WM, a.M - row0 - wm0), n0 = col0 + wn0;
      unsigned char* y = static_cast<unsigned char*>(a.y) +
                         ((size_t)(row0 + wm0) * a.N + n0) * osz;
      const size_t ldy = (size_t)a.N * osz;
      if (a.y_vec && a.out_f32)
        store_rows<WM, 2 * NT, 4>(y, ldy, o, ldo, rows, a.N - n0, lane);
      else if (a.y_vec)
        store_rows<WM, NT, 8>(y, ldy, o, ldo, rows, a.N - n0, lane);
      else if (a.out_f32)
        store_elems<WM, WN, float>(y, ldy, o, ldo, rows, a.N - n0, lane);
      else
        store_elems<WM, WN, unsigned short>(y, ldy, o, ldo, rows, a.N - n0,
                                            lane);
    }
  }
}

template <int MT, int NT>
cudaError_t launch(dim3 grid, int threads, int smem, bool one,
                   cudaStream_t stream, const Args& a) {
  // Once per instantiation: allow dynamic shared memory above 48 KB.
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(pattern_matmul_bf16_kernel<MT, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM),
      cudaFuncSetAttribute(pattern_matmul_bf16_tile<MT, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM)};
  if (attr[one] != cudaSuccess) return attr[one];
  if (one)
    pattern_matmul_bf16_tile<MT, NT><<<grid, threads, smem, stream>>>(a);
  else
    pattern_matmul_bf16_kernel<MT, NT><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The SMs of the current device, read once a device.
int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 1;
  if (dev < 64 && count[dev] > 0) return count[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1)
    n = 1;
  if (dev < 64) count[dev] = n;
  return n;
}

}  // namespace

// x: (M, K) bf16 row-major, w: (K, N) bf16 row-major, bias: (N,) bf16 or
// NULL, y: (M, N) bf16, or f32 where out_f32 != 0.  All contiguous, on
// the stream's device.  Tiles: bm in {16, 32, 64, 128}, bn in {8, 16, 32,
// 64, 128}, bk a positive multiple of 16; shared memory (smem_bytes, w_c
// resident where that fits) must fit in 227 KB (pattern_matmul/ops.py
// kernel_smem mirrors this).
extern "C" int pattern_matmul_bf16(const void* x, const void* w,
                                   const void* bias, void* y, int M, int K,
                                   int N, int act, int out_f32, int bm,
                                   int bk, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const bool bm_ok = bm == 16 || bm == 32 || bm == 64 || bm == 128;
  const bool bn_ok = bn == 8 || bn == 16 || bn == 32 || bn == 64 || bn == 128;
  if (!bm_ok || !bn_ok || bk <= 0 || bk % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int mt = warp_mt(bm), nt = warp_nt(bn);
  int threads = (bm / (16 * mt)) * (bn / (8 * nt)) * 32;
  if (threads < MIN_THREADS) threads = MIN_THREADS;
  const int k16 = (K + 15) / 16 * 16, ldb = bn + bpad(bn);
  const bool resident = smem_bytes(bm, bk, bn, k16, true) <= MAX_SMEM;
  const long long smem = smem_bytes(bm, bk, bn, k16, resident);
  const long long gy = (N + bn - 1) / bn;
  if (smem > MAX_SMEM || threads > MAX_THREADS || gy > 65535)
    return (int)cudaErrorInvalidValue;
  // About two blocks an SM over the column tiles, as many as fit at once
  // (the launch bound caps a thread at 128 registers), at least one a
  // column tile and at most the row tiles.
  const long long rtiles = (M + (long long)bm - 1) / bm;
  long long per_sm = SM_SMEM / (smem + 1024);
  if (per_sm > SM_THREADS / threads) per_sm = SM_THREADS / threads;
  if (per_sm > SM_REGS / (threads * 128)) per_sm = SM_REGS / (threads * 128);
  if (per_sm > 2) per_sm = 2;
  if (per_sm < 1) per_sm = 1;
  long long gx = per_sm * sm_count() / gy;
  if (gx > rtiles) gx = rtiles;
  if (gx < 1) gx = 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  // One row tile: the first design's kernel, with its smaller shared
  // memory (the refusal above stays the persistent kernel's).
  const bool one = rtiles == 1;
  const long long launch_smem =
      one ? 2LL * ((long long)bm * (bk + APAD) + (long long)bk * ldb) : smem;
  const int osz = out_f32 ? 4 : 2;
  const Args a = {static_cast<const unsigned short*>(x),
                  static_cast<const unsigned short*>(w),
                  static_cast<const unsigned short*>(bias),
                  y, M, K, N, act, out_f32, bm, bk, bn,
                  pm::copy_bytes(x, K), pm::copy_bytes(w, N),
                  N % (16 / osz) == 0 && pm::aligned(y, 16),
                  N % 2 == 0 && pm::aligned(y, 2 * osz), resident,
                  K > 0 ? (k16 + bk - 1) / bk : 1, (int)(rtiles / gx),
                  (int)(rtiles % gx)};
  cudaStream_t s = (cudaStream_t)stream;
#define PMB_LAUNCH(MT_, NT_)                                               \
  if (mt == MT_ && nt == NT_)                                              \
    return (int)launch<MT_, NT_>(grid, threads, (int)launch_smem, one, s, \
                                 a);
  PMB_LAUNCH(1, 1) PMB_LAUNCH(1, 2) PMB_LAUNCH(1, 4)
  PMB_LAUNCH(2, 1) PMB_LAUNCH(2, 2) PMB_LAUNCH(2, 4)
#undef PMB_LAUNCH
  return (int)cudaErrorInvalidValue;
}
