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
//   * M = 8192, vikin-mixed's 72->304 relu and 16->96: 6.4 MB moved at
//     bf16 out (1.9 us) against 387 MFLOP (0.4 us) -- bytes bound.
// Design:
//   * bf16 tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.
//     f32, f32 accumulators, one warp on a (MT*16) x (NT*8) tile (32x32 at
//     the largest block tiles, 16x8 at bm = 16, bn = 8); at least 128
//     threads a block, the warps past the tile only stage;
//   * launch-time tiles bm x bn x bk, bk a multiple of 16.  A block stages
//     a bk-deep slab of its x rows (k contiguous) and of w_c's rows (n
//     contiguous, as w_c lies) with cp.async as wide as the rows' length
//     and alignment allow (16, 8 or 4 bytes; an element at a time on a
//     ragged row), waits once and multiplies; the default bk covers all of
//     Kc, so a serving-size call waits for one latency.  Past Kc the slab
//     is zero-filled in shared memory (Kc = 228 = 14 * 16 + 4; K = 72);
//   * operand A is read as 32-bit pairs from rows padded by 16 bytes, so a
//     warp's fragment loads hit 32 distinct banks; operand B ("col": k
//     pairs per n) comes from the row-major w_c slab by ldmatrix.x2.trans,
//     whose rows are padded to an odd number of 16-byte units;
//   * the epilogue stores two adjacent columns a thread, straight from
//     the accumulator fragment.
// The order of summation is part of the contract: each output is the
// chain of m16n8k16 steps over k = 0, 16, 32, .. ascending, up to Kc
// rounded up to 16 (a slab's zero steps past that are skipped), from a
// zero accumulator; an MMA's output element depends on its row of x, its
// column of w_c and its accumulator alone.  So every tile (bm, bk, bn)
// gives bitwise the same output and a row does not depend on its batch
// (batched == single).  The plain version (pattern_matmul/ref.py) sums
// the exact products in another order (an f32 matmul of the widened
// operands): kernel and plain version agree within a bf16 ulp at bf16
// out and within 1e-5 * (1 + max|out|) at f32 out.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "staging.cuh"

namespace {

using pm::apply_act;
using pm::cp_async;
using pm::MAX_SMEM;
using pm::Walk;

constexpr int MAX_THREADS = 512;
constexpr int MIN_THREADS = 128;   // a block stages with at least these
constexpr int APAD = 8;            // bf16 elements after each staged x row

// bf16 elements after each staged w_c row: a row is then an odd number of
// 16-byte units, so the 8 rows an ldmatrix reads sit on 8 distinct bank
// groups (pattern_matmul/ops.py kernel_smem mirrors it).
__host__ __device__ constexpr int bpad(int bn) {
  return bn == 8 ? 16 : 8;
}

// Warp tile by block tile: pattern_matmul/ops.py (kernel_threads)
// mirrors this rule.
constexpr int warp_mt(int bm) { return bm == 16 ? 1 : 2; }         // m16s
constexpr int warp_nt(int bn) { return bn >= 32 ? 4 : bn / 8; }    // n8s

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment of a 16 (k) x 8 (n) tile from a row-major [k][n] slab:
// lanes 0..15 give the addresses of rows k .. k+15.
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned* b,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(pm::smem_u32(p)));
}

__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

// Stage `rows` x `cols` elements of the row-major global array `g`
// (`ld` elements a row, `nrows` x `ncols` valid) at (r0, c0) into `s`
// (`lds` elements a row), BYTES a copy; out of range is zero.
template <int BYTES>
__device__ __forceinline__ void stage(unsigned short* s, int lds,
                                      const unsigned short* __restrict__ g,
                                      int ld, int nrows, int ncols, int r0,
                                      int c0, int rows, const Walk& walk) {
  constexpr int E = BYTES / 2;      // elements a copy
  walk.run(rows, [&](int r, int cq) {
    const int gr = r0 + r, gc = c0 + cq * E;
    // ncols % E == 0: a copy is all in or all out
    const bool ok = gr < nrows && gc < ncols;
    if constexpr (E == 1) {
      s[r * lds + cq] = ok ? g[(size_t)gr * ld + gc] : (unsigned short)0;
    } else {
      cp_async<BYTES>(s + r * lds + cq * E,
                      ok ? g + (size_t)gr * ld + gc : g, ok);
    }
  });
}

// One of the four copy widths, chosen at run time.
__device__ __forceinline__ void stage_any(int bytes, unsigned short* s,
                                          int lds, const unsigned short* g,
                                          int ld, int nrows, int ncols,
                                          int r0, int c0, int rows,
                                          const Walk& walk) {
  switch (bytes) {
    case 16:
      stage<16>(s, lds, g, ld, nrows, ncols, r0, c0, rows, walk);
      break;
    case 8:
      stage<8>(s, lds, g, ld, nrows, ncols, r0, c0, rows, walk);
      break;
    case 4:
      stage<4>(s, lds, g, ld, nrows, ncols, r0, c0, rows, walk);
      break;
    default:
      stage<2>(s, lds, g, ld, nrows, ncols, r0, c0, rows, walk);
  }
}

// The minimum of one resident block an SM: without it ptxas spilled two
// ints of the (1, 1) instance (bm = 16, bn = 8) across the k-loop.
template <int MT, int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
pattern_matmul_bf16_kernel(const unsigned short* __restrict__ x,
                           const unsigned short* __restrict__ w,
                           const unsigned short* __restrict__ bias,
                           void* __restrict__ y, int M, int K, int N,
                           int act, int out_f32, int bm, int bk, int bn,
                           int x_vec, int w_vec, int y_vec) {
  extern __shared__ float4 smem4[];
  unsigned short* smem = reinterpret_cast<unsigned short*>(smem4);
  constexpr int WM = MT * 16, WN = NT * 8;
  const int lda = bk + APAD;              // As: [bm][bk + APAD]
  const int ldb = bn + bpad(bn);          // Bs: [bk][bn + bpad]
  unsigned short* As = smem;
  unsigned short* Bs = smem + bm * lda;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warps_n = bn / WN;
  // Warps past the tile's only help to stage the slabs.
  const bool computes = warp < (bm / WM) * warps_n;
  const int wm0 = (warp / warps_n) * WM, wn0 = (warp % warps_n) * WN;
  const int row0 = blockIdx.x * bm;
  const int col0 = blockIdx.y * bn;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const Walk walk_x(bk / (x_vec / 2), tid, nthreads);
  const Walk walk_w(bn / (w_vec / 2), tid, nthreads);
  for (int k0 = 0; k0 < K; k0 += bk) {
    stage_any(x_vec, As, lda, x, K, M, K, row0, k0, bm, walk_x);
    stage_any(w_vec, Bs, ldb, w, N, K, N, k0, col0, bk, walk_w);
    cp_async_wait_all();
    __syncthreads();
    if (computes) {
      // the 16-deep steps up to Kc rounded up to 16: the same steps
      // whatever bk is
      const int kend = min(bk, (K - k0 + 15) / 16 * 16);
      for (int kk = 0; kk < kend; kk += 16) {
        unsigned a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const unsigned short* p =
              As + (wm0 + i * 16 + g) * lda + kk + 2 * tig;
          a[i][0] = *reinterpret_cast<const unsigned*>(p);
          a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * lda);
          a[i][2] = *reinterpret_cast<const unsigned*>(p + 8);
          a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * lda + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          ldmatrix_x2_trans(b[j],
                            Bs + (kk + (lane & 15)) * ldb + wn0 + j * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
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
        if (gm >= M || gn >= N) continue;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v[q] = acc[i][j][2 * h + q];
          if (bias != nullptr && gn + q < N)
            v[q] = __fadd_rn(v[q], widen(bias[gn + q]));
          v[q] = apply_act(v[q], act);
        }
        const size_t at = (size_t)gm * N + gn;
        if (out_f32) {
          float* dst = static_cast<float*>(y) + at;
          if (y_vec) {  // N even: both columns lie inside the row
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            dst[0] = v[0];
            if (gn + 1 < N) dst[1] = v[1];
          }
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(y) + at;
          if (y_vec) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            dst[0] = __float2bfloat16_rn(v[0]);
            if (gn + 1 < N) dst[1] = __float2bfloat16_rn(v[1]);
          }
        }
      }
}

template <int MT, int NT>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream,
                   const unsigned short* x, const unsigned short* w,
                   const unsigned short* bias, void* y, int M, int K, int N,
                   int act, int out_f32, int bm, int bk, int bn, int x_vec,
                   int w_vec, int y_vec) {
  // Once per instantiation: allow dynamic shared memory above 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      pattern_matmul_bf16_kernel<MT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  pattern_matmul_bf16_kernel<MT, NT><<<grid, threads, smem, stream>>>(
      x, w, bias, y, M, K, N, act, out_f32, bm, bk, bn, x_vec, w_vec,
      y_vec);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The widest copy (16, 8, 4 or 2 bytes) that rows of `len` elements of
// the array at `p` allow.
int copy_bytes(const void* p, int len) {
  for (int b = 16; b > 2; b /= 2)
    if (len % (b / 2) == 0 && aligned(p, b)) return b;
  return 2;
}

}  // namespace

// x: (M, K) bf16 row-major, w: (K, N) bf16 row-major, bias: (N,) bf16 or
// NULL, y: (M, N) bf16, or f32 where out_f32 != 0.  All contiguous, on
// the stream's device.  Tiles: bm in {16, 32, 64, 128}, bn in {8, 16, 32,
// 64, 128}, bk a positive multiple of 16; shared memory is 2 * (bm * (bk
// + 8) + bk * (bn + bpad(bn))) bytes and must fit in 227 KB
// (pattern_matmul/ops.py kernel_smem mirrors this).
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
  const long long smem =
      2LL * ((long long)bm * (bk + APAD) + (long long)bk * (bn + bpad(bn)));
  const long long gy = (N + bn - 1) / bn;
  if (smem > MAX_SMEM || threads > MAX_THREADS || gy > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + bm - 1) / bm, (unsigned)gy);
  const int x_vec = copy_bytes(x, K);
  const int w_vec = copy_bytes(w, N);
  const int y_vec = N % 2 == 0 && aligned(y, out_f32 ? 8 : 4);
  const unsigned short* xs = static_cast<const unsigned short*>(x);
  const unsigned short* ws = static_cast<const unsigned short*>(w);
  const unsigned short* bs = static_cast<const unsigned short*>(bias);
  cudaStream_t s = (cudaStream_t)stream;
#define PMB_LAUNCH(MT_, NT_)                                               \
  if (mt == MT_ && nt == NT_)                                              \
    return (int)launch<MT_, NT_>(grid, threads, (int)smem, s, xs, ws, bs, \
                                 y, M, K, N, act, out_f32, bm, bk, bn,    \
                                 x_vec, w_vec, y_vec);
  PMB_LAUNCH(1, 1) PMB_LAUNCH(1, 2) PMB_LAUNCH(1, 4)
  PMB_LAUNCH(2, 1) PMB_LAUNCH(2, 2) PMB_LAUNCH(2, 4)
#undef PMB_LAUNCH
  return (int)cudaErrorInvalidValue;
}
