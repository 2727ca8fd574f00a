// The bf16 KAN layers on tensor cores, version 2 (kan_fused_bf16.cu) and
// version 1 (kan_fused_v1_bf16.cu), for sm_90a, with kan_split.cuh's
// launch-time knobs (bm, bi, bn), knob checks, feature split and cluster
// launch.
//
// It runs the TPU kernel's algorithm (`_kan_kernel_v2`): per chunk of PC
// = 32 features, the activation tile [silu | kept bases] of each feature
// -- the plain version's `fused` tensor (kan_fused/ref.py), 0 where a
// kept basis is not among the K+1 local ones -- contracted against the
// chunk's fused [w_b ; t[kb]] rows in one dense product.  The dense tile
// does no more multiply-adds than the zero-free f32 chain does at vikin's
// widths (nbk + 1 = 6 rows a feature at G = 4, K = 3, pattern 0.5,
// against K + 2 = 5 FMAs), and does them on the tensor cores.  Per chunk a
// block
//   (1) has its raw bf16 x tile (bm x 32) and the chunk's 32 * (nbk+1)
//       weight rows (bn columns) staged with cp.async as wide as the rows
//       allow, not widened: the next chunk's weights and the x tile after
//       it are in flight while this chunk is computed;
//   (2) writes the A tile in shared memory, bf16, row-major, 32 * (nbk+1)
//       columns: per (row, feature) silu(x) computed in f32 and rounded
//       once to bf16, then nbk slots, each the bf16 de Boor value
//       (kan_fused.cuh's spu<true>, bitwise the plain version's) of the
//       kept basis it holds where that basis is among the K+1 local ones,
//       else 0; rows past B and features past n_in are 0, and at bm = 8
//       rows 8..15 stay 0, so the tile is one m16 tile;
//   (3) runs mma.sync m16n8k16 bf16 x bf16 -> f32 over the chunk's 32 *
//       (nbk+1) rows (a multiple of 16) ascending, from a zero
//       accumulator: A by ldmatrix.x4, B by ldmatrix.x2.trans from the
//       staged rows (both padded to an odd number of 16-byte units a row:
//       no bank conflicts), each compute warp 16 rows x WN * 8 columns
//       (at most 8 compute warps of the block's 256 or 512 threads).
// With two buffers of each (A tile, x, weights) a chunk takes one barrier,
// between (2) and (3), so a warp done with chunk l's MMAs goes on to
// chunk l+1's SPU work while the others still multiply.
// The summation contract of kan_split.cuh with the MMA chain for the fmaf
// chain: the output is chunk 0's partial, then __fadd_rn of each later
// chunk's in ascending chunk order; a bi below n_in splits the chunks
// over a thread-block cluster, and rank 0 adds the members' partials in
// that order through distributed shared memory.  An MMA's output element
// depends on its row of A, its column of B and its accumulator alone, so
// every knob gives the same bits and a row does not depend on its batch.
//
// Version 1 (`V1`) keeps the silu and spline sums apart, as the TPU
// kernel's two dots and the plain version's `s @ w_b + act @ t_flat`
// do.  Its A tile puts the chunk's 32 silu columns first, then the 32 *
// nbk kept-basis columns feature-major; its B rows are w_b's 32 rows of
// the chunk, then t_flat's 32 * nbk (one contiguous block each, staged
// from their own arrays with cp.async).  So the first two k16 steps are
// the silu MMA chain and the rest the spline chain: each keeps its own
// accumulators from zero a chunk and follows the contract above (chunk
// 0's partial, __fadd_rn of each later one in order, across the cluster
// where bi < n_in), and the output is __fadd_rn(silu total, spline
// total), rounded once.  The SPU pass is version 2's.
#pragma once

#include "../../pattern_matmul/csrc/mma_bf16.cuh"
#include "kan_split.cuh"

namespace kan_mma {

namespace cg = cooperative_groups;
using kan_split::Params;
using kan_split::PC;

constexpr int MAX_THREADS = 512;        // the SPU pass; compute warps <= 8
constexpr int XLD = PC + 8;             // bf16 elements a staged x row
constexpr int HDR_BYTES = 4 * kan_split::TABLE;   // the slot table

// A-tile rows: bm, at least one m16 tile.  bf16 elements an A-tile row:
// the chunk's 32 * (nbk+1) columns and 16 bytes.  (ops.kernel_smem
// mirrors both.)
__host__ __device__ constexpr int a_rows(int bm) { return bm < 16 ? 16 : bm; }
__host__ __device__ constexpr int a_ld(int nbk) { return PC * (nbk + 1) + 8; }

// n8 tiles a compute warp owns: the block's (a_rows / 16) x (bn / 8) MMA
// tiles over at most 8 warps, a warp one m16 row of them.
inline int warp_n8s(int bm, int bn) {
  const int tiles = a_rows(bm) / 16 * (bn / 8);
  return tiles <= 8 ? 1 : tiles / 8;
}

// Threads a block: the SPU pass runs on all of them, 256, or 512 from a
// 32 x 32 tile on -- but 256 for version 1 at 8 n8 tiles a warp, whose
// two chains' accumulators need more than the 128 registers 512 threads
// leave a thread (ops.kernel_threads mirrors it).
inline int threads_of(int bm, int bn, bool v1) {
  if (v1 && warp_n8s(bm, bn) == 8) return 256;
  return bm * bn >= 1024 ? 512 : 256;
}

// The block size a kernel instance is compiled for (its registers).
__host__ __device__ constexpr int max_threads(bool v1, int wn) {
  return v1 && wn == 8 ? 256 : MAX_THREADS;
}

// Dynamic shared memory of a block (ops.kernel_smem mirrors it): the slot
// table, a cluster member's chunk partials (f32, A-tile rows x bn, a set
// a chain), and `stages` raw weight buffers, x buffers and A tiles.
inline long smem_bytes(int bm, int bn, int nbk, int cpb, int nsplit,
                       int chains) {
  const long rows = (long)PC * (nbk + 1);
  const long stages = cpb > 1 ? 2 : 1;
  return HDR_BYTES +
         (nsplit > 1 ? 4L * chains * cpb * a_rows(bm) * bn : 0) +
         2 * stages *
             (rows * (bn + pm::bpad(bn)) + (long)bm * XLD +
              (long)a_rows(bm) * a_ld(nbk));
}

// The bf16 bits of a value that is a bf16 (exact).
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return (unsigned short)(__float_as_uint(v) >> 16);
}

// WN: n8 tiles a compute warp owns; KK: the spline order K, so that the
// SPU's loops over the K+1 local bases unroll to what K needs; V1:
// version 1 (two chains).
template <int WN, int KK, bool V1>
__global__ void __launch_bounds__(max_threads(V1, WN))
    kan_mma_kernel(const Params p) {
  constexpr int NC = V1 ? 2 : 1;          // accumulator chains
  extern __shared__ __align__(16) unsigned char smem_mma[];
  int* s_slot = reinterpret_cast<int*>(smem_mma);
  const int nbk1 = p.nbk + 1, rows = PC * nbk1;
  const int arows = a_rows(p.bm), lda = a_ld(p.nbk);
  const int ldb = p.bn + pm::bpad(p.bn);
  float* s_part = reinterpret_cast<float*>(smem_mma + HDR_BYTES);
  unsigned short* s_w = reinterpret_cast<unsigned short*>(
      s_part + (gridDim.z > 1 ? NC * p.cpb * arows * p.bn : 0));
  unsigned short* s_x = s_w + p.stages * rows * ldb;
  unsigned short* s_a = s_x + p.stages * p.bm * XLD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * p.bm, n0 = blockIdx.y * p.bn;
  const int c0 = blockIdx.z * p.cpb;
  const int nloc = max(0, min(p.cpb, p.nchunks - c0));
  const unsigned short* x = static_cast<const unsigned short*>(p.x);
  const unsigned short* wt = static_cast<const unsigned short*>(p.wt);
  const unsigned short* tf = static_cast<const unsigned short*>(p.t_flat);
  const int nthr = blockDim.x;
  const pm::Walk walk_w(p.bn / (p.vec_w / 2), tid, nthr);
  const pm::Walk walk_x(PC / (p.vec_x / 2), tid, nthr);
  const int sm = p.stages - 1;             // buffer of chunk l: l & sm
  // chunk l's weight rows, zero past n_in and n_out: version 2 the fused
  // rows p0 * (nbk+1) ..; version 1 w_b's rows p0 .. p0+31, then
  // t_flat's p0 * nbk .. (p0+32) * nbk - 1
  auto issue_w = [&](int l) {
    unsigned short* dst = s_w + (l & sm) * rows * ldb;
    const int p0 = (c0 + l) * PC;
    if constexpr (V1) {
      pm::stage_any(p.vec_w, dst, ldb, wt, p.n_out, p.n_in, p.n_out, p0, n0,
                    PC, walk_w);
      pm::stage_any(p.vec_w, dst + PC * ldb, ldb, tf, p.n_out,
                    p.n_in * p.nbk, p.n_out, p0 * p.nbk, n0, PC * p.nbk,
                    walk_w);
    } else {
      pm::stage_any(p.vec_w, dst, ldb, wt, p.n_out, p.n_in * nbk1, p.n_out,
                    p0 * nbk1, n0, rows, walk_w);
    }
  };
  // chunk l's x tile, zero past B and n_in
  auto issue_x = [&](int l) {
    pm::stage_any(p.vec_x, s_x + (l & sm) * p.bm * XLD, XLD, x, p.n_in, p.B,
                  p.n_in, b0, (c0 + l) * PC, p.bm, walk_x);
  };

  // x of chunk 0 alone, then the weights of chunk 0 with x of chunk 1;
  // the slot table and the A tiles' zero rows meanwhile.
  if (nloc > 0) issue_x(0);
  pm::cp_async_commit();
  if (nloc > 0) issue_w(0);
  if (nloc > 1) issue_x(1);
  pm::cp_async_commit();
  if (tid < p.n_bases) s_slot[tid] = __ldg(&p.slot_of[tid]);
  for (int b = 0; b < p.stages; ++b)
    for (int e = tid; e < (arows - p.bm) * lda / 2; e += nthr)
      reinterpret_cast<unsigned*>(s_a + (b * arows + p.bm) * lda)[e] = 0u;
  pm::cp_async_wait_n<1>();
  __syncthreads();

  const int warps_n = p.bn / (8 * WN);
  const int cwarps = arows / 16 * warps_n;     // compute warps
  const bool computes = warp < cwarps;
  const int wm0 = (warp / warps_n) * 16, wn0 = (warp % warps_n) * WN * 8;
  float total[NC][WN][4];
#pragma unroll
  for (int h = 0; h < NC; ++h)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[h][j][q] = 0.f;

  // One barrier a chunk: a warp done with chunk l's MMAs goes on to chunk
  // l+1's SPU work while others still multiply.  Chunk l's A tile and x
  // tile, and its weights, sit in buffers l & sm; chunk l+1's weights and
  // chunk l+2's x go out right after the barrier, into the buffers chunk
  // l-1's MMAs and chunk l's SPU pass, both done by then, have left.
  for (int l = 0; l < nloc; ++l) {
    const int p0 = (c0 + l) * PC;
    unsigned short* s_al = s_a + (l & sm) * arows * lda;

    // SIMD + SPU + TSE: the chunk's A tile
    const unsigned short* xs = s_x + (l & sm) * p.bm * XLD;
    for (int e = tid; e < p.bm * PC; e += nthr) {
      const int bl = e >> 5, pl = e & (PC - 1);
      // the feature's silu column and its nbk kept-basis columns
      unsigned short* row = s_al + bl * lda;
      unsigned short* sil = V1 ? row + pl : row + pl * nbk1;
      unsigned short* seg = V1 ? row + PC + pl * p.nbk : sil + 1;
      for (int s = 0; s < p.nbk; ++s) seg[s] = 0;
      unsigned short silu = 0;
      if (b0 + bl < p.B && p0 + pl < p.n_in) {
        const float xv = pm::widen(xs[bl * XLD + pl]);
        // The KAN layer evaluates its bases on x clipped to [x0, x1 - eps);
        // torch clamps a bf16 tensor to bounds rounded to bf16.
        float vals[kan_split::KMAX + 1];
        const int cell = kan_fused::spu<true>(
            kan_fused::rnd<true>(fminf(fmaxf(xv, p.x0), p.hi)), p.x0,
            p.inv_h, p.G, KK, vals);
        silu = bf16_bits(
            kan_fused::rnd<true>(xv * (1.f / (1.f + expf(-xv)))));
#pragma unroll
        for (int j = 0; j <= KK; ++j) {
          const int slot = s_slot[cell + j];
          if (slot >= 0) seg[slot] = bf16_bits(vals[j]);
        }
      }
      *sil = silu;
    }
    // chunk l's weights (and chunk l+1's x) have landed
    pm::cp_async_wait_n<0>();
    __syncthreads();
    if (l + 1 < nloc) issue_w(l + 1);
    if (l + 2 < nloc) issue_x(l + 2);
    pm::cp_async_commit();

    if (computes) {
      const unsigned short* as = s_al + wm0 * lda;
      const unsigned short* ws = s_w + (l & sm) * rows * ldb + wn0;
      // chain h's k16 steps: version 1 the silu columns (h = 0), then the
      // kept-basis columns (h = 1); version 2 all of them
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int k0 = V1 && h == 1 ? PC : 0;
        const int k1 = V1 && h == 0 ? PC : rows;
        float part[WN][4];
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
        for (int k = k0; k < k1; k += 16) {
          unsigned af[4], bf[WN][2];
          pm::ldmatrix_a(af, as + k, lda, lane);
#pragma unroll
          for (int j = 0; j < WN; ++j)
            pm::ldmatrix_b(bf[j], ws + k * ldb + j * 8, ldb, lane);
#pragma unroll
          for (int j = 0; j < WN; ++j) pm::mma_bf16(part[j], af, bf[j]);
        }
        if (blockIdx.z == 0) {
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              total[h][j][q] = l == 0 ? part[j][q]
                                      : __fadd_rn(total[h][j][q], part[j][q]);
        } else {
          float* sp = s_part + ((h * p.cpb + l) * cwarps + warp) * WN * 4 * 32 +
                      lane;
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) sp[(j * 4 + q) * 32] = part[j][q];
        }
      }
    }
  }

  if (gridDim.z > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                   // every member's partials are staged
    if (blockIdx.z == 0 && computes) {
      // chunks cpb .. nchunks-1 in order: chunk c is member c / cpb's
      // local chunk c % cpb
      int r = 1, l = 0;
      for (int c = p.cpb; c < p.nchunks; ++c) {
        const float* rs = cluster.map_shared_rank(s_part, r);
#pragma unroll
        for (int h = 0; h < NC; ++h) {
          const float* rp =
              rs + ((h * p.cpb + l) * cwarps + warp) * WN * 4 * 32 + lane;
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              total[h][j][q] =
                  __fadd_rn(total[h][j][q], rp[(j * 4 + q) * 32]);
        }
        if (++l == p.cpb) {
          l = 0;
          ++r;
        }
      }
    }
    cluster.sync();                   // no member leaves while read
  }

  if (blockIdx.z != 0 || !computes) return;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm0 + g + 8 * h, b = b0 + row;
      const int n = n0 + wn0 + j * 8 + 2 * tig;
      if (row >= p.bm || b >= p.B || n >= p.n_out) continue;
      // version 1: the silu and spline totals added once
      const float v0 = V1 ? __fadd_rn(total[0][j][2 * h],
                                      total[NC - 1][j][2 * h])
                          : total[0][j][2 * h];
      const float v1 = V1 ? __fadd_rn(total[0][j][2 * h + 1],
                                      total[NC - 1][j][2 * h + 1])
                          : total[0][j][2 * h + 1];
      const size_t at = (size_t)b * p.n_out + n;
      if (p.out_bf16) {
        // one rounding of the f32 total to bf16
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + at;
        if (p.vec_out) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (n + 1 < p.n_out) o[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* o = static_cast<float*>(p.out) + at;
        if (p.vec_out) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < p.n_out) o[1] = v1;
        }
      }
    }
}

// The instance for the layer's K (plan() checked 1 <= K <= KMAX).
template <int WN, bool V1>
int run_k(const Params& p, dim3 grid, int threads, int smem,
          cudaStream_t s) {
  switch (p.K) {
    case 1:
      return kan_split::run<kan_mma_kernel<WN, 1, V1>>(p, grid, threads,
                                                       smem, s);
    case 2:
      return kan_split::run<kan_mma_kernel<WN, 2, V1>>(p, grid, threads,
                                                       smem, s);
    case 3:
      return kan_split::run<kan_mma_kernel<WN, 3, V1>>(p, grid, threads,
                                                       smem, s);
    default:
      return kan_split::run<kan_mma_kernel<WN, 4, V1>>(p, grid, threads,
                                                       smem, s);
  }
}

// Checks the sizes and knobs (kan_split.cuh's; ops.check_blocks checks the
// same) and launches version 2, or version 1 (`V1`: p.wt is w_b, p.t_flat
// the kept-basis rows), on `stream`; returns cudaGetLastError().
template <bool V1>
int launch(Params p, int bm, int bi, int bn, void* stream) {
  int e = kan_split::plan(p, bm, bi, bn, kan_split::MAX_TILE);
  if (e != 0) return e;
  const long smem = smem_bytes(bm, bn, p.nbk, p.cpb,
                               kan_split::nsplit_of(p), V1 ? 2 : 1);
  dim3 grid;
  e = kan_split::grid_of(p, smem, &grid);
  if (e != 0) return e;
  // copy bytes of the weight (both arrays' at version 1) and x rows; the
  // output by pairs
  p.vec_w = pm::copy_bytes(p.wt, p.n_out);
  if (V1) {
    const int vt = pm::copy_bytes(p.t_flat, p.n_out);
    if (vt < p.vec_w) p.vec_w = vt;
  }
  p.vec_x = pm::copy_bytes(p.x, p.n_in);
  p.vec_out = p.n_out % 2 == 0 && pm::aligned(p.out, p.out_bf16 ? 4 : 8);
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = threads_of(bm, bn, V1);
  switch (warp_n8s(bm, bn)) {
    case 1:
      return run_k<1, V1>(p, grid, threads, (int)smem, s);
    case 2:
      return run_k<2, V1>(p, grid, threads, (int)smem, s);
    case 4:
      return run_k<4, V1>(p, grid, threads, (int)smem, s);
    default:
      return run_k<8, V1>(p, grid, threads, (int)smem, s);
  }
}

}  // namespace kan_mma
