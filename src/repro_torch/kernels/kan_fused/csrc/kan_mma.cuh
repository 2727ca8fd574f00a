// The KAN layers on tensor cores, for sm_90a, with kan_split.cuh's
// launch-time knobs (bm, bi, bn), knob checks, feature split and cluster
// launch: version 2 on bf16 rows (kan_fused_bf16.cu), version 1 on bf16
// rows (kan_fused_v1_bf16.cu), and version 2 of a bf16 x against f32
// fused rows split into three exact bf16 planes (kan_fused_mixed.cu).
// `Rows` names the three cases.
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
//       allow, not widened (f32 rows as f32): the next chunk's weights
//       are in flight while this chunk is computed;
//   (2) writes the A tile in shared memory, bf16, row-major, 32 * (nbk+1)
//       columns: per (row, feature) silu(x) computed in f32 and rounded
//       once to bf16, then nbk slots, each the bf16 de Boor value of the
//       kept basis it holds where that basis is among the K+1 local ones,
//       else 0; rows past B and features past n_in are 0, and at bm = 8
//       rows 8..15 stay 0, so the tile is one m16 tile.  A thread takes
//       two neighbouring features of a row: their x is one 4-byte word,
//       the cells are located in f32 one by one, and the two recursions
//       run together in bf16x2 (kan_fused.cuh's spu_bf16x2, each half
//       bitwise the plain version's values).  With f32 rows
//       the same pass splits the chunk's staged rows into the three plane
//       tiles (below);
//   (3) runs mma.sync m16n8k16 bf16 x bf16 -> f32 over the chunk's 32 *
//       (nbk+1) rows (a multiple of 16) ascending, from a zero
//       accumulator: A by ldmatrix.x4, B by ldmatrix.x2.trans from the
//       staged rows or the plane tiles (both padded to an odd number of
//       16-byte units a row: no bank conflicts), each compute warp 16 rows
//       x WN * 8 columns (at most 8 compute warps of the block's 256 or
//       512 threads).
// bf16 rows: with two buffers of each a chunk takes one barrier, between
// (2) and (3), so a warp done with chunk l's MMAs goes on to chunk l+1's
// pass (2) while the others still multiply.  f32 rows: two buffers of
// the x tile and the f32 rows, one A tile and one plane tile, and a
// second barrier after (3).  The f32 rows and their planes take 10 bytes
// a weight column a stage, so one tile each is what lets a 64 x 64 block
// fit (211 KB at nbk = 5; two of each would cap it at 64 x 32): the SPU
// pass, the largest part of pass (2), is repeated once a 64-column tile
// instead of once a 32-column one.
// The summation contract of kan_split.cuh with the MMA chain (f32 rows:
// the chain of step sums) for the fmaf chain: the output is chunk 0's
// partial, then __fadd_rn of each later
// chunk's in ascending chunk order; a bi below n_in splits the chunks
// over a thread-block cluster, and rank 0 adds the members' partials in
// that order through distributed shared memory.  An MMA's output element
// depends on its row of A, its column of B and its accumulator alone, so
// every knob gives the same bits and a row does not depend on its batch.
//
// Version 1 (`BF16_V1`) keeps the silu and spline sums apart, as the TPU
// kernel's two dots and the plain version's `s @ w_b + act @ t_flat`
// do.  Its A tile puts the chunk's 32 silu columns first, then the 32 *
// nbk kept-basis columns feature-major; its B rows are w_b's 32 rows of
// the chunk, then t_flat's 32 * nbk (one contiguous block each, staged
// from their own arrays with cp.async).  So the first two k16 steps are
// the silu MMA chain and the rest the spline chain: each keeps its own
// accumulators from zero a chunk and follows the contract above (chunk
// 0's partial, __fadd_rn of each later one in order, across the cluster
// where bi < n_in), and the output is __fadd_rn(silu total, spline
// total), rounded once.
//
// f32 rows (`F32_PLANES`).  Every f32 weight w is the exact sum of three
// bf16 values: hi = w with its low 16 bits cleared (w rounded toward
// zero to 8 significant bits), mid = (w - hi) likewise, lo = w - hi -
// mid.  Both subtractions are exact in f32, w - hi keeps at most 16
// significant bits and w - hi - mid at most 8, so lo is a bf16 value and
// hi + mid + lo == w -- for every finite w, the largest too (rounding
// toward zero never overflows to inf).  The split needs one f32 row
// buffer and a plane tile a stage: the chunk's f32 rows are staged with
// cp.async (kan_split.cuh's issue_w_f32) and split in pass (2) into one
// tile whose rows hold the hi, mid and lo columns side by side, padded to
// an odd number of 16-byte units, read by ldmatrix.x2.trans unchanged.
// Each k16 step runs three MMAs, always lo, mid, hi, into an accumulator
// from zero, and adds it to the chunk's partial with __fadd_rn.  Each
// activation is a bf16 value and each product of two bf16 values is
// exact in f32, so a.w = a.lo + a.mid + a.hi exactly: the kernel computes
// the plain version's products (an f32 matmul of the widened activations
// against w) and differs from it only in the order and rounding of the
// f32 sums -- within 1e-5 * (1 + max|out|) at f32 out, one bf16 ulp at
// bf16 out.  The tensor cores' adds need not round to nearest, and they
// err at the magnitude of the accumulator: one accumulator over a
// chunk's 36 MMAs (the first form of this design) set a bf16 output of a
// 1024 x 608 -> 896 layer one ulp from the plain version's on an H100.
// From zero, a step's MMAs add at the step's magnitude, and the step sums
// round to nearest.
// The underflow edge: where w - hi - mid falls below 2^-126 (|w| below
// about 2^-110) it may have bits under bf16's subnormal step 2^-133,
// which the split drops, and a tensor core may flush subnormal operands
// to zero; either way a weight loses less than 2^-125 and a product less
// than 2^-125 |a| -- under 3e-38 |a|, far inside the tolerance.
// Non-finite weights: w = inf gives hi = inf and mid = inf - inf = NaN,
// and a NaN w gives NaN planes, so every output of that column is NaN;
// the plain version's is non-finite there too (a nonzero activation times
// inf is inf, a zero one NaN), so the kernel gives NaN wherever such a
// weight makes the plain version non-finite.
#pragma once

#include "../../pattern_matmul/csrc/mma_bf16.cuh"
#include "kan_split.cuh"

namespace kan_mma {

namespace cg = cooperative_groups;
using kan_split::Params;
using kan_split::PC;

// The weight rows a body contracts: bf16 fused rows (version 2), bf16 w_b
// and t_flat (version 1), or f32 fused rows split into three bf16 planes.
enum Rows { BF16_V2 = 0, BF16_V1 = 1, F32_PLANES = 2 };

constexpr int MAX_THREADS = 512;        // pass (2); compute warps <= 8
constexpr int XLD = PC + 8;             // bf16 elements a staged x row
constexpr int HDR_BYTES = 4 * kan_split::TABLE;   // the slot table

// A-tile rows: bm, at least one m16 tile.  bf16 elements an A-tile row:
// the chunk's 32 * (nbk+1) columns and 16 bytes.  bf16 elements a
// plane-tile row: hi, mid and lo (bn each), padded to an odd number of
// 16-byte units (3 at bn = 8).  (ops.kernel_smem mirrors all three.)
__host__ __device__ constexpr int a_rows(int bm) { return bm < 16 ? 16 : bm; }
__host__ __device__ constexpr int a_ld(int nbk) { return PC * (nbk + 1) + 8; }
__host__ __device__ constexpr int p_ld(int bn) {
  return 3 * bn + (bn == 8 ? 0 : 8);
}

// n8 tiles a compute warp owns: the block's (a_rows / 16) x (bn / 8) MMA
// tiles over at most 8 warps, a warp one m16 row of them.
inline int warp_n8s(int bm, int bn) {
  const int tiles = a_rows(bm) / 16 * (bn / 8);
  return tiles <= 8 ? 1 : tiles / 8;
}

// Threads a block: pass (2) runs on all of them, 256, or 512 from a
// 32 x 32 tile on -- but 256 at 8 n8 tiles a warp for version 1, whose
// two chains' accumulators need more than the 128 registers 512 threads
// leave a thread, and for f32 rows, whose three planes' B fragments are
// live beside them (ops.kernel_threads mirrors it).
inline int threads_of(int bm, int bn, int rows) {
  if (rows != BF16_V2 && warp_n8s(bm, bn) == 8) return 256;
  return bm * bn >= 1024 ? 512 : 256;
}

// The block size a kernel instance is compiled for (its registers).
__host__ __device__ constexpr int max_threads(int rows, int wn) {
  return rows != BF16_V2 && wn == 8 ? 256 : MAX_THREADS;
}

// Dynamic shared memory of a block (ops.kernel_smem mirrors it): the slot
// table, a cluster member's chunk partials (f32, A-tile rows x bn, a set
// a chain), and `stages` x buffers with, for bf16 rows, `stages` raw row
// buffers and A tiles; for f32 rows, `stages` f32 row buffers and one
// plane tile and one A tile.
inline long smem_bytes(int bm, int bn, int nbk, int cpb, int nsplit,
                       int rows_kind) {
  const long rows = (long)PC * (nbk + 1);
  const long stages = cpb > 1 ? 2 : 1;
  const long chains = rows_kind == BF16_V1 ? 2 : 1;
  const long a_tile = 2L * a_rows(bm) * a_ld(nbk);
  const long tiles =
      rows_kind == F32_PLANES
          ? stages * (4L * rows * bn + 2L * bm * XLD) + 2L * rows * p_ld(bn) +
                a_tile
          : stages * (2L * rows * (bn + pm::bpad(bn)) + 2L * bm * XLD +
                      a_tile);
  return HDR_BYTES +
         (nsplit > 1 ? 4 * chains * cpb * a_rows(bm) * bn : 0) + tiles;
}

// The bf16 bits of two values, rounded to nearest (ties to even) each:
// the low half `a`'s, the high half `b`'s.
__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The cell of the clipped input `xc` (a bf16 value) and its position in
// it, in f32, as spu() locates them; `r` not yet rounded.
__device__ __forceinline__ int locate(float xc, const Params& p, float* r) {
  const float u = __fmul_rn(__fsub_rn(xc, p.x0), p.inv_h);
  const float cf = fminf(fmaxf(floorf(u), 0.f), (float)(p.G - 1));
  *r = __fsub_rn(u, cf);
  return (int)cf;
}

// silu(x) in f32, as the plain version computes it before its one
// rounding to bf16.
__device__ __forceinline__ float silu_f32(float x) {
  return x * (1.f / (1.f + expf(-x)));
}

// The three planes of two f32 weights a, b: each result holds the bf16
// bits of a's plane in its low half and b's in its high half.
__device__ __forceinline__ void split_pair(float a, float b, unsigned* hi,
                                           unsigned* mid, unsigned* lo) {
  const unsigned ab = __float_as_uint(a), bb = __float_as_uint(b);
  const float ra = __fsub_rn(a, __uint_as_float(ab & 0xffff0000u));
  const float rb = __fsub_rn(b, __uint_as_float(bb & 0xffff0000u));
  const unsigned rab = __float_as_uint(ra), rbb = __float_as_uint(rb);
  const float sa = __fsub_rn(ra, __uint_as_float(rab & 0xffff0000u));
  const float sb = __fsub_rn(rb, __uint_as_float(rbb & 0xffff0000u));
  *hi = __byte_perm(ab, bb, 0x7632);
  *mid = __byte_perm(rab, rbb, 0x7632);
  *lo = __byte_perm(__float_as_uint(sa), __float_as_uint(sb), 0x7632);
}

// d = a * b on one 16 x 8 x 16 tile from a zero accumulator: bf16
// operands, f32 results.
__device__ __forceinline__ void mma_bf16_from_zero(float* d,
                                                   const unsigned* a,
                                                   const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The kernel body.  WN: n8 tiles a compute warp owns; KK: the spline
// order K, so that the SPU's loops over the K+1 local bases unroll to
// what K needs; R: the weight rows (`Rows`).
template <int WN, int KK, int R>
__device__ __forceinline__ void kan_mma_body(const Params& p) {
  constexpr bool V1 = R == BF16_V1, P3 = R == F32_PLANES;
  constexpr int NC = V1 ? 2 : 1;          // accumulator chains
  extern __shared__ __align__(16) unsigned char smem_mma[];
  int* s_slot = reinterpret_cast<int*>(smem_mma);
  const int nbk1 = p.nbk + 1, rows = PC * nbk1;
  const int arows = a_rows(p.bm), lda = a_ld(p.nbk);
  // a B row: the staged bf16 row, or the hi | mid | lo planes
  const int ldb = P3 ? p_ld(p.bn) : p.bn + pm::bpad(p.bn);
  // A tiles and B tiles (raw rows, or planes) a block holds: f32 rows
  // keep one of each, so that their f32 row buffers fit twice
  const int ab = P3 ? 1 : p.stages;
  float* s_part = reinterpret_cast<float*>(smem_mma + HDR_BYTES);
  unsigned short* s_w = reinterpret_cast<unsigned short*>(
      s_part + (gridDim.z > 1 ? NC * p.cpb * arows * p.bn : 0));
  float* s_wf = reinterpret_cast<float*>(s_w + ab * rows * ldb);
  unsigned short* s_x = reinterpret_cast<unsigned short*>(
      s_wf + (P3 ? p.stages * rows * p.bn : 0));
  unsigned short* s_a = s_x + p.stages * p.bm * XLD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * p.bm, n0 = blockIdx.y * p.bn;
  const int c0 = blockIdx.z * p.cpb;
  const int nloc = max(0, min(p.cpb, p.nchunks - c0));
  const unsigned short* x = static_cast<const unsigned short*>(p.x);
  const unsigned short* wt = static_cast<const unsigned short*>(p.wt);
  const unsigned short* tf = static_cast<const unsigned short*>(p.t_flat);
  const int nthr = blockDim.x;
  const pm::Walk walk_w(p.bn / (P3 ? 1 : p.vec_w / 2), tid, nthr);
  const pm::Walk walk_x(PC / (p.vec_x / 2), tid, nthr);
  const int sm = p.stages - 1;             // buffer of chunk l: l & sm
  // chunk l's weight rows, zero past n_in and n_out: version 2 the fused
  // rows p0 * (nbk+1) .. (f32 ones into the f32 row buffer); version 1
  // w_b's rows p0 .. p0+31, then t_flat's p0 * nbk .. (p0+32) * nbk - 1
  auto issue_w = [&](int l) {
    const int p0 = (c0 + l) * PC;
    unsigned short* dst = s_w + (l & sm) * rows * ldb;
    if constexpr (P3) {
      kan_split::issue_w_f32(p, s_wf + (l & sm) * rows * p.bn, p0, n0, tid,
                             nthr);
    } else if constexpr (V1) {
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

  // Copy groups.  bf16 rows: x of chunk 0 alone, then the weights of
  // chunk 0 with x of chunk 1 (the weights are read in (3), after the
  // barrier).  f32 rows: x and weights of chunk 0, then of chunk 1 (both
  // are read in (2)).  The slot table and the A tiles' zero rows
  // meanwhile.
  if (nloc > 0) {
    issue_x(0);
    if (P3) issue_w(0);
  }
  pm::cp_async_commit();
  if (nloc > 0 && !P3) issue_w(0);
  if (nloc > 1) {
    issue_x(1);
    if (P3) issue_w(1);
  }
  pm::cp_async_commit();
  if (tid < p.n_bases) s_slot[tid] = __ldg(&p.slot_of[tid]);
  for (int b = 0; b < ab; ++b)
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
  // l+1's pass (2) while others still multiply.  Chunk l's A tile, x tile
  // and weights (raw, or f32 rows and planes) sit in buffers l & sm.
  // Right after the barrier go out: bf16 rows, chunk l+1's weights and
  // chunk l+2's x; f32 rows, chunk l+2's x and weights -- each into a
  // buffer that chunk l-1's MMAs or chunk l's pass (2), both done by
  // then, have left.
  for (int l = 0; l < nloc; ++l) {
    const int p0 = (c0 + l) * PC;
    const int at = P3 ? 0 : l & sm;        // chunk l's A and B tiles
    unsigned short* s_al = s_a + at * arows * lda;

    // SIMD + SPU + TSE: the chunk's A tile, two features of a row a
    // thread
    const unsigned short* xs = s_x + (l & sm) * p.bm * XLD;
    for (int e = tid; e < p.bm * (PC / 2); e += nthr) {
      const int bl = e >> 4, pl = 2 * (e & (PC / 2 - 1));
      unsigned short* row = s_al + bl * lda;
      // the pair's kept-basis columns (version 2: with its silu columns)
      // zeroed, as words: 2 * (nbk+1) (2 * nbk) from an even column
      unsigned short* seg0 = V1 ? row + PC + pl * p.nbk : row + pl * nbk1 + 1;
      unsigned short* seg1 = V1 ? seg0 + p.nbk : seg0 + nbk1;
      unsigned* zw = reinterpret_cast<unsigned*>(V1 ? seg0 : seg0 - 1);
      for (int s = 0; s < (V1 ? p.nbk : nbk1); ++s) zw[s] = 0u;
      const bool ok0 = b0 + bl < p.B && p0 + pl < p.n_in;
      const bool ok1 = ok0 && p0 + pl + 1 < p.n_in;
      unsigned silu2 = 0u;
      if (ok0) {
        const unsigned xw =
            *reinterpret_cast<const unsigned*>(xs + bl * XLD + pl);
        const float xa = pm::widen((unsigned short)(xw & 0xffffu));
        const float xb = pm::widen((unsigned short)(xw >> 16));
        silu2 = bf16x2_bits(silu_f32(xa), silu_f32(xb));
        if (!ok1) silu2 &= 0xffffu;
        // The KAN layer evaluates its bases on x clipped to [x0, x1 - eps);
        // torch clamps a bf16 tensor to bounds rounded to bf16.
        const unsigned xc = bf16x2_bits(fminf(fmaxf(xa, p.x0), p.hi),
                                        fminf(fmaxf(xb, p.x0), p.hi));
        float ra, rb;
        const int ca = locate(pm::widen((unsigned short)(xc & 0xffffu)), p,
                              &ra);
        const int cb = locate(pm::widen((unsigned short)(xc >> 16)), p, &rb);
        unsigned vals2[KK + 1];
        kan_fused::spu_bf16x2<KK>(bf16x2_bits(ra, rb), vals2);
#pragma unroll
        for (int j = 0; j <= KK; ++j) {
          const int s0 = s_slot[ca + j];
          if (s0 >= 0) seg0[s0] = (unsigned short)(vals2[j] & 0xffffu);
          if (ok1) {
            const int s1 = s_slot[cb + j];
            if (s1 >= 0) seg1[s1] = (unsigned short)(vals2[j] >> 16);
          }
        }
      }
      if (V1) {
        *reinterpret_cast<unsigned*>(row + pl) = silu2;
      } else {
        seg0[-1] = (unsigned short)(silu2 & 0xffffu);
        seg1[-1] = (unsigned short)(silu2 >> 16);
      }
    }
    // f32 rows: the chunk's staged rows split into its plane tile, four
    // columns a step
    if constexpr (P3) {
      const float* wf = s_wf + (l & sm) * rows * p.bn;
      unsigned short* wp = s_w + at * rows * ldb;
      const int q = p.bn >> 2, lg = __ffs(q) - 1;
      for (int e = tid; e < rows * q; e += nthr) {
        const int r = e >> lg, c = 4 * (e & (q - 1));
        const float4 w = *reinterpret_cast<const float4*>(wf + r * p.bn + c);
        uint2 hi, mid, lo;
        split_pair(w.x, w.y, &hi.x, &mid.x, &lo.x);
        split_pair(w.z, w.w, &hi.y, &mid.y, &lo.y);
        unsigned short* d = wp + r * ldb + c;
        *reinterpret_cast<uint2*>(d) = hi;
        *reinterpret_cast<uint2*>(d + p.bn) = mid;
        *reinterpret_cast<uint2*>(d + 2 * p.bn) = lo;
      }
    }
    // bf16 rows: chunk l's weights (and chunk l+1's x) have landed; f32
    // rows: chunk l+1's x and weights
    pm::cp_async_wait_n<0>();
    __syncthreads();
    if (P3) {
      if (l + 2 < nloc) {
        issue_x(l + 2);
        issue_w(l + 2);
      }
    } else {
      if (l + 1 < nloc) issue_w(l + 1);
      if (l + 2 < nloc) issue_x(l + 2);
    }
    pm::cp_async_commit();

    if (computes) {
      const unsigned short* as = s_al + wm0 * lda;
      const unsigned short* ws = s_w + at * rows * ldb + wn0;
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
          unsigned af[4];
          pm::ldmatrix_a(af, as + k, lda, lane);
          if constexpr (P3) {
            // the k16 step's three plane products, lo, mid, hi, from zero,
            // then added to the chunk's partial in IEEE f32
            float step[WN][4];
#pragma unroll
            for (int pc = 2; pc >= 0; --pc) {
              unsigned bf[WN][2];
#pragma unroll
              for (int j = 0; j < WN; ++j)
                pm::ldmatrix_b(bf[j], ws + k * ldb + pc * p.bn + j * 8, ldb,
                               lane);
#pragma unroll
              for (int j = 0; j < WN; ++j) {
                if (pc == 2)
                  mma_bf16_from_zero(step[j], af, bf[j]);
                else
                  pm::mma_bf16(step[j], af, bf[j]);
              }
            }
#pragma unroll
            for (int j = 0; j < WN; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                part[j][q] = __fadd_rn(part[j][q], step[j][q]);
          } else {
            unsigned bf[WN][2];
#pragma unroll
            for (int j = 0; j < WN; ++j)
              pm::ldmatrix_b(bf[j], ws + k * ldb + j * 8, ldb, lane);
#pragma unroll
            for (int j = 0; j < WN; ++j) pm::mma_bf16(part[j], af, bf[j]);
          }
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
    // f32 rows: chunk l+1's pass (2) overwrites the tiles these MMAs read
    if (P3) __syncthreads();
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

// Version 2 (bf16 or f32 rows) has ptxas plan its registers for one
// block an SM, which a large tile's shared memory admits anyway: left to
// aim at 64 registers a thread at 512 threads, ptxas spills the SPU pass
// at WN = 2, K = 4, and the f32-row instances run slower.  Version 1 keeps
// ptxas's own aim: its B = 8192 tile runs two blocks an SM, and is slower
// at one.
template <int WN, int KK, int R>
__global__ void __launch_bounds__(max_threads(R, WN), 1)
    kan_mma_kernel(const Params p) {
  kan_mma_body<WN, KK, R>(p);
}

template <int WN, int KK>
__global__ void __launch_bounds__(max_threads(BF16_V1, WN))
    kan_mma_v1_kernel(const Params p) {
  kan_mma_body<WN, KK, BF16_V1>(p);
}

template <int WN, int KK, int R>
struct Kernel {
  static constexpr void (*fn)(const Params) = kan_mma_kernel<WN, KK, R>;
};
template <int WN, int KK>
struct Kernel<WN, KK, BF16_V1> {
  static constexpr void (*fn)(const Params) = kan_mma_v1_kernel<WN, KK>;
};

// The instance for the layer's K (plan() checked 1 <= K <= KMAX).
template <int WN, int R>
int run_k(const Params& p, dim3 grid, int threads, int smem,
          cudaStream_t s) {
  switch (p.K) {
    case 1:
      return kan_split::run<Kernel<WN, 1, R>::fn>(p, grid, threads, smem, s);
    case 2:
      return kan_split::run<Kernel<WN, 2, R>::fn>(p, grid, threads, smem, s);
    case 3:
      return kan_split::run<Kernel<WN, 3, R>::fn>(p, grid, threads, smem, s);
    default:
      return kan_split::run<Kernel<WN, 4, R>::fn>(p, grid, threads, smem, s);
  }
}

// Checks the sizes and knobs (kan_split.cuh's; ops.check_blocks checks the
// same) and launches on `stream` the body for rows `R`: version 2 (p.wt
// the fused rows, bf16 or f32), or version 1 (p.wt is w_b, p.t_flat the
// kept-basis rows); returns cudaGetLastError().
template <int R>
int launch(Params p, int bm, int bi, int bn, void* stream) {
  int e = kan_split::plan(p, bm, bi, bn, kan_split::MAX_TILE);
  if (e != 0) return e;
  const long smem =
      smem_bytes(bm, bn, p.nbk, p.cpb, kan_split::nsplit_of(p), R);
  dim3 grid;
  e = kan_split::grid_of(p, smem, &grid);
  if (e != 0) return e;
  // the weight copies: f32 rows 16 bytes (4 columns) where the rows allow,
  // else 4 (issue_w_f32); bf16 rows as wide as both arrays allow; the x
  // rows likewise; the output by pairs
  if (R == F32_PLANES) {
    p.vec_w = p.n_out % 4 == 0 && pm::aligned(p.wt, 16);
  } else {
    p.vec_w = pm::copy_bytes(p.wt, p.n_out);
    if (R == BF16_V1) {
      const int vt = pm::copy_bytes(p.t_flat, p.n_out);
      if (vt < p.vec_w) p.vec_w = vt;
    }
  }
  p.vec_x = pm::copy_bytes(p.x, p.n_in);
  p.vec_out = p.n_out % 2 == 0 && pm::aligned(p.out, p.out_bf16 ? 4 : 8);
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = threads_of(bm, bn, R);
  switch (warp_n8s(bm, bn)) {
    case 1:
      return run_k<1, R>(p, grid, threads, (int)smem, s);
    case 2:
      return run_k<2, R>(p, grid, threads, (int)smem, s);
    case 4:
      return run_k<4, R>(p, grid, threads, (int)smem, s);
    default:
      return run_k<8, R>(p, grid, threads, (int)smem, s);
  }
}

}  // namespace kan_mma
