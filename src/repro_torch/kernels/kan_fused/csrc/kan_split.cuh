// The fused KAN layer kernel of kan_fused.cu (f32), kan_fused_q8.cu
// (int8 codes) and kan_fused_v1.cu (version 1: w_b and t_flat apart), for
// sm_90a, with its launch-time knobs (bm, bi, bn).
//
// One template body over an operand policy `Op` (`F32`: x and the fused
// [w_b ; t[kb]] rows of ops.fuse_wt as f32; `Q8`: int8 codes, copied raw
// and dequantized once a chunk in shared memory; `Split`: the version-1
// weights, w_b and t_flat, staged into the same fused layout) and the
// rows a thread owns (`TM`).  The kernels with a bf16 x -- bf16 rows of
// both versions, and f32 rows split into bf16 planes (kan_fused_mixed.cu)
// -- run their own tensor-core body (kan_mma.cuh) on this file's knob
// checks, feature split, cluster launch and f32 row staging.
//
// What each output is, bit for bit, depends on the layer alone:
//   * the input features are cut into chunks of PC = 32, a constant that
//     no knob and no batch size changes;
//   * the partial of chunk c is one fmaf chain from +0 over the chunk's
//     features ascending, per feature the silu term first, then the K+1
//     basis terms j = 0..K (a basis the stage-2 mask dropped adds
//     fmaf(0, w, acc) == acc: the chain starts at +0 and round-to-nearest
//     never makes it -0, so the term changes no bit);
//   * the output is partial 0, then __fadd_rn of each later partial in
//     ascending c.
// `Split` keeps two such chains a chunk, the silu terms in one and the
// basis terms in the other, each summed over the chunks as above, and
// writes __fadd_rn(silu total, spline total): the plain version's
// `s @ w_b + act @ t_flat`, two sums added once.
// The knobs only schedule that work.  A block owns bm rows x bn outputs
// and walks bi features: ceil(bi / PC) chunks, all of them when bi >=
// n_in.  When the chunks are split over several blocks, those blocks are
// one thread-block cluster along grid.z: each keeps its chunks' partials
// apart in shared memory, and rank 0, which holds chunk 0, adds them to
// its running total in chunk order through distributed shared memory.  No
// workspace, no atomics, no second launch, so one layer call is one launch
// and replays as it ran inside a CUDA graph.  Every knob gives the same
// bits, and a row does not depend on its batch.
//
// Per chunk a block (1) has its x tile and the chunk's weight rows staged
// in shared memory with cp.async, the next chunk's copies in flight while
// this one is computed; (2) evaluates silu, the cell and the K+1 de Boor
// values of each (row, feature) once (kan_fused.cuh's spu(), bitwise the
// plain version's), with the staged weight row each value multiplies; (3)
// lets every compute thread run its TM rows x 4 columns: per feature one
// float4 of the silu row, shared by its TM rows, then per row K+1 float4
// reads of the rows its cell picks.  Nothing in the feature loop waits on
// global memory.
#pragma once

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../../pattern_matmul/csrc/staging.cuh"
#include "kan_fused.cuh"

namespace kan_split {

namespace cg = cooperative_groups;

constexpr int PC = 32;                  // features a chunk: fixes the order
constexpr int KMAX = kan_fused::KMAX;
constexpr int HDR = 64;                 // words: slot table, slot scales
constexpr int TABLE = 32;               // slot-table entries (G + K <= 20)
constexpr int ACT_WORDS = 8;            // per (row, feature), see spu_stage
constexpr int ACT_STRIDE = PC * ACT_WORDS + 4;  // +4: rows on other banks
constexpr int MIN_THREADS = 128;        // threads past the tile only stage
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE = 8192;          // bm * bn
constexpr int MAX_SPLIT = 16;           // blocks a cluster (8 portable)
constexpr int PORTABLE_SPLIT = 8;
constexpr int MAX_SMEM = pm::MAX_SMEM;

struct Params {
  const void* x;
  const void* wt;            // version 1: w_b
  const void* t_flat;        // version 1: the kept-basis rows
  const float* slot_scales;  // Q8 only: (nbk+1,) silu row, kept bases
  const int* slot_of;
  void* out;                 // f32, or bf16 where out_bf16 (kan_mma.cuh)
  int B, n_in, n_out, nbk, n_bases, G, K;
  float x_scale, x0, hi, inv_h;
  int out_bf16;
  int bm, bn, cpb, nchunks, stages;
  int vec_w, vec_x, vec_out;
};

// Rows a compute thread owns at a bm x bn tile (ops.tile_rows mirrors it):
// 256 compute threads from bm * bn = 1024 on, at most 8 rows.
inline int tile_rows(int bm, int bn) {
  const int t = bm * bn / 1024;
  return t < 1 ? 1 : t > 8 ? 8 : t;
}

// The largest bm * bn (ops.max_tile mirrors it).  Two chains at 8 rows a
// thread hold 2 x 2 x 32 accumulators, more than ptxas fits in 255
// registers without spilling, so Split stops at 4 rows a thread.
constexpr int max_tile(int chains) {
  return chains == 2 ? MAX_TILE / 2 : MAX_TILE;
}

// Dynamic shared memory of a block (ops.kernel_smem mirrors it): the
// header, `stages` f32 weight buffers and as many f32 x buffers, the
// staged (row, feature) values, a cluster member's chunk partials (one
// set a chain), and the `stages` buffers of raw weights (kRawW bytes an
// element) and raw x (kRawX bytes) staged before widening.
template <class Op>
inline long smem_bytes(int bm, int bn, int nbk, int cpb, int nsplit) {
  const long rows = (long)PC * (nbk + 1);
  const long stages = cpb > 1 ? 2 : 1;
  const long words = HDR + stages * rows * bn + stages * (long)bm * PC +
                     (long)bm * ACT_STRIDE +
                     (nsplit > 1 ? (long)Op::kChains * cpb * bm * bn : 0);
  return 4 * words +
         stages * (Op::kRawW * rows * bn + Op::kRawX * (long)bm * PC);
}

// The f32 x tile of rows b0.. and features p0..; rows past B and features
// past n_in read as zero.
__device__ __forceinline__ void issue_x(const Params& p, float* xs, int b0,
                                        int p0, int tid, int nthr) {
  const float* x = static_cast<const float*>(p.x);
  for (int e = tid; e < p.bm * PC; e += nthr) {
    const int b = b0 + (e >> 5), f = p0 + (e & (PC - 1));
    const bool ok = b < p.B && f < p.n_in;
    pm::cp_async<4>(xs + e, ok ? x + (size_t)b * p.n_in + f : x, ok);
  }
}

// The f32 weight rows of chunk p0 .. p0+PC-1 and output columns n0 ..
// n0+bn-1 (F32 here, and kan_mma.cuh's f32 rows): local row r is global
// row p0*(nbk+1) + r; rows past n_in*(nbk+1) and columns past n_out read
// as zero.  A thread keeps one column (group) and walks the rows: bn <=
// 128 <= threads, all powers of two.
__device__ __forceinline__ void issue_w_f32(const Params& p, float* ws,
                                            int p0, int n0, int tid,
                                            int nthr) {
  const float* wt = static_cast<const float*>(p.wt);
  const int nbk1 = p.nbk + 1, rows = PC * nbk1;
  const size_t row0 = (size_t)p0 * nbk1, nrows = (size_t)p.n_in * nbk1;
  if (p.vec_w) {
    const int cols = p.bn >> 2, lg = __ffs(cols) - 1;
    const int c = tid & (cols - 1), n = n0 + 4 * c;
    for (int r = tid >> lg; r < rows; r += nthr >> lg) {
      const bool ok = row0 + r < nrows && n < p.n_out;
      pm::cp_async<16>(ws + r * p.bn + 4 * c,
                       ok ? wt + (row0 + r) * p.n_out + n : wt, ok);
    }
  } else {
    const int lg = __ffs(p.bn) - 1, c = tid & (p.bn - 1), n = n0 + c;
    for (int r = tid >> lg; r < rows; r += nthr >> lg) {
      const bool ok = row0 + r < nrows && n < p.n_out;
      pm::cp_async<4>(ws + r * p.bn + c,
                      ok ? wt + (row0 + r) * p.n_out + n : wt, ok);
    }
  }
}

// Each policy names its staging: kRawW / kRawX, the bytes of a raw weight
// / x element staged before widening (0: staged as f32); kChains, the
// accumulator chains (2: version 1's silu and spline sums).
struct F32 {
  static constexpr bool kQ8 = false;
  static constexpr int kRawW = 0;
  static constexpr int kRawX = 0;
  static constexpr int kChains = 1;

  __device__ static void issue(const Params& p, float* ws, float* xs,
                               int8_t*, int b0, int p0, int n0, int tid,
                               int nthr) {
    issue_x(p, xs, b0, p0, tid, nthr);
    issue_w_f32(p, ws, p0, n0, tid, nthr);
  }

  __device__ static void prepare(const Params&, float*, float*,
                                 const int8_t*, const float*, int, int) {}

  __device__ static const float* x_of(const Params&, const float* xs,
                                      const int8_t*) {
    return xs;
  }
};

// int8: the x and weight codes are copied raw and dequantized once a
// chunk in shared memory, x by x_scale and each weight by the scale of
// its row's slot (silu row 0, kept basis 1 + slot) -- the plain version's
// products, bit for bit, never fused into the multiply-add that consumes
// them.
struct Q8 {
  static constexpr bool kQ8 = true;
  static constexpr int kRawW = 1;
  static constexpr int kRawX = 1;
  static constexpr int kChains = 1;

  __device__ static void issue(const Params& p, float*, float*,
                               int8_t* raw, int b0, int p0, int n0, int tid,
                               int nthr) {
    const int8_t* wt = static_cast<const int8_t*>(p.wt);
    const int nbk1 = p.nbk + 1, rows = PC * nbk1;
    const size_t row0 = (size_t)p0 * nbk1, nrows = (size_t)p.n_in * nbk1;
    if (p.vec_w) {
      const int cols = p.bn >> 2, lg = __ffs(cols) - 1;
      const int c = tid & (cols - 1), n = n0 + 4 * c;
      for (int r = tid >> lg; r < rows; r += nthr >> lg) {
        const bool ok = row0 + r < nrows && n < p.n_out;
        pm::cp_async<4>(raw + r * p.bn + 4 * c,
                        ok ? wt + (row0 + r) * p.n_out + n : wt, ok);
      }
    } else {
      const int lg = __ffs(p.bn) - 1, c = tid & (p.bn - 1), n = n0 + c;
#pragma unroll 4
      for (int r = tid >> lg; r < rows; r += nthr >> lg) {
        const bool ok = row0 + r < nrows && n < p.n_out;
        raw[r * p.bn + c] =
            ok ? __ldg(&wt[(row0 + r) * p.n_out + n]) : (int8_t)0;
      }
    }
    // the x codes go to the raw area's tail (rows * bn bytes on)
    const int8_t* x = static_cast<const int8_t*>(p.x);
    int8_t* rx = raw + rows * p.bn;
    if (p.vec_x) {
      for (int e = tid; e < p.bm * (PC / 4); e += nthr) {
        const int b = b0 + (e >> 3), f = p0 + 4 * (e & 7);
        const bool ok = b < p.B && f < p.n_in;
        pm::cp_async<4>(rx + 4 * e, ok ? x + (size_t)b * p.n_in + f : x, ok);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < p.bm * PC; e += nthr) {
        const int b = b0 + (e >> 5), f = p0 + (e & (PC - 1));
        rx[e] = b < p.B && f < p.n_in ? __ldg(&x[(size_t)b * p.n_in + f])
                                      : (int8_t)0;
      }
    }
  }

  __device__ static const float* x_of(const Params&, const float* xs,
                                      const int8_t*) {
    return xs;
  }

  __device__ static void prepare(const Params& p, float* ws, float* xs,
                                 const int8_t* raw, const float* s_scale,
                                 int tid, int nthr) {
    const int nbk1 = p.nbk + 1, rows = PC * nbk1;
    const int8_t* rx = raw + rows * p.bn;
    for (int e = tid; e < p.bm * PC; e += nthr)
      xs[e] = __fmul_rn((float)rx[e], p.x_scale);
    const int cols = p.bn >> 2, lg = __ffs(cols) - 1, c = tid & (cols - 1);
    const int r0 = tid >> lg, step = nthr >> lg, sstep = step % nbk1;
    int slot = r0 % nbk1;
    for (int r = r0; r < rows; r += step) {
      const char4 q = *reinterpret_cast<const char4*>(raw + r * p.bn + 4 * c);
      const float s = s_scale[slot];
      *reinterpret_cast<float4*>(ws + r * p.bn + 4 * c) =
          make_float4(__fmul_rn((float)q.x, s), __fmul_rn((float)q.y, s),
                      __fmul_rn((float)q.z, s), __fmul_rn((float)q.w, s));
      slot += sstep;
      if (slot >= nbk1) slot -= nbk1;
    }
  }
};

// Version 1: w_b (n_in, n_out) and t_flat (n_in*nbk, n_out) apart, f32.
// Staged row r = pl*(nbk+1) + s of the chunk at feature p0 is w_b's row
// p0+pl for s = 0 and t_flat's row (p0+pl)*nbk + s-1 for s >= 1: the
// fused layout F32 stages, so the SPU pass and the FMA pass read it
// unchanged.  The (pl, s) of a thread's rows are stepped, not divided.
struct Split {
  static constexpr bool kQ8 = false;
  static constexpr int kRawW = 0;
  static constexpr int kRawX = 0;
  static constexpr int kChains = 2;

  template <int BYTES>
  __device__ static void issue_w(const Params& p, float* ws, int p0, int n0,
                                 int tid, int nthr) {
    const float* wb = static_cast<const float*>(p.wt);
    const float* tf = static_cast<const float*>(p.t_flat);
    constexpr int W = BYTES / 4;                 // columns a copy
    const int nbk1 = p.nbk + 1, rows = PC * nbk1;
    const int cols = p.bn / W, lg = __ffs(cols) - 1;
    const int c = tid & (cols - 1), n = n0 + W * c;
    const int r0 = tid >> lg, step = nthr >> lg;
    const int dpl = step / nbk1, ds = step - dpl * nbk1;
    int pl = r0 / nbk1, s = r0 - pl * nbk1;
    for (int r = r0; r < rows; r += step) {
      const int f = p0 + pl;
      const bool ok = f < p.n_in && n < p.n_out;
      const float* src =
          s == 0 ? wb + (size_t)f * p.n_out + n
                 : tf + ((size_t)f * p.nbk + (s - 1)) * p.n_out + n;
      pm::cp_async<BYTES>(ws + r * p.bn + W * c, ok ? src : wb, ok);
      pl += dpl;
      s += ds;
      if (s >= nbk1) {
        s -= nbk1;
        ++pl;
      }
    }
  }

  __device__ static void issue(const Params& p, float* ws, float* xs,
                               int8_t*, int b0, int p0, int n0, int tid,
                               int nthr) {
    issue_x(p, xs, b0, p0, tid, nthr);
    if (p.vec_w)
      issue_w<16>(p, ws, p0, n0, tid, nthr);
    else
      issue_w<4>(p, ws, p0, n0, tid, nthr);
  }

  __device__ static void prepare(const Params&, float*, float*,
                                 const int8_t*, const float*, int, int) {}

  __device__ static const float* x_of(const Params&, const float* xs,
                                      const int8_t*) {
    return xs;
  }
};

// SIMD + SPU + TSE once per (row, feature) of the chunk.  Each entry is
// two float4: {silu, v0, v1, v2} and {v3, v4, rel0..3, rel4}, where vj is
// the j-th de Boor value if its basis is kept (else 0) and relj the
// staged row it multiplies relative to the feature's silu row (1 + slot,
// or 0 -- the silu row, times 0 -- for a dropped basis), one byte each.
__device__ __forceinline__ void spu_stage(const Params& p, const float* xs,
                                          float* s_act, const int* s_slot,
                                          int p0, int tid, int nthr) {
  for (int e = tid; e < p.bm * PC; e += nthr) {
    const int bl = e >> 5, pl = e & (PC - 1);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (p0 + pl < p.n_in) {
      const float xv = xs[e];
      // The KAN layer evaluates its bases on x clipped to [x0, x1 - eps).
      float vals[KMAX + 1];
      const int cell = kan_fused::spu(fminf(fmaxf(xv, p.x0), p.hi), p.x0,
                                      p.inv_h, p.G, p.K, vals);
      float v[KMAX + 1];
      unsigned rel = 0, rel4 = 0;
#pragma unroll
      for (int j = 0; j <= KMAX; ++j) {
        const int slot = j <= p.K ? s_slot[cell + j] : -1;
        v[j] = slot >= 0 ? vals[j] : 0.f;
        const unsigned r = slot >= 0 ? (unsigned)(slot + 1) : 0u;
        if (j < 4)
          rel |= r << (8 * j);
        else
          rel4 = r;
      }
      lo = make_float4(xv * (1.f / (1.f + expf(-xv))), v[0], v[1], v[2]);
      hi = make_float4(v[3], v[4], __uint_as_float(rel),
                       __uint_as_float(rel4));
    }
    float* a = s_act + bl * ACT_STRIDE + pl * ACT_WORDS;
    *reinterpret_cast<float4*>(a) = lo;
    *reinterpret_cast<float4*>(a + 4) = hi;
  }
}

__device__ __forceinline__ float4 ld4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float v,
                                     const float4& w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// One chunk's partial for a thread's TM rows (tr + i * rstride) and four
// columns (4 * tc ..): features ascending, silu term, then j = 0..K.  The
// silu terms go to `ps`, the basis terms to `pt`: two chains for Split,
// one for the fused kernels, which pass the same array twice.
template <int TM>
__device__ __forceinline__ void fma_chunk(const Params& p, const float* ws,
                                          const float* s_act,
                                          float (&ps)[TM][4],
                                          float (&pt)[TM][4], int p0, int tr,
                                          int tc, int rstride) {
  const int bn = p.bn, fstride = (p.nbk + 1) * bn;
  const int pc = min(PC, p.n_in - p0);
  const float* wcol = ws + 4 * tc;
  const float* arow = s_act + tr * ACT_STRIDE;
#pragma unroll 4
  for (int pl = 0; pl < pc; ++pl) {
    const float* wf = wcol + pl * fstride;
    const float4 w0 = ld4(wf);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float* a = arow + i * rstride * ACT_STRIDE + pl * ACT_WORDS;
      const float4 lo = ld4(a), hi = ld4(a + 4);
      const unsigned rel = __float_as_uint(hi.z);
      fma4(ps[i], lo.x, w0);
      fma4(pt[i], lo.y, ld4(wf + (rel & 0xffu) * bn));
      fma4(pt[i], lo.z, ld4(wf + ((rel >> 8) & 0xffu) * bn));
      if (p.K >= 2) fma4(pt[i], lo.w, ld4(wf + ((rel >> 16) & 0xffu) * bn));
      if (p.K >= 3) fma4(pt[i], hi.x, ld4(wf + (rel >> 24) * bn));
      if (p.K >= 4)
        fma4(pt[i], hi.y, ld4(wf + __float_as_uint(hi.w) * bn));
    }
  }
}

template <class Op, int TM>
__global__ void __launch_bounds__(MAX_THREADS)
kan_split_kernel(const Params p) {
  constexpr int NC = Op::kChains;
  extern __shared__ __align__(16) float smem[];
  int* s_slot = reinterpret_cast<int*>(smem);
  float* s_scale = smem + TABLE;
  const int nbk1 = p.nbk + 1;
  const int wsz = PC * nbk1 * p.bn;            // elements a weight stage
  // raw bytes a stage: the weights', then x's
  const int rsz = Op::kRawW * wsz + Op::kRawX * p.bm * PC;
  const int psz = p.cpb * p.bm * p.bn;         // words a chain's partials
  float* s_w = smem + HDR;
  // f32 weight and x buffers: `stages` of each
  float* s_x = s_w + p.stages * wsz;
  float* s_act = s_x + p.stages * p.bm * PC;
  float* s_part = s_act + p.bm * ACT_STRIDE;
  int8_t* s_raw = reinterpret_cast<int8_t*>(
      s_part + (gridDim.z > 1 ? NC * psz : 0));

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * p.bm, n0 = blockIdx.y * p.bn;
  const int c0 = blockIdx.z * p.cpb;
  const int nloc = max(0, min(p.cpb, p.nchunks - c0));

  // The first chunks' copies go out before the tables are read: neither
  // depends on the other, and their latencies overlap.  The barrier at
  // the top of the chunk loop publishes the tables.
  for (int l = 0; l < min(p.stages, nloc); ++l) {
    Op::issue(p, s_w + l * wsz, s_x + l * p.bm * PC, s_raw + l * rsz, b0,
              (c0 + l) * PC, n0, tid, nthr);
    pm::cp_async_commit();
  }
  if (tid < p.n_bases) s_slot[tid] = __ldg(&p.slot_of[tid]);
  if (Op::kQ8 && tid < nbk1) s_scale[tid] = __ldg(&p.slot_scales[tid]);

  const int cols4 = p.bn >> 2;
  const int ct = (p.bm / TM) * cols4;          // compute threads
  const bool computes = tid < ct;
  const int tc = tid & (cols4 - 1), tr = tid >> (__ffs(cols4) - 1);
  const int rstride = p.bm / TM;
  float total[NC][TM][4];
#pragma unroll
  for (int h = 0; h < NC; ++h)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) total[h][i][k] = 0.f;

  for (int l = 0; l < nloc; ++l) {
    const int buf = l & (p.stages - 1);
    const int p0 = (c0 + l) * PC;
    float* ws = s_w + buf * wsz;
    float* xs = s_x + buf * p.bm * PC;
    pm::cp_async_wait(min(p.stages, nloc - l) - 1);
    __syncthreads();
    Op::prepare(p, ws, xs, s_raw + buf * rsz, s_scale, tid, nthr);
    if (Op::kQ8) __syncthreads();      // the dequantized x, for spu_stage
    spu_stage(p, Op::x_of(p, xs, s_raw + buf * rsz), s_act, s_slot, p0, tid,
              nthr);
    __syncthreads();
    if (computes) {
      float part[NC][TM][4];
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[h][i][k] = 0.f;
      fma_chunk<TM>(p, ws, s_act, part[0], part[NC - 1], p0, tr, tc,
                    rstride);
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (blockIdx.z == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              total[h][i][k] = l == 0 ? part[h][i][k]
                                      : __fadd_rn(total[h][i][k],
                                                  part[h][i][k]);
          } else {
            *reinterpret_cast<float4*>(
                s_part + h * psz + ((l * TM + i) * ct + tid) * 4) =
                make_float4(part[h][i][0], part[h][i][1], part[h][i][2],
                            part[h][i][3]);
          }
        }
    }
    __syncthreads();
    if (l + p.stages < nloc) {
      Op::issue(p, ws, xs, s_raw + buf * rsz, b0, p0 + p.stages * PC, n0,
                tid, nthr);
      pm::cp_async_commit();
    }
  }

  if (gridDim.z > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                   // every member's partials are staged
    if (blockIdx.z == 0 && computes) {
      // chunks cpb .. nchunks-1 in order: chunk g is member g / cpb's
      // local chunk g % cpb
      int r = 1, l = 0;
#pragma unroll 4
      for (int g = p.cpb; g < p.nchunks; ++g) {
        const float* rp = cluster.map_shared_rank(s_part, r);
#pragma unroll
        for (int h = 0; h < NC; ++h)
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float4 q = ld4(rp + h * psz + ((l * TM + i) * ct + tid) * 4);
            total[h][i][0] = __fadd_rn(total[h][i][0], q.x);
            total[h][i][1] = __fadd_rn(total[h][i][1], q.y);
            total[h][i][2] = __fadd_rn(total[h][i][2], q.z);
            total[h][i][3] = __fadd_rn(total[h][i][3], q.w);
          }
        if (++l == p.cpb) {
          l = 0;
          ++r;
        }
      }
    }
    cluster.sync();                   // no member leaves while read
  }

  if (blockIdx.z == 0 && computes) {
    const int n = n0 + 4 * tc;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int b = b0 + tr + i * rstride;
      if (b >= p.B) continue;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = NC == 2 ? __fadd_rn(total[0][i][k], total[NC - 1][i][k])
                       : total[0][i][k];
      float* o = static_cast<float*>(p.out) + (size_t)b * p.n_out + n;
      if (p.vec_out) {
        if (n < p.n_out)
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n + k < p.n_out) o[k] = v[k];
      }
    }
  }
}

// Launches `Kern` (this body's kernel or kan_mma.cuh's) on `grid`, its
// feature split a cluster of `nsplit` blocks along grid.z.
template <void (*Kern)(const Params)>
int run(const Params& p, dim3 grid, int threads, int smem,
        cudaStream_t stream) {
  void (*kern)(const Params) = Kern;
  const int nsplit = (int)grid.z;
  static unsigned configured = 0;     // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

inline bool tile_ok(int t) {
  return t == 8 || t == 16 || t == 32 || t == 64 || t == 128;
}

// Checks the sizes and knobs of either body (ops.check_blocks checks the
// same; bm * bn at most `tile_cap`) and sets p's tiles and feature split;
// returns 0 or the error.
inline int plan(Params& p, int bm, int bi, int bn, int tile_cap) {
  if (p.B <= 0 || p.n_out <= 0 || p.n_in < 0 || p.nbk < 0 || p.G < 1 ||
      p.K < 1 || p.K > KMAX || p.n_bases != p.G + p.K ||
      p.G + KMAX > TABLE || p.nbk > p.n_bases)
    return (int)cudaErrorInvalidValue;
  if (!tile_ok(bm) || !tile_ok(bn) || bm * bn > tile_cap || bi <= 0 ||
      (bi % PC != 0 && bi < p.n_in))
    return (int)cudaErrorInvalidValue;
  p.nchunks = (p.n_in + PC - 1) / PC;
  p.cpb = bi >= p.n_in ? (p.nchunks > 0 ? p.nchunks : 1) : bi / PC;
  p.bm = bm;
  p.bn = bn;
  p.stages = p.cpb > 1 ? 2 : 1;
  return 0;
}

// Blocks a cluster along the features of a planned launch.
inline int nsplit_of(const Params& p) {
  return p.nchunks > 0 ? (p.nchunks + p.cpb - 1) / p.cpb : 1;
}

// The grid of a planned launch at `smem` bytes a block; returns 0 or
// cudaErrorInvalidConfiguration where the card does not take it.
inline int grid_of(const Params& p, long smem, dim3* grid) {
  const int nsplit = nsplit_of(p);
  const long gx = (p.B + (long)p.bm - 1) / p.bm;
  const long gy = (p.n_out + (long)p.bn - 1) / p.bn;
  if (nsplit > MAX_SPLIT || smem > MAX_SMEM ||
      (nsplit > PORTABLE_SPLIT && smem > MAX_SMEM / 2) || gy > 65535 ||
      gx > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)nsplit);
  return 0;
}

// Checks the sizes and knobs and launches on `stream`; returns
// cudaGetLastError().
template <class Op>
int launch(Params p, int bm, int bi, int bn, void* stream) {
  int e = plan(p, bm, bi, bn, max_tile(Op::kChains));
  if (e != 0) return e;
  const long smem = smem_bytes<Op>(bm, bn, p.nbk, p.cpb, nsplit_of(p));
  dim3 grid;
  e = grid_of(p, smem, &grid);
  if (e != 0) return e;
  const int tm = tile_rows(bm, bn);
  int threads = (bm / tm) * (bn / 4);
  if (threads < MIN_THREADS) threads = MIN_THREADS;
  // a weight copy is 4 columns: 4 int8 bytes, 16 f32 bytes; an x copy 4
  // int8 elements, or one f32
  const uintptr_t wal = Op::kRawW ? 4 * Op::kRawW : 16;
  p.vec_w = p.n_out % 4 == 0 &&
            reinterpret_cast<uintptr_t>(p.wt) % wal == 0 &&
            reinterpret_cast<uintptr_t>(p.t_flat) % wal == 0;
  const uintptr_t xal = Op::kRawX ? 4 * Op::kRawX : 4;
  p.vec_x = p.n_in % 4 == 0 && reinterpret_cast<uintptr_t>(p.x) % xal == 0;
  p.vec_out = p.n_out % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tm) {
    case 1:
      return run<kan_split_kernel<Op, 1>>(p, grid, threads, (int)smem, s);
    case 2:
      return run<kan_split_kernel<Op, 2>>(p, grid, threads, (int)smem, s);
    case 4:
      return run<kan_split_kernel<Op, 4>>(p, grid, threads, (int)smem, s);
    default:
      // max_tile keeps Split at 4 rows a thread: no 8-row instance
      if constexpr (Op::kChains == 2)
        return (int)cudaErrorInvalidConfiguration;
      else
        return run<kan_split_kernel<Op, 8>>(p, grid, threads, (int)smem, s);
  }
}

}  // namespace kan_split
