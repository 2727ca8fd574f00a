// The bf16 tensor-core pieces of the bf16 pattern-matmul kernel
// (pattern_matmul_bf16.cu) and the bf16 KAN kernel (kan_fused/csrc/
// kan_mma.cuh): the m16n8k16 MMA, its fragment loads from shared memory,
// and the cp.async staging of a bf16 tile at the widest copy its rows
// allow.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "staging.cuh"

namespace pm {

// bf16 elements after each staged row of a [k][n] operand bn wide: a row
// is then an odd number of 16-byte units, so the 8 rows an ldmatrix
// reads sit on 8 distinct bank groups (pattern_matmul/ops.py and
// kan_fused/ops.py kernel_smem mirror it).
__host__ __device__ constexpr int bpad(int bn) { return bn == 8 ? 16 : 8; }

// c += a * b on one 16 x 8 x 16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of a 16 (m) x 16 (k) tile from a row-major [m][k] array
// of `ld` elements a row (ld * 2 a multiple of 16 bytes): lane l gives
// the address of row l & 15 at column (l >> 4) * 8.
__device__ __forceinline__ void ldmatrix_a(unsigned* a,
                                           const unsigned short* tile,
                                           int ld, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(tile + (lane & 15) * ld + (lane >> 4) * 8)));
}

// The B fragment of a 16 (k) x 8 (n) tile from a row-major [k][n] array
// of `ld` elements a row: lanes 0..15 give the addresses of rows k ..
// k+15.
__device__ __forceinline__ void ldmatrix_b(unsigned* b,
                                           const unsigned short* tile,
                                           int ld, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_u32(tile + (lane & 15) * ld)));
}

__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

// Stage `rows` x `cols` elements of the row-major global array `g`
// (`ld` elements a row, `nrows` x `ncols` valid) at (r0, c0) into `s`
// (`lds` elements a row), BYTES a copy, `walk` over cols / (BYTES / 2)
// copies a row; out of range is zero.  Two-byte copies are plain loads
// and stores (cp.async copies 4 bytes at least).
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

// One of the four copy widths, chosen at run time (copy_bytes).
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

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The widest copy (16, 8, 4 or 2 bytes) that bf16 rows of `len` elements
// of the array at `p` allow.
inline int copy_bytes(const void* p, int len) {
  for (int b = 16; b > 2; b /= 2)
    if (len % (b / 2) == 0 && aligned(p, b)) return b;
  return 2;
}

}  // namespace pm
