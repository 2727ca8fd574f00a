// Shared-memory staging helpers of the two pattern-matmul kernels
// (pattern_matmul.cu, f32, and pattern_matmul_q8.cu, int8).
#pragma once

#include <cuda_runtime.h>

namespace pm {

constexpr int MAX_SMEM = 232448;   // 227 KB of shared memory a block, sm_90

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory;
// with `ok` false no byte is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most `n` (0..15) of this thread's copy groups are in
// flight; a larger `n` waits for all.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
#define PM_WAIT_CASE(i)   \
  case i:                 \
    cp_async_wait_n<i>(); \
    break;
    PM_WAIT_CASE(1) PM_WAIT_CASE(2) PM_WAIT_CASE(3) PM_WAIT_CASE(4)
    PM_WAIT_CASE(5) PM_WAIT_CASE(6) PM_WAIT_CASE(7) PM_WAIT_CASE(8)
    PM_WAIT_CASE(9) PM_WAIT_CASE(10) PM_WAIT_CASE(11) PM_WAIT_CASE(12)
    PM_WAIT_CASE(13) PM_WAIT_CASE(14) PM_WAIT_CASE(15)
#undef PM_WAIT_CASE
    default:
      cp_async_wait_n<0>();
  }
}

// The cells of a rows x cols grid that thread `tid` of `nthreads` owns
// (cell r * cols + c, dealt round robin): the first one and the stride
// are worked out once, so staging a tile takes no integer division (each
// costs tens of dependent instructions, and at M = 8 two warps an SM
// hide none of it).
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int cols_, int tid, int nthreads)
      : r(tid / cols_), c(tid % cols_), dr(nthreads / cols_),
        dc(nthreads % cols_), cols(cols_) {}

  __device__ __forceinline__ void step(int& rr, int& cc) const {
    rr += dr;
    cc += dc;
    if (cc >= cols) {
      cc -= cols;
      ++rr;
    }
  }

  // f(r, c) for every owned cell with r < rows.
  template <typename F>
  __device__ __forceinline__ void run(int rows, F f) const {
    for (int rr = r, cc = c; rr < rows; step(rr, cc)) f(rr, cc);
  }
};

}  // namespace pm
