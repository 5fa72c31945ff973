// Building blocks of the float64 kernels for Hopper (sm_90a): the f64
// tensor-core product (DMMA) on m16n8k8 fragments and the asynchronous
// copies (cp.async) that stage tiles from device memory into shared
// memory without passing through registers.
//
// mma.sync.aligned.m16n8k8.row.col.f64 exists on sm_90 only; the
// kernels take it rather than the older m8n8k4 (sm_80), which ran slower
// on an H100. Its fragments (PTX ISA), for lane l of a warp, g = l / 4, t = l % 4,
// h = 0, 1 and u = 0, 1:
//   A (16 x 8): four doubles, a[h + 2u] = A[g + 8h][t + 4u]
//   B (8 x 8):  two doubles,  b[u] = B[t + 4u][g]
//   C (16 x 8): four doubles, c[e + 2h] = C[g + 8h][2t + e], e = 0, 1
// So a row of an accumulator lives in the 4 lanes 4g .. 4g + 3.
//
// A product sums over k in any order, so the k-th column of A and the
// k-th row of B may stand for any one index of the sum, as long as both
// agree. The flash-attention kernel uses that to feed an accumulator
// (P) back as an A operand without moving it between lanes.
//
// Shared-memory tiles that feed fragments keep a row stride of 4 (mod 16)
// doubles: the 16 lanes of a half-warp then read A[g][t] (or B[t][g]) at
// 16 different bank pairs (a double spans two of the 32 banks), so the
// fragment loads are free of bank conflicts. The stride stays even, so
// every row starts on 16 bytes, as a 16-byte cp.async needs.
//
// The copies zero-fill: a copy whose source size is 0 reads nothing and
// writes zeros, which is how the kernels mask ragged edges without
// padding their operands.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dmma {

// D = A B + D on one m16n8k8 fragment (f64 in, f64 accumulate)
__device__ __forceinline__ void mma_m16n8k8(double (&d)[4],
                                            const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (two doubles), bypassing L1; src must be 16-byte aligned
// unless nbytes is 0
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes (one double), for sources that are only 8-byte aligned
__device__ __forceinline__ void copy8(void* dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage rows [row0, row0 + ROWS) x columns [0, COLS) of a row-major
// matrix with `ld` columns and `rows` valid rows into a shared tile of
// row stride LDS; elements past `rows` or `cols` are zero. VEC takes
// 16-byte copies and needs an even `ld`, an even `cols` and a 16-byte
// aligned `src`. Each thread issues its copies U at a time (all at once
// for U = 0). Both are template arguments because the copies' addresses
// cost registers: with both kinds of copy in one kernel, or too many
// copies unrolled, the compiler keeps their addresses live across the
// caller's main loop, beside the accumulators, and spills.
template <int ROWS, int COLS, int LDS, int THREADS, bool VEC, int U = 0>
__device__ __forceinline__ void stage_tile(double* dst, const double* src,
                                           int64_t row0, int64_t rows,
                                           int64_t ld, int64_t cols,
                                           int tid) {
  constexpr int W = VEC ? 2 : 1;       // doubles per copy
  constexpr int PER_ROW = COLS / W;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int N = (TOTAL + THREADS - 1) / THREADS;   // copies per thread
  constexpr int STEP = U > 0 && U < N ? U : N;
  static_assert(COLS % W == 0, "16-byte copies of whole pairs");
#pragma unroll 1
  for (int i0 = 0; i0 < N; i0 += STEP) {
#pragma unroll
    for (int di = 0; di < STEP; ++di) {
      const int e = tid + (i0 + di) * THREADS;
      if (TOTAL % (THREADS * STEP) != 0 && e >= TOTAL) break;
      const int r = e / PER_ROW;
      const int c = W * (e - r * PER_ROW);
      const bool ok = row0 + r < rows && c < cols;
      const double* from = ok ? src + (row0 + r) * ld + c : src;
      if constexpr (VEC) copy16(dst + r * LDS + c, from, ok);
      else copy8(dst + r * LDS + c, from, ok);
    }
  }
}

}  // namespace dmma
