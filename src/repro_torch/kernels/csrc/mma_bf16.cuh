// Building blocks of the bf16 tensor-core kernels for Hopper (sm_90a):
// the product mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on
// register fragments, the ldmatrix loads that fill those fragments from
// shared memory, and the packing of float32 accumulators into bf16 A
// fragments.
//
// Fragments (PTX ISA), for lane l of a warp, g = l / 4, t = l % 4; each
// 32-bit register holds two bf16 values, the lower column in the lower
// half:
//   A (16 x 16): a[0] = A[g][2t, 2t+1],     a[1] = A[g+8][2t, 2t+1],
//                a[2] = A[g][2t+8, 2t+9],   a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8):  b[0] = B[2t, 2t+1][g],     b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8):  four floats, c[e + 2h] = C[g + 8h][2t + e], e, h = 0, 1
// So the C fragments of two neighbouring 8-column tiles, packed to bf16,
// are the A fragment of the 16 x 16 block they cover (pack_a): a product's
// result feeds the next product without leaving the registers.
//
// ldmatrix.x4 reads four 8 x 8 bf16 blocks; lanes 8m .. 8m + 7 give the
// row addresses of block m (16 bytes each) and each lane receives, of
// every block, row l / 4 at columns 2(l % 4), +1 (.trans: the transposed
// block's). From a row-major tile X (rows x columns):
//   a_row, a_col (rows lane % 16, columns 8 (lane / 16)): the A fragment
//     of a 16 x 16 block of X; with .trans, the B fragments of two
//     8-column tiles of X read as B = X (k along X's rows)
//   b_row, b_col (rows lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) %
//     2)): the B fragments of two 8-row tiles of X read as B = Xᵀ (n along
//     X's rows, k along its columns)
// The fragments' registers come back as {b[0], b[1]} of the first tile
// and {b[0], b[1]} of the second.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "dmma.cuh"

namespace mma_bf16 {

// D = A B + D on one m16n8k16 fragment (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(dmma::smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(dmma::smem_addr(p))
      : "memory");
}

// the lane's row and column offsets in a 16 x 16 block for each pattern
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int b_row(int lane) {
  return lane % 8 + 8 * (lane / 16);
}
__device__ __forceinline__ int b_col(int lane) {
  return 8 * ((lane / 8) % 2);
}

// two floats as one register of bf16 (lo in the lower half), rounded to
// nearest
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// what pack(lo, hi) rounded away, packed the same way: x = hi part +
// lo part to about 16 bits, for a product that needs more than bf16's 8
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return pack(lo - __low2float(v), hi - __high2float(v));
}

// the A fragment of the 16 x 16 block covered by the C fragments c0
// (columns 0-7) and c1 (columns 8-15)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// the same block's rounding rest (see pack_rest)
__device__ __forceinline__ void pack_a_rest(uint32_t (&a)[4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  a[0] = pack_rest(c0[0], c0[1]);
  a[1] = pack_rest(c0[2], c0[3]);
  a[2] = pack_rest(c1[0], c1[1]);
  a[3] = pack_rest(c1[2], c1[3]);
}

}  // namespace mma_bf16
