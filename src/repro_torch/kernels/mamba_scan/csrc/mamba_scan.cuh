// Helpers of the selective scan's kernels (csrc/mamba_scan.cu, the
// forward, and csrc/mamba_scan_bwd.cu, its gradient): the block's shape,
// the type conversions, the exp of a pre-scaled decay, row loads, the
// decays of a lane's channel, the look-back's flag accesses and the
// staging of a chunk's (LC, 32) tile.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int LANES = 32;           // channels per block, one per lane
constexpr int WARPS = 4;            // warps a block
// steps a warp walks: a block's chunk is LC steps. Of 2..8 warps and SUB
// in 4..32, 4 x 16 ran fastest or within a few percent of it at every
// phase-3 shape of chip_smoke.py whose grid gives each SM a block; at the
// ragged shape (B = 2, I = 77: 96 blocks) SUB = 8, which fills the SMs,
// was slower (PERF.md, section 6)
constexpr int SUB = 16;
constexpr int LC = WARPS * SUB;
constexpr int MAX_N = 32;
// chunks per look-back group: a longer group folds more aggregates in
// every look-back, a shorter one lengthens the chain of P; 4 ran the
// Jamba layers faster than 8, 16 or 32
constexpr int GROUP = 4;
constexpr int64_t MAX_SMEM = 227 * 1024;

template <typename Acc, typename T>
__device__ __forceinline__ Acc to_acc(T v) { return static_cast<Acc>(v); }
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T from_acc(Acc v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16
from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

// exp of v * decay, given the decay as scaled by scale_decay: float
// takes 2^(v * decay * log2(e)) on the SFU (one MUFU.EX2, relative error
// about 2^-22; results below 2^-126 flush to 0), double exp
__device__ __forceinline__ float scale_decay(float d) {
  return d * 1.4426950408889634f;
}
__device__ __forceinline__ double scale_decay(double d) { return d; }
__device__ __forceinline__ float xp(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ double xp(double v) { return exp(v); }

// one step of a state, decay (the step's exp) times the state plus dx
// times B, rounded as written: the forward and both backward kernels take
// it, so that the states the backward recomputes are the forward's bits
__device__ __forceinline__ float state_step(float decay, float h, float dx,
                                            float b) {
  return __fmaf_rn(decay, h, __fmul_rn(dx, b));
}
__device__ __forceinline__ double state_step(double decay, double h,
                                             double dx, double b) {
  return __fma_rn(decay, h, __dmul_rn(dx, b));
}

// NS values of a row of B or C: 16-byte loads where the row allows
template <typename Acc, int NS>
__device__ __forceinline__ void load_row(Acc (&dst)[NS], const Acc* src) {
  constexpr int V = 16 / sizeof(Acc);
  if constexpr (NS % V == 0) {
#pragma unroll
    for (int s = 0; s < NS; s += V) {
      if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + s);
        dst[s] = v.x; dst[s + 1] = v.y; dst[s + 2] = v.z; dst[s + 3] = v.w;
      } else {
        const double2 v = *reinterpret_cast<const double2*>(src + s);
        dst[s] = v.x; dst[s + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < NS; ++s) dst[s] = src[s];
  }
}

// float64 at NS = 32: 32 states and 32 software exps in flight take
// every register, and ptxas spills. There the decays live in a slot of
// shared memory and each walk runs twice, over 16 states at a time.
template <typename Acc, int NS>
__host__ __device__ constexpr bool split_states() {
  return sizeof(Acc) == 8 && NS == 32;
}

// The NS decays of a lane's channel: in registers, or in shared memory
template <typename Acc, int NS, bool SMEM = split_states<Acc, NS>()>
struct Decays {
  Acc r[NS];
  __device__ __forceinline__ void bind(Acc*) {}
  __device__ __forceinline__ void set(int s, Acc v) { r[s] = v; }
  __device__ __forceinline__ Acc operator[](int s) const { return r[s]; }
};

template <typename Acc, int NS>
struct Decays<Acc, NS, true> {
  Acc* p;                                        // the lane's column
  __device__ __forceinline__ void bind(Acc* lane_col) { p = lane_col; }
  __device__ __forceinline__ void set(int s, Acc v) { p[s * LANES] = v; }
  __device__ __forceinline__ Acc operator[](int s) const {
    return p[s * LANES];
  }
};

// 4 bytes into shared memory, asynchronously (zero when !valid; src
// must then still be an address of the array)
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dmma::smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__host__ __device__ inline int64_t state_size(int64_t n) {
  return n == 1 ? 1 : n <= 4 ? 4 : n <= 16 ? 16 : 32;
}

// Stage rows [t0, t0 + LC) x channels [i0, i0 + 32) of a (len, inner)
// slice into an (LC, 32) tile; values past len or inner are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int64_t t0,
                                           int64_t len, int64_t i0,
                                           int64_t inner, bool vec,
                                           int tid) {
  constexpr int threads = LANES * WARPS;
  if (vec) {
    constexpr int W = 16 / sizeof(T);            // values per copy
    constexpr int PER_ROW = LANES / W;
    for (int e = tid; e < LC * PER_ROW; e += threads) {
      const int r = e / PER_ROW;
      const int c = W * (e - r * PER_ROW);
      const bool ok = t0 + r < len && i0 + c < inner;
      const T* from = ok ? src + (t0 + r) * inner + i0 + c : src;
      dmma::copy16(dst + r * LANES + c, from, ok);
    }
  } else {
    for (int e = tid; e < LC * LANES; e += threads) {
      const int r = e / LANES;
      const int c = e - r * LANES;
      const bool ok = t0 + r < len && i0 + c < inner;
      dst[e] = ok ? src[(t0 + r) * inner + i0 + c] : from_acc<T>(0.0f);
    }
  }
}

}  // namespace
