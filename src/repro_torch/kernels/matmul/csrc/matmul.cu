// Tiled matrix product O(M,N) = X(M,K) @ Y(K,N) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py::matmul (body
// _matmul_kernel): a blocked product whose K axis was the sequential grid
// dimension, accumulated in promote(dtype, float32) and cast to the input
// type. Here every block owns one output tile and walks K itself, so no
// state carries between blocks. Ragged edges are masked inside the kernel
// (zero-filled loads, guarded stores) instead of padding the operands.
//
// Bound on an H100 SXM: the compiler's main path runs float64 chunks of
// about 4096 x 2048 @ 2048 x 2048, some 200 operations per byte moved,
// far above the card's ridge (67 TFLOP/s f64 over 3.35 TB/s = 20 per
// byte), so the kernel is bound by operations. Hopper reaches its float64
// peak only on the tensor cores through DMMA (mma.sync .f64; wgmma
// has no f64 mode); f64 FMA peaks at half of it.
//
// float64 (matmul_f64), the compiler's path: DMMA on Hopper's m16n8k8
// f64 fragments (csrc/dmma.cuh). A block of 8 warps owns a 128 x 128
// output tile, each warp a 64 x 32 tile of 4 x 4 fragments (64
// accumulators, 128 registers a thread), so every fragment read from
// shared memory feeds 4 products. X's and Y's tiles (K step 16) stream
// through a 4-stage cp.async ring in dynamic shared memory (149.5 KB):
// while the warps multiply one stage, the copies of the next three are
// in flight. Tiles are padded to a row stride of 4 (mod 16) doubles,
// which makes the fragment loads free of bank conflicts. Copies are 16
// bytes where every staged row starts on 16 bytes (even K and N, aligned
// bases), 8 bytes otherwise (an odd K puts every odd row of X 8 bytes
// off); the width is a template argument, so each kernel holds the
// addresses of one kind of copy only and stays within 255 registers
// without spilling. Row tiles run along grid.x (up to 2^31 - 1 of
// them), so any M fits; column tiles along grid.y (up to 65535, so N up
// to 8,388,480).
//
// float32 and bfloat16 (matmul_f32, matmul_bf16): a plain FMA kernel.
// 64 x 64 tiles walk K in steps of 16 through shared memory, each of 256
// threads keeping a 4 x 4 tile of accumulators in registers. float32 has
// no exact tensor-core mode (TF32 keeps about three digits), so its FMA
// peak is its bound; a wgmma/TMA design for bf16 is later work.
//
// Types: double in, double accumulator; float in, float accumulator;
// bf16 in, float accumulator. The output has the input's type.
//
// C interface (loaded with ctypes): pointers, the dimensions as int64 and
// the CUDA stream; each entry returns a cudaError_t (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // depth of one shared-memory stage
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
              "every thread stages the same number of elements");

template <typename Acc, typename T>
__device__ __forceinline__ Acc to_acc(T v) { return static_cast<Acc>(v); }

template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T from_acc(Acc v) { return static_cast<T>(v); }

template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ o, int64_t m, int64_t n, int64_t k) {
  // X's tile is stored k-major (xs[kk][row]) so the inner loop reads a
  // column of it; one element of padding per row spreads the transposing
  // stores over the banks
  __shared__ Acc xs[BK][BM + 1];
  __shared__ Acc ys[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // column group
  const int ty = tid / (BN / TN);   // row group
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    // stage X(row0:row0+BM, k0:k0+BK): neighbouring threads read
    // neighbouring k, so each row segment is one coalesced read
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int64_t gr = row0 + r;
      const int64_t gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_acc<Acc>(x[gr * k + gc]) : Acc(0);
    }
    // stage Y(k0:k0+BK, col0:col0+BN): neighbouring threads read
    // neighbouring columns
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int64_t gr = k0 + r;
      const int64_t gc = col0 + c;
      ys[r][c] = (gr < k && gc < n) ? to_acc<Acc>(y[gr * n + gc]) : Acc(0);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM];
      Acc b[TN];
      // strided ownership (ty + i*16, tx + j*16): a warp's reads of ys
      // hit 16 consecutive words, and its stores below coalesce
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];   // FMA
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty + i * (BM / TM);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx + j * (BN / TN);
      if (gc < n) o[gr * n + gc] = from_acc<T, Acc>(acc[i][j]);
    }
  }
}

template <typename T, typename Acc>
int launch(const void* x, const void* y, void* o, int64_t m, int64_t n,
           int64_t k, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  matmul_kernel<T, Acc><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(o), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ---- float64 on the tensor cores (DMMA) ----
namespace f64 {

constexpr int BM = 128;            // output rows per block
constexpr int BN = 128;            // output columns per block
constexpr int BK = 16;             // depth of one stage
constexpr int STAGES = 4;          // stages of the cp.async ring
constexpr int WM = 64;             // output rows per warp
constexpr int WN = 32;             // output columns per warp
constexpr int THREADS = 32 * (BM / WM) * (BN / WN);   // 256
constexpr int MK = 8;              // depth of one product (m16n8k8)
constexpr int FM = WM / 16;        // accumulator fragments per warp: rows
constexpr int FN = WN / 8;         //                                 cols
constexpr int LDA = BK + 4;        // row strides of the staged tiles, 4
constexpr int LDB = BN + 4;        // (mod 16) doubles: no bank conflicts
constexpr int A_STAGE = BM * LDA;  // doubles
constexpr int B_STAGE = BK * LDB;
constexpr size_t SMEM =
    (size_t)STAGES * (A_STAGE + B_STAGE) * sizeof(double);   // 149.5 KB

// VEC: 16-byte copies (every staged row of X and Y starts on 16 bytes)
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const double* __restrict__ x, const double* __restrict__ y,
              double* __restrict__ o, int64_t m, int64_t n, int64_t k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* as = reinterpret_cast<double*>(smem_raw);   // STAGES x BM x LDA
  double* bs = as + STAGES * A_STAGE;                 // STAGES x BK x LDB

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;          // fragment row (A, C) / column (B)
  const int t = lane % 4;          // fragment column (A) / row (B)
  const int wm = (warp / (BN / WN)) * WM;
  const int wn = (warp % (BN / WN)) * WN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int ktiles = static_cast<int>((k + BK - 1) / BK);

  // X(row0:+BM, k0:+BK) and Y(k0:+BK, col0:+BN) into stage s
  auto stage = [&](int s, int kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * BK;
    dmma::stage_tile<BM, BK, LDA, THREADS, VEC>(as + s * A_STAGE, x + k0,
                                                row0, m, k, k - k0, tid);
    dmma::stage_tile<BK, BN, LDB, THREADS, VEC>(bs + s * B_STAGE,
                                                y + k0 * n + col0, 0, k - k0,
                                                n, n - col0, tid);
  };

  double acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  // the ring: stage kt + STAGES - 1 is copied while stage kt is multiplied
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) stage(s, s);
    dmma::commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    dmma::wait<STAGES - 2>();      // this thread's copies of stage kt
    __syncthreads();               // everyone's; and stage kt - 1 is free
    if (kt + STAGES - 1 < ktiles)
      stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    dmma::commit();

    const double* a = as + (kt % STAGES) * A_STAGE + (wm + g) * LDA + t;
    const double* b = bs + (kt % STAGES) * B_STAGE + t * LDB + wn + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += MK) {
      double af[FM][MK / 2], bf[FN][MK / 4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int e = 0; e < MK / 2; ++e)   // A[g + 8 (e % 2)][t + 4 (e / 2)]
          af[i][e] = a[(i * 16 + 8 * (e % 2)) * LDA + kk + 4 * (e / 2)];
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int u = 0; u < MK / 4; ++u)   // B[t + 4 u][g]
          bf[j][u] = b[(kk + 4 * u) * LDB + j * 8];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          dmma::mma_m16n8k8(acc[i][j], af[i], bf[j]);
    }
  }

  // acc[i][j][e + 2 h] is O[wm + 16 i + 8 h + g][wn + 8 j + 2 t + e]
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gr = row0 + wm + i * 16 + 8 * h + g;
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int64_t gc = col0 + wn + j * 8 + 2 * t;
        if (gc < n) o[gr * n + gc] = acc[i][j][2 * h];
        if (gc + 1 < n) o[gr * n + gc + 1] = acc[i][j][2 * h + 1];
      }
    }
}

template <bool VEC>
int launch_vec(const void* x, const void* y, void* o, int64_t m, int64_t n,
               int64_t k, void* stream) {
  const int64_t row_tiles = (m + BM - 1) / BM;
  const int64_t col_tiles = (n + BN - 1) / BN;
  if (row_tiles > 0x7fffffff || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(col_tiles));
  matmul_kernel<VEC><<<grid, THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(y),
      static_cast<double*>(o), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* y, void* o, int64_t m, int64_t n,
           int64_t k, void* stream) {
  // 16-byte copies where every staged row starts on 16 bytes: even K and
  // N, aligned bases; else 8-byte copies (an odd K puts every odd row of
  // X 8 bytes off)
  const bool vec = k % 2 == 0 && n % 2 == 0
      && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y))
             % 16 == 0;
  return vec ? launch_vec<true>(x, y, o, m, n, k, stream)
             : launch_vec<false>(x, y, o, m, n, k, stream);
}

}  // namespace f64

}  // namespace

extern "C" {

int matmul_f64(const void* x, const void* y, void* o, int64_t m, int64_t n,
               int64_t k, void* stream) {
  return f64::launch(x, y, o, m, n, k, stream);
}

int matmul_f32(const void* x, const void* y, void* o, int64_t m, int64_t n,
               int64_t k, void* stream) {
  return launch<float, float>(x, y, o, m, n, k, stream);
}

int matmul_bf16(const void* x, const void* y, void* o, int64_t m, int64_t n,
                int64_t k, void* stream) {
  return launch<__nv_bfloat16, float>(x, y, o, m, n, k, stream);
}

const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
