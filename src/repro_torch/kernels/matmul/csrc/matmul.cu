// Tiled matrix product O(M,N) = X(M,K) @ Y(K,N) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py::matmul (body
// _matmul_kernel): a blocked product whose K axis was the sequential grid
// dimension, accumulated in promote(dtype, float32) and cast to the input
// type. Here every block owns one 64x64 output tile and walks K itself in
// steps of 16, so no state carries between blocks.
//
// Bound on an H100 SXM: the compiler's main path runs float64 chunks of
// about 4096 x 2048 @ 2048 x 2048, some 200 operations per byte moved,
// far above the card's ridge (67 TFLOP/s f64 over 3.35 TB/s = 20 per
// byte), so the kernel is bound by operations. Hopper's float64 peak
// needs DMMA (mma.sync m8n8k4.f64); wgmma has no f64 mode. This first
// design is a plain FMA kernel instead: each of 256 threads keeps a 4x4
// tile of accumulators in registers, so every value read from shared
// memory feeds four multiply-adds, and the tiles of X and Y are staged in
// shared memory so that each element of device memory is read once per
// block. Ragged edges are masked inside the kernel (zero-filled loads,
// guarded stores) instead of padding the operands. A DMMA design for f64
// and a wgmma/TMA design for bf16 and f32 are later work.
//
// Types: double in, double accumulator (the compiler path); float in,
// float accumulator; bf16 in, float accumulator. The output has the
// input's type.
//
// C interface (loaded with ctypes): pointers, the dimensions as int64 and
// the CUDA stream; each entry returns cudaGetLastError() after launching.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" {

int matmul_f64(const void* x, const void* y, void* o, int64_t m, int64_t n,
               int64_t k, void* stream) {
  return launch<double, double>(x, y, o, m, n, k, stream);
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
