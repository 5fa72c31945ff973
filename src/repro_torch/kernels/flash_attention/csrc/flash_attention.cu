// Flash attention O = softmax(mask(softcap(Q K^T / sqrt(D)))) V for Hopper
// (sm_90a), on the single-KV-head layout q (BH, Sq, D), k/v (BH, Skv, D).
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (body _flash_kernel): an online softmax whose running (max m, sum l,
// accumulator acc) was carried in VMEM scratch across the sequential KV
// grid axis. Here one block owns BQ = 32 query rows of one bh and walks
// the KV tiles itself, so nothing carries between blocks: each KV tile of
// BK = 32 keys is staged in shared memory (K first, then V in the same
// buffer), the running m and l of each row live in registers, replicated
// over the 16 threads that share the row, and acc lives in registers,
// each thread owning 2 rows x ceil(D/16) columns.
//
// Semantics, as the reference's: scores in promote(dtype, float32) scaled
// by 1/sqrt(D), an optional tanh softcap, the causal mask k <= q and the
// sliding window k > q - window, masked scores at -1e30; the
// probabilities are cast to the input type before the product with V;
// the output is acc / max(l, 1e-30), cast to the input type. Keys past
// Skv (the ragged edge) are no keys at all: they add nothing to m, l or
// acc, so nothing is padded. A row whose first tiles are fully masked
// gathers exp(-1e30 - (-1e30)) = 1 per masked key until its first valid
// key resets m, l and acc through corr = exp(-1e30 - m) = 0; so tiles
// that are masked for every row of the block are skipped, which gives the
// same result, unless a row of the block has no valid key at all (it then
// averages V over all keys, as the reference does).
//
// Bound on an H100 SXM: 4 Sq Skv D operations on (2 Skv + 2 Sq) D values
// moved, so at the main path's chunk (Sq = Skv = 4096, D = 128, float64)
// some 500 operations per byte: bound by operations. This first design is
// a plain FMA kernel: every shared-memory read of K or V feeds two rows'
// FMAs and every read of Q or P feeds two columns'. Tensor cores (DMMA for
// float64, wgmma for bf16), TMA staging and a pipelined K/V ring are later
// work.
//
// Shared memory: Q tile BQ x (D+1), K/V tile BK x (D+1), P tile BQ x BK,
// all in the accumulation type; the +1 row padding keeps a warp's reads
// of 16 different K rows in 16 different banks. At D = 288 in float64
// that is 156 KB, so the buffer is dynamic, its limit raised with
// cudaFuncSetAttribute before each launch.
//
// Types: double in, double accumulation; float in, float; bf16 in, float.
//
// C interface (loaded with ctypes): pointers, the sizes, the options and
// the CUDA stream; each entry returns a cudaError_t (0 on success).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 16 row groups x 16 column groups
constexpr int TM = 2;               // query rows per thread
constexpr int TN = 2;               // keys per thread in a score tile
constexpr int BQ = 16 * TM;         // query rows per block
constexpr int BK = 16 * TN;         // keys per KV tile
constexpr int MAX_D = 288;          // gemma2_2b: 2304 / 8 heads
constexpr double MASKED = -1e30;    // the reference's NEG_INF

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

// the value an accumulator holds after a round trip through the input
// type (the reference's p.astype(v.dtype))
template <typename T, typename Acc>
__device__ __forceinline__ Acc round_as(Acc v) {
  return to_acc<Acc, T>(from_acc<T, Acc>(v));
}

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float th(float x) { return tanhf(x); }
__device__ __forceinline__ double th(double x) { return tanh(x); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }

// reduce over the 16 lanes that share a row (lanes 0-15 or 16-31)
template <typename Acc>
__device__ __forceinline__ Acc row_max(Acc v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = mx(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <typename Acc>
__device__ __forceinline__ Acc row_sum(Acc v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NC: column groups per thread, ceil(D / 16) rounded up to an
// instantiated size (the accumulator is a register array)
template <typename T, typename Acc, int NC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int d, Acc scale, int causal, int window, Acc softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  Acc* qs = reinterpret_cast<Acc*>(smem_raw);   // BQ x ld
  Acc* kv = qs + BQ * ld;                        // BK x ld
  Acc* ps = kv + BK * ld;                        // BQ x BK

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;
  T* ob = o + bh * sq * d;

  // the block's query rows, zero past Sq (those rows are never stored)
  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    qs[r * ld + c] = (q0 + r < sq) ? to_acc<Acc>(qb[(int64_t)(q0 + r) * d + c])
                                   : Acc(0);
  }

  Acc m[TM], l[TM], acc[TM][NC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = Acc(MASKED);
    l[i] = Acc(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = Acc(0);
  }

  // KV tiles that hold a valid key for some row of the block; the rest
  // may be skipped only when every row of the block has a valid key
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_begin = 0;
  int k_end = skv;
  const bool every_row_valid = !(window > 0 && q_last - window + 1 > skv - 1);
  if (every_row_valid) {
    if (causal) k_end = min(skv, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();            // the previous tile's P.V is done with kv
    for (int e = tid; e < BK * d; e += THREADS) {
      const int r = e / d;
      const int c = e - r * d;
      kv[r * ld + c] = (kt + r < skv)
          ? to_acc<Acc>(kb[(int64_t)(kt + r) * d + c]) : Acc(0);
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    Acc s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = Acc(0);
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[(ty + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = kv[(tx + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] += a[i] * b[j];
    }

    Acc corr[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = q0 + ty + 16 * i;
      Acc tmax = Acc(MASKED);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kp = kt + tx + 16 * j;
        Acc x = s[i][j] * scale;
        if (softcap > Acc(0)) x = th(x / softcap) * softcap;
        bool ok = kp < skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? x : Acc(MASKED);
        tmax = mx(tmax, s[i][j]);
      }
      const Acc m_new = mx(m[i], row_max(tmax));
      Acc psum = Acc(0);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kp = kt + tx + 16 * j;
        const Acc p = (kp < skv) ? ex(s[i][j] - m_new) : Acc(0);
        psum += p;
        ps[(ty + 16 * i) * BK + tx + 16 * j] = round_as<T>(p);
      }
      corr[i] = ex(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(psum);
      m[i] = m_new;
    }
    __syncthreads();            // scores done with K; P is in shared

    for (int e = tid; e < BK * d; e += THREADS) {
      const int r = e / d;
      const int c = e - r * d;
      kv[r * ld + c] = (kt + r < skv)
          ? to_acc<Acc>(vb[(int64_t)(kt + r) * d + c]) : Acc(0);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
    for (int j = 0; j < BK; ++j) {
      Acc p[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ps[(ty + 16 * i) * BK + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const Acc vv = kv[j * ld + col];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][c] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const Acc den = mx(l[i], Acc(1e-30));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[(int64_t)r * d + col] = from_acc<T, Acc>(acc[i][c] / den);
    }
  }
}

template <typename T, typename Acc, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int skv, int d, int causal, int window, double softcap,
              void* stream) {
  const size_t smem = (size_t)(BQ * (d + 1) + BK * (d + 1) + BQ * BK)
                      * sizeof(Acc);
  auto kern = flash_kernel<T, Acc, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)bh);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, d,
      Acc(1.0 / sqrt((double)d)), causal, window, Acc(softcap));
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t sq, int64_t skv, int64_t d, int causal, int window,
           double softcap, void* stream) {
  if (d < 1 || d > MAX_D || bh > 65535 || sq > (int64_t)1 << 30
      || skv > (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;
  // the register tile's width: the least instantiated ceil(D / 16)
  using Launch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, int, double, void*);
  Launch fn = launch_nc<T, Acc, 18>;
  if (d <= 192) fn = launch_nc<T, Acc, 12>;
  if (d <= 128) fn = launch_nc<T, Acc, 8>;
  if (d <= 64) fn = launch_nc<T, Acc, 4>;
  if (d <= 32) fn = launch_nc<T, Acc, 2>;
  return fn(q, k, v, o, (int)bh, (int)sq, (int)skv, (int)d, causal, window,
            softcap, stream);
}

}  // namespace

extern "C" {

int flash_attention_f64(const void* q, const void* k, const void* v, void* o,
                        int64_t bh, int64_t sq, int64_t skv, int64_t d,
                        int causal, int window, double softcap,
                        void* stream) {
  return launch<double, double>(q, k, v, o, bh, sq, skv, d, causal, window,
                                softcap, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int64_t bh, int64_t sq, int64_t skv, int64_t d,
                        int causal, int window, double softcap,
                        void* stream) {
  return launch<float, float>(q, k, v, o, bh, sq, skv, d, causal, window,
                              softcap, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int64_t bh, int64_t sq, int64_t skv,
                         int64_t d, int causal, int window, double softcap,
                         void* stream) {
  return launch<__nv_bfloat16, float>(q, k, v, o, bh, sq, skv, d, causal,
                                      window, softcap, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
