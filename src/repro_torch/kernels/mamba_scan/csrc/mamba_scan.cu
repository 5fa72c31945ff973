// Selective scan (Mamba) for Hopper (sm_90a):
//   h_t = exp(dt_t * -exp(a)) (.) h_{t-1} + (dt_t x_t) (x) B_t
//   y_t = h_t . C_t + d_skip (.) x_t
// with x, dt (B, L, I), Bm, Cm (B, L, N), a (I, N), d_skip (I,), y (B, L, I).
//
// Replaces the TPU kernel repro/kernels/mamba_scan/mamba_scan.py::mamba_scan
// (body _scan_kernel): a chunked recurrence whose (I, N) state was carried
// in VMEM scratch across the sequential L-chunk grid axis, which needed
// L % chunk == 0. Here there is no chunking: each thread owns one (b, i)
// channel, keeps its N state values and its N decays -exp(a[i, :]) in
// registers, and walks L in order, so any L is taken. Neighbouring
// threads own neighbouring i, so every load of x and dt and every store of
// y is one coalesced row segment of the (B, L, I) layout; the B_t and C_t
// of a step are the same for every thread of a block (one b) and are read
// as broadcasts.
//
// Bound on an H100 SXM: each input value is read once and each output
// written once, against N exps (plus a few FMAs) per (b, t, i). In
// float32 the exps run on the SFU and the kernel is bound by bytes at
// every width the repo uses; in float64 exp is a software routine of
// some 20 double operations, which brings N = 16 to about 17
// operations per byte moved, near the float64 ridge (67 TFLOP/s over
// 3.35 TB/s = 20). On the
// compiler's scan path (N = 1, I = a chunk's rows, B = 1) only rows-many
// threads exist and each walks L serially, so that path is bound by the
// latency of the dependent chain, not by either roof; a parallel-in-L
// (chunked associative) design is later work.
//
// Types: the state and arithmetic in promote(dtype, float32): double in,
// double; float in, float; bf16 in, float. y has the input type.
//
// C interface (loaded with ctypes): pointers, the sizes and the CUDA
// stream; each entry returns a cudaError_t (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;        // channels per block
constexpr int MAX_N = 32;

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

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }

// NS: state registers per thread, N rounded up to an instantiated size
template <typename T, typename Acc, int NS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const T* __restrict__ a, const T* __restrict__ d_skip,
            T* __restrict__ y, int64_t len, int inner, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (i >= inner) return;

  Acc decay[NS], h[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    decay[s] = s < n ? -ex(to_acc<Acc>(a[(int64_t)i * n + s])) : Acc(0);
    h[s] = Acc(0);
  }
  const Acc dskip = to_acc<Acc>(d_skip[i]);

  const T* xb = x + b * len * inner + i;
  const T* dtb = dt + b * len * inner + i;
  const T* bb = bm + b * len * n;
  const T* cb = cm + b * len * n;
  T* yb = y + b * len * inner + i;

#pragma unroll 4
  for (int64_t t = 0; t < len; ++t) {
    const Acc xt = to_acc<Acc>(xb[t * inner]);
    const Acc dtt = to_acc<Acc>(dtb[t * inner]);
    const Acc dx = dtt * xt;
    Acc yt = Acc(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < n) {
        const Acc a_bar = ex(dtt * decay[s]);
        h[s] = a_bar * h[s] + dx * to_acc<Acc>(__ldg(bb + t * n + s));
        yt += h[s] * to_acc<Acc>(__ldg(cb + t * n + s));
      }
    }
    yb[t * inner] = from_acc<T, Acc>(yt + dskip * xt);
  }
}

template <typename T, typename Acc, int NS>
int launch_ns(const void* x, const void* dt, const void* bm, const void* cm,
              const void* a, const void* d_skip, void* y, int64_t batch,
              int64_t len, int inner, int n, void* stream) {
  const dim3 grid((unsigned)((inner + THREADS - 1) / THREADS),
                  (unsigned)batch);
  scan_kernel<T, Acc, NS><<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(a), static_cast<const T*>(d_skip),
      static_cast<T*>(y), len, inner, n);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* d_skip, void* y, int64_t batch,
           int64_t len, int64_t inner, int64_t n, void* stream) {
  if (n < 1 || n > MAX_N || batch > 65535 || inner > (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;
  // the state registers: the least instantiated size holding N
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, int64_t, int64_t,
                         int, int, void*);
  Launch fn = launch_ns<T, Acc, 32>;
  if (n <= 16) fn = launch_ns<T, Acc, 16>;
  if (n <= 4) fn = launch_ns<T, Acc, 4>;
  if (n == 1) fn = launch_ns<T, Acc, 1>;
  return fn(x, dt, bm, cm, a, d_skip, y, batch, len, (int)inner, (int)n,
            stream);
}

}  // namespace

extern "C" {

int mamba_scan_f64(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* d_skip,
                   void* y, int64_t batch, int64_t len, int64_t inner,
                   int64_t n, void* stream) {
  return launch<double, double>(x, dt, bm, cm, a, d_skip, y, batch, len,
                                inner, n, stream);
}

int mamba_scan_f32(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* d_skip,
                   void* y, int64_t batch, int64_t len, int64_t inner,
                   int64_t n, void* stream) {
  return launch<float, float>(x, dt, bm, cm, a, d_skip, y, batch, len,
                              inner, n, stream);
}

int mamba_scan_bf16(const void* x, const void* dt, const void* bm,
                    const void* cm, const void* a, const void* d_skip,
                    void* y, int64_t batch, int64_t len, int64_t inner,
                    int64_t n, void* stream) {
  return launch<__nv_bfloat16, float>(x, dt, bm, cm, a, d_skip, y, batch,
                                      len, inner, n, stream);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
