// The gradient of flash attention for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(mask(softcap(Q K^T / sqrt(D)))) V on the single-KV-head
// layout q (BH, Sq, D), k/v (BH, Skv, D), from the forward's output O, its
// logsumexp per query row (lse, written by csrc/flash_attention.cu) and the
// output's gradient dO.
//
// The TPU package has no backward kernel: its training differentiates the
// plain attention that the Pallas kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// computes, with JAX's autodiff. The port runs that function on the card
// through its forward kernel, so its gradient needs a kernel too. The math
// is FlashAttention-2's, with S the scaled, capped and masked scores:
//
//   P  = exp(S - lse)                        (0 where the mask is off)
//   Δ  = rowsum(dO ⊙ O)                      (delta_kernel, the preamble)
//   dV = Pᵀ dO
//   dS = P ⊙ (dO Vᵀ - Δ) ⊙ (1 - tanh²)       (the last factor with a softcap)
//   dK = dSᵀ Q · scale,  dQ = dS K · scale
//
// Three kernels, launched in turn on the caller's stream by one C entry:
// delta_kernel (a warp per query row); dkdv_kernel, one block per
// (batch-head, tile of 16·TA keys) that walks the query tiles its keys can
// be seen from and keeps its dK and dV rows in registers; dq_kernel, one
// block per (batch-head, tile of 16·TA query rows) that walks the key
// tiles its rows see (the forward's bounds) and keeps its dQ rows in
// registers. Both recompute S and dO Vᵀ from shared tiles. No block writes
// what another block writes and nothing is atomic, so a rerun gives the
// same bits.
//
// Design: the forward's FMA kernel, twice. 256 threads as 16 x 16; thread
// (ty, tx) owns rows ty + 16a (a < TA) of the block's own tile and
// columns tx + 16c (c < NC, NC = ceil(D / 16) rounded up to an
// instantiated size) of its accumulators, and the pairs (ty + 16a,
// tx + 16b) of each score tile (b < TB). Tiles live in shared memory in
// the accumulation type with rows of D + 1 values (conflict-free column
// reads); P and dS pass through two small shared tiles. Float64 takes
// TB = 1 (16 rows a step), so the tiles of D = 288 fit the 227 KB a block
// may have; float32 and bf16 take TB = 2. No wgmma, TMA or DMMA yet: a
// later design.
//
// Bound on an H100 SXM: 5 products of 2·D operations for each valid
// (query, key) pair (S, dO Vᵀ, dV, dK, dQ) against (4 Sq + 4 Skv) D
// values moved: bound by operations at a training layer's shapes (S =
// 4096: ~1000 operations a byte). This design computes 7 products a pair
// (dq_kernel recomputes S and dO Vᵀ) on the FMA pipes, at about one
// shared-memory read per FMA.
//
// Types: double in, double accumulation; float in, float; bf16 in, float.
// Rows with no valid key (a window that lies past the last key) are not
// differentiated: the wrapper refuses them.
//
// C interface (loaded with ctypes): pointers (q, k, v, o, dO, lse, delta
// scratch of BH x Sq accumulation values, dq, dk, dv), the sizes, the
// options and the CUDA stream; each entry returns a cudaError_t.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 16 row groups x 16 column groups
constexpr int MAX_D = 288;          // gemma2_2b: 2304 / 8 heads

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
__device__ __forceinline__ float th(float x) { return tanhf(x); }
__device__ __forceinline__ double th(double x) { return tanh(x); }

__device__ __forceinline__ bool valid(int qp, int kp, int causal,
                                      int window) {
  bool ok = true;
  if (causal) ok = kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// loads rows [r0, r0 + rows) of a (n, d) matrix into a rows x (d + 1)
// shared tile in the accumulation type, zero past row n
template <typename T, typename Acc>
__device__ __forceinline__ void stage(Acc* dst, const T* src, int r0,
                                      int rows, int n, int d, int tid) {
  const int ld = d + 1;
  for (int e = tid; e < rows * d; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * ld + c] = (r0 + r < n)
        ? to_acc<Acc>(src[(int64_t)(r0 + r) * d + c]) : Acc(0);
  }
}

// scores and dO Vᵀ of the thread's TA x TB pairs: own rows ty + 16a of
// (x1, x2), walked rows tx + 16b of (y1, y2); s = x1 . y1, dp = x2 . y2
// (in dkdv_kernel x = (K, V), y = (Q, dO); in dq_kernel x = (Q, dO),
// y = (K, V), and the products are the same sums)
template <typename Acc, int TA, int TB>
__device__ __forceinline__ void pair_products(
    const Acc* x1, const Acc* x2, const Acc* y1, const Acc* y2, int d,
    int ty, int tx, Acc (&s)[TA][TB], Acc (&dp)[TA][TB]) {
  const int ld = d + 1;
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int b = 0; b < TB; ++b) s[a][b] = dp[a][b] = Acc(0);
#pragma unroll 4
  for (int dd = 0; dd < d; ++dd) {
    Acc a1[TA], a2[TA], b1[TB], b2[TB];
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      a1[a] = x1[(ty + 16 * a) * ld + dd];
      a2[a] = x2[(ty + 16 * a) * ld + dd];
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      b1[b] = y1[(tx + 16 * b) * ld + dd];
      b2[b] = y2[(tx + 16 * b) * ld + dd];
    }
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        s[a][b] += a1[a] * b1[b];
        dp[a][b] += a2[a] * b2[b];
      }
  }
}

// (P, dS) of one pair from its raw score s and dO . V (dp): the scaled,
// capped score, the mask, P = exp(S - lse) and dS = P (dp - Δ)(1 - tanh²)
template <typename Acc>
__device__ __forceinline__ void grad_pair(Acc s, Acc dp, bool ok, Acc lse,
                                          Acc delta, Acc scale, Acc softcap,
                                          Acc* p_out, Acc* ds_out) {
  Acc x = s * scale;
  Acc t = Acc(0);
  if (softcap > Acc(0)) {
    t = th(x / softcap);
    x = t * softcap;
  }
  const Acc p = ok ? ex(x - lse) : Acc(0);
  Acc ds = ok ? p * (dp - delta) : Acc(0);
  if (softcap > Acc(0)) ds *= Acc(1) - t * t;
  *p_out = p;
  *ds_out = ds;
}

// the preamble: delta[r] = sum_c dO[r][c] O[r][c], a warp per row
template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             Acc* __restrict__ delta, int64_t rows, int d) {
  const int64_t row =
      (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                  // the whole warp
  const T* a = o + row * d;
  const T* b = dout + row * d;
  Acc sum = Acc(0);
  for (int c = lane; c < d; c += 32)
    sum += to_acc<Acc>(a[c]) * to_acc<Acc>(b[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// dK and dV of the 16·TA keys from k0 of batch-head blockIdx.y
template <typename T, typename Acc, int NC, int TA, int TB>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const Acc* __restrict__ lse, const Acc* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int d,
            Acc scale, int causal, int window, Acc softcap) {
  constexpr int BA = 16 * TA;      // keys of the block
  constexpr int BB = 16 * TB;      // query rows a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  Acc* ks = reinterpret_cast<Acc*>(smem_raw);   // BA x ld
  Acc* vs = ks + BA * ld;                        // BA x ld
  Acc* qs = vs + BA * ld;                        // BB x ld
  Acc* dos = qs + BB * ld;                       // BB x ld
  Acc* ps = dos + BB * ld;                       // BA x (BB + 1)
  Acc* dss = ps + BA * (BB + 1);                 // BA x (BB + 1)
  Acc* lse_s = dss + BA * (BB + 1);              // BB
  Acc* del_s = lse_s + BB;                       // BB

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BA;
  const T* qb = q + bh * sq * d;
  const T* dob = dout + bh * sq * d;
  const Acc* lb = lse + bh * sq;
  const Acc* db = delta + bh * sq;

  stage<T, Acc>(ks, k + bh * skv * d, k0, BA, skv, d, tid);
  stage<T, Acc>(vs, v + bh * skv * d, k0, BA, skv, d, tid);

  Acc gk[TA][NC], gv[TA][NC];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[a][c] = gv[a][c] = Acc(0);

  // the query rows that see a key of the block: from the first key on
  // (causal), up to the last key's window
  const int k_last = min(k0 + BA, skv) - 1;
  int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(sq, k_last + window) : sq;
  q_begin = (q_begin / BB) * BB;

  for (int qt = q_begin; qt < q_end; qt += BB) {
    __syncthreads();            // the last step is done with its tiles
    stage<T, Acc>(qs, qb, qt, BB, sq, d, tid);
    stage<T, Acc>(dos, dob, qt, BB, sq, d, tid);
    if (tid < BB) {
      lse_s[tid] = qt + tid < sq ? lb[qt + tid] : Acc(0);
      del_s[tid] = qt + tid < sq ? db[qt + tid] : Acc(0);
    }
    __syncthreads();

    Acc s[TA][TB], dp[TA][TB];
    pair_products<Acc, TA, TB>(ks, vs, qs, dos, d, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int kp = k0 + ty + 16 * a;
        const int r = tx + 16 * b;
        const int qp = qt + r;
        const bool ok = kp < skv && qp < sq && valid(qp, kp, causal, window);
        grad_pair<Acc>(s[a][b], dp[a][b], ok, lse_s[r], del_s[r], scale,
                       softcap, &ps[(ty + 16 * a) * (BB + 1) + r],
                       &dss[(ty + 16 * a) * (BB + 1) + r]);
      }
    __syncthreads();

    // dV += P dO, dK += dS Q over the step's query rows
    for (int j = 0; j < BB; ++j) {
      Acc pa[TA], da[TA];
#pragma unroll
      for (int a = 0; a < TA; ++a) {
        pa[a] = ps[(ty + 16 * a) * (BB + 1) + j];
        da[a] = dss[(ty + 16 * a) * (BB + 1) + j];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const Acc go = dos[j * ld + col];
          const Acc qq = qs[j * ld + col];
#pragma unroll
          for (int a = 0; a < TA; ++a) {
            gv[a][c] += pa[a] * go;
            gk[a][c] += da[a] * qq;
          }
        }
      }
    }
  }

  T* dkb = dk + bh * skv * d;
  T* dvb = dv + bh * skv * d;
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    const int r = k0 + ty + 16 * a;
    if (r >= skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dkb[(int64_t)r * d + col] = from_acc<T, Acc>(gk[a][c] * scale);
        dvb[(int64_t)r * d + col] = from_acc<T, Acc>(gv[a][c]);
      }
    }
  }
}

// dQ of the 16·TA query rows from q0 of batch-head blockIdx.y
template <typename T, typename Acc, int NC, int TA, int TB>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const Acc* __restrict__ lse, const Acc* __restrict__ delta,
          T* __restrict__ dq, int sq, int skv, int d, Acc scale, int causal,
          int window, Acc softcap) {
  constexpr int BA = 16 * TA;      // query rows of the block
  constexpr int BB = 16 * TB;      // keys a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  Acc* qs = reinterpret_cast<Acc*>(smem_raw);   // BA x ld
  Acc* dos = qs + BA * ld;                       // BA x ld
  Acc* ks = dos + BA * ld;                       // BB x ld
  Acc* vs = ks + BB * ld;                        // BB x ld
  Acc* dss = vs + BB * ld;                       // BA x (BB + 1)
  Acc* lse_s = dss + BA * (BB + 1);              // BA
  Acc* del_s = lse_s + BA;                       // BA

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BA;
  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;

  stage<T, Acc>(qs, q + bh * sq * d, q0, BA, sq, d, tid);
  stage<T, Acc>(dos, dout + bh * sq * d, q0, BA, sq, d, tid);
  if (tid < BA) {
    lse_s[tid] = q0 + tid < sq ? lse[bh * sq + q0 + tid] : Acc(0);
    del_s[tid] = q0 + tid < sq ? delta[bh * sq + q0 + tid] : Acc(0);
  }

  Acc gq[TA][NC];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) gq[a][c] = Acc(0);

  // the keys the block's rows see (every row has one: the wrapper
  // refuses rows with none)
  const int q_last = min(q0 + BA, sq) - 1;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  k_begin = (k_begin / BB) * BB;

  for (int kt = k_begin; kt < k_end; kt += BB) {
    __syncthreads();            // the last step is done with its tiles
    stage<T, Acc>(ks, kb, kt, BB, skv, d, tid);
    stage<T, Acc>(vs, vb, kt, BB, skv, d, tid);
    __syncthreads();

    Acc s[TA][TB], dp[TA][TB];
    pair_products<Acc, TA, TB>(qs, dos, ks, vs, d, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int r = ty + 16 * a;
        const int qp = q0 + r;
        const int kp = kt + tx + 16 * b;
        const bool ok = kp < skv && qp < sq && valid(qp, kp, causal, window);
        Acc p;
        grad_pair<Acc>(s[a][b], dp[a][b], ok, lse_s[r], del_s[r], scale,
                       softcap, &p, &dss[r * (BB + 1) + tx + 16 * b]);
      }
    __syncthreads();

    // dQ += dS K over the step's keys
    for (int j = 0; j < BB; ++j) {
      Acc da[TA];
#pragma unroll
      for (int a = 0; a < TA; ++a)
        da[a] = dss[(ty + 16 * a) * (BB + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const Acc kk = ks[j * ld + col];
#pragma unroll
          for (int a = 0; a < TA; ++a) gq[a][c] += da[a] * kk;
        }
      }
    }
  }

  T* dqb = dq + bh * sq * d;
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        dqb[(int64_t)r * d + col] = from_acc<T, Acc>(gq[a][c] * scale);
    }
  }
}

template <typename Acc, int TA, int TB>
size_t dkdv_smem(int d) {
  return (size_t)(2 * 16 * TA * (d + 1) + 2 * 16 * TB * (d + 1)
                  + 2 * 16 * TA * (16 * TB + 1) + 2 * 16 * TB) * sizeof(Acc);
}

template <typename Acc, int TA, int TB>
size_t dq_smem(int d) {
  return (size_t)(2 * 16 * TA * (d + 1) + 2 * 16 * TB * (d + 1)
                  + 16 * TA * (16 * TB + 1) + 2 * 16 * TA) * sizeof(Acc);
}

template <typename T, typename Acc, int NC>
int launch_nc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int bh, int sq, int skv, int d, int causal,
              int window, double softcap, cudaStream_t stream) {
  constexpr int TA = 2;
  constexpr int TB = sizeof(Acc) == 8 ? 1 : 2;   // f64 tiles fit at D = 288
  const Acc scale = Acc(1.0 / sqrt((double)d));
  auto kv_kern = dkdv_kernel<T, Acc, NC, TA, TB>;
  const size_t kv_smem = dkdv_smem<Acc, TA, TB>(d);
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  kv_kern<<<dim3((unsigned)((skv + 16 * TA - 1) / (16 * TA)), (unsigned)bh),
            THREADS, kv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const Acc*>(lse), static_cast<const Acc*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, d, scale, causal,
      window, Acc(softcap));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto q_kern = dq_kernel<T, Acc, NC, TA, TB>;
  const size_t q_smem = dq_smem<Acc, TA, TB>(d);
  err = cudaFuncSetAttribute(
      q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  q_kern<<<dim3((unsigned)((sq + 16 * TA - 1) / (16 * TA)), (unsigned)bh),
           THREADS, q_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const Acc*>(lse), static_cast<const Acc*>(delta),
      static_cast<T*>(dq), sq, skv, d, scale, causal, window, Acc(softcap));
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int64_t bh, int64_t sq, int64_t skv, int64_t d,
           int causal, int window, double softcap, void* stream_ptr) {
  if (d < 1 || d > MAX_D || bh > 65535 || sq > ((int64_t)1 << 30)
      || skv > ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t rows = bh * sq;
  const unsigned rows_blocks =
      (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  delta_kernel<T, Acc><<<rows_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<Acc*>(delta), rows, (int)d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, void*, int,
                         int, int, int, int, int, double, cudaStream_t);
  // the register tile's width: the least instantiated ceil(D / 16)
  Launch fn = launch_nc<T, Acc, 18>;
  if (d <= 192) fn = launch_nc<T, Acc, 12>;
  if (d <= 128) fn = launch_nc<T, Acc, 8>;
  if (d <= 64) fn = launch_nc<T, Acc, 4>;
  if (d <= 32) fn = launch_nc<T, Acc, 2>;
  return fn(q, k, v, dout, lse, delta, dq, dk, dv, (int)bh, (int)sq,
            (int)skv, (int)d, causal, window, softcap, stream);
}

}  // namespace

extern "C" {

#define FLASH_BWD_ENTRY(NAME, T, ACC)                                        \
  int NAME(const void* q, const void* k, const void* v, const void* o,      \
           const void* dout, const void* lse, void* delta, void* dq,        \
           void* dk, void* dv, int64_t bh, int64_t sq, int64_t skv,         \
           int64_t d, int causal, int window, double softcap,               \
           void* stream) {                                                   \
    return launch<T, ACC>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq, \
                          skv, d, causal, window, softcap, stream);         \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f64, double, double)
FLASH_BWD_ENTRY(flash_attention_bwd_f32, float, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16, float)

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
