// Flash attention O = softmax(mask(softcap(Q K^T / sqrt(D)))) V for Hopper
// (sm_90a), on the single-KV-head layout q (BH, Sq, D), k/v (BH, Skv, D).
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (body _flash_kernel): an online softmax whose running (max m, sum l,
// accumulator acc) was carried in VMEM scratch across the sequential KV
// grid axis. Here one block owns a tile of query rows of one bh and walks
// the KV tiles itself, so nothing carries between blocks.
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
// Query positions: row i of batch-head r sits at position q_offset[r] + i
// (the reference's plain_attention(..., q_offset=...); a null q_offset is
// all zeros). A decode step's single query of a slot at position 8000 of
// an 8192-key cache thus sees keys [0, 8000] (causal), or the window's
// (8000 - window, 8000], and the tile bounds (key_bounds) keep its block
// from reading the cache's unwritten rest. Positions are 32-bit:
// q_offset + Sq must stay below 2^31.
//
// Bound on an H100 SXM: 4 Sq Skv D operations on (2 Skv + 2 Sq) D values
// moved, so at the main path's chunk (Sq = Skv = 4096, D = 128, float64)
// some 500 operations per byte: bound by operations. In float64 the peak
// (67 TFLOP/s) is reached only on the tensor cores, through DMMA.
//
// float64 (flash_attention_f64), the compiler's path: DMMA for both
// products, on Hopper's m16n8k8 f64 fragments. A block owns 64 query
// rows; a warp owns 16 of them and holds their scores, running max and
// sum, and accumulator in registers (the max and sum reduce over the 4
// lanes that share a row). P leaves Q K^T in the accumulator layout and
// enters P V as the A operand with no data movement: the sum over keys
// may take them in any order, so the A operand's k-th column stands for
// the key this lane already holds, and V's rows are read in that order
// (csrc/dmma.cuh). Q is staged once; K and V have a buffer each, filled
// by cp.async so that V's copy overlaps the scores and the next K's copy
// overlaps P V. Tiles are sized per class of D (a template): D is
// zero-filled to the class's width (32, 64, 128, 192 or 288). Up to
// D = 128 two groups of 4 warps walk alternate KV tiles of 32 keys, each
// with its own K and V, and merge their (m, l, acc) at the end, so the
// tensor cores of an SM have work while one group computes its softmax.
// Above, the accumulator of 16 rows no longer fits one warp's registers,
// so two warps share each 16 rows, one half of D's columns each (both
// compute the rows' scores), with one group and, at D = 288, KV tiles of
// 16 keys: Q, K and V then take 219 KB of the 227 KB a block may have.
// Row strides of 4 (Q, K) and 2 (V) mod 16 doubles keep every fragment
// load free of bank conflicts. Copies are 16 bytes where D is even and
// the bases aligned, else 8 (a template argument, as in the matmul), and
// each thread issues them two at a time: with more in flight, their
// addresses crowd the accumulators out of the registers.
//
// float32 and bfloat16 (flash_attention_f32, _bf16): a plain FMA kernel.
// One block of 256 threads owns BQ = 32 query rows and walks KV tiles of
// BK = 32 keys (K, then V, staged through one buffer), each thread owning
// 2 rows x ceil(D/16) columns of acc and a row's m and l replicated over
// the 16 threads that share it. Its shared memory: Q tile BQ x (D+1), K/V
// tile BK x (D+1), P tile BQ x BK in the accumulation type; the +1 row
// padding keeps a warp's reads of 16 different K rows in 16 different
// banks. float32 has no exact tensor-core mode; a wgmma/TMA design for
// bf16 is later work.
//
// Types: double in, double accumulation; float in, float; bf16 in, float.
//
// Logsumexp (for the backward kernels, csrc/flash_attention_bwd.cu): with
// a non-null lse pointer each stored row r also writes lse[r] = m + log(l),
// the log of its softmax denominator over the scaled, capped and masked
// scores in the accumulation type, so that the probabilities are
// P = exp(S - lse). A null pointer (the served path) writes nothing.
//
// C interface (loaded with ctypes): pointers (q, k, v, o, lse or null, and
// q_offset, an int32 array of BH positions or null), the sizes, the
// options and the CUDA stream; each entry returns a cudaError_t (0 on
// success). flash_attention_abi() is 2 for this signature (1 had no lse).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

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
__device__ __forceinline__ float th(float x) { return tanhf(x); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }

bool sizes_ok(int64_t bh, int64_t sq, int64_t skv, int64_t d) {
  return d >= 1 && d <= MAX_D && bh <= 65535 && sq <= (int64_t)1 << 30
         && skv <= (int64_t)1 << 30;
}

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

// (x, y) = [begin, end): the keys a block of query rows at positions
// [p_first, p_last] walks. A row at position p has the valid keys
// [max(0, p - window + 1), min(skv - 1, p)] (each bound where its mask is
// on); every row has one unless a causal row lies before key 0 or a
// window lies past the last key. Only then are the keys outside the union
// of the rows' ranges skipped: a row with no valid key averages every
// key's V, so its block walks them all.
__device__ __forceinline__ int2 key_bounds(int p_first, int p_last, int skv,
                                           int causal, int window) {
  const bool every_row_valid = !(causal && p_first < 0)
      && !(window > 0 && p_last - window + 1 > skv - 1);
  if (!every_row_valid) return make_int2(0, skv);
  return make_int2(window > 0 ? max(0, p_first - window + 1) : 0,
                   causal ? min(skv, p_last + 1) : skv);
}

// NC: column groups per thread, ceil(D / 16) rounded up to an
// instantiated size (the accumulator is a register array). At least 3
// blocks an SM, so at most 85 registers a thread: with no minimum, ptxas
// gave the D <= 192 instantiations 64 and spilled once the query offset
// was added (it now takes 77-80 and spills nothing)
template <typename T, typename Acc, int NC>
__global__ void __launch_bounds__(THREADS, 3)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             Acc* __restrict__ lse,
             const int* __restrict__ q_offset, int sq, int skv, int d,
             Acc scale, int causal, int window, Acc softcap) {
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
  const int pos0 = (q_offset ? q_offset[bh] : 0) + q0;   // row q0's position
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

  // KV tiles that hold a valid key for some row of the block
  const int2 keys = key_bounds(pos0, pos0 + min(BQ, sq - q0) - 1, skv,
                               causal, window);
  const int k_begin = (keys.x / BK) * BK;
  const int k_end = keys.y;

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
      const int qp = pos0 + ty + 16 * i;
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
    if (lse != nullptr && tx == 0) lse[bh * sq + r] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[(int64_t)r * d + col] = from_acc<T, Acc>(acc[i][c] / den);
    }
  }
}

template <typename T, typename Acc, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o,
              void* lse, const int* q_offset, int bh, int sq, int skv, int d,
              int causal,
              int window, double softcap, void* stream) {
  const size_t smem = (size_t)(BQ * (d + 1) + BK * (d + 1) + BQ * BK)
                      * sizeof(Acc);
  auto kern = flash_kernel<T, Acc, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)bh);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<Acc*>(lse),
      q_offset, sq, skv, d, Acc(1.0 / sqrt((double)d)), causal, window,
      Acc(softcap));
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const int* q_offset, int64_t bh, int64_t sq, int64_t skv,
           int64_t d, int causal, int window, double softcap, void* stream) {
  if (!sizes_ok(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  // the register tile's width: the least instantiated ceil(D / 16)
  using Launch = int (*)(const void*, const void*, const void*, void*, void*,
                         const int*, int, int, int, int, int, int, double,
                         void*);
  Launch fn = launch_nc<T, Acc, 18>;
  if (d <= 192) fn = launch_nc<T, Acc, 12>;
  if (d <= 128) fn = launch_nc<T, Acc, 8>;
  if (d <= 64) fn = launch_nc<T, Acc, 4>;
  if (d <= 32) fn = launch_nc<T, Acc, 2>;
  return fn(q, k, v, o, lse, q_offset, (int)bh, (int)sq, (int)skv, (int)d,
            causal, window, softcap, stream);
}

// ---- float64 on the tensor cores (DMMA) ----
namespace f64 {

constexpr int BQ = 64;             // query rows per block
constexpr int RW = 16;             // query rows per warp: one m16 fragment
constexpr int MK = 8;              // depth of one product (m16n8k8)

// A tile of the kernel. DP: D rounded up to the class's width. CS: warps
// that share 16 query rows, each owning DP / CS columns of the output
// (each computes the rows' scores). G: groups of warps that walk every
// G-th KV tile, each with its own K and V buffers, combined at the end.
// BKV: keys per KV tile.
template <int DP, int CS, int G, int BKV>
struct Tile {
  static constexpr int GROUP = 32 * (BQ / RW) * CS;   // threads of a group
  static constexpr int THREADS = GROUP * G;
  static constexpr int LDQ = DP + 4;   // Q, K: 4 (mod 16) doubles
  static constexpr int LDV = DP + 2;   // V: 2 (mod 16), see P V below
  static constexpr int FS = BKV / 8;   // score fragments (keys)
  static constexpr int FO = DP / CS / 8;   // output fragments (columns)
  static constexpr int KV = BKV * (LDQ + LDV);   // doubles of one K and V
  static constexpr size_t SMEM =
      (size_t)(BQ * LDQ + G * KV) * sizeof(double);
  static_assert(DP % 16 == 0 && BKV % 8 == 0 && (DP / CS) % 8 == 0,
                "tile shape");
  static_assert(SMEM <= 232448, "a block has at most 227 KB");
  static_assert(G == 1 || BQ * (DP + 2) <= KV,
                "the combine fits in a group's K and V buffers");
};

// barrier of the `count` threads of one group (ids 1.., 0 is
// __syncthreads)
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// VEC: 16-byte copies (an even D and aligned bases)
template <int DP, int CS, int G, int BKV, bool VEC>
__global__ void __launch_bounds__(Tile<DP, CS, G, BKV>::THREADS, 1)
flash_kernel(const double* __restrict__ q, const double* __restrict__ k,
             const double* __restrict__ v, double* __restrict__ o,
             double* __restrict__ lse, const int* __restrict__ q_offset,
             int sq, int skv, int d,
             double scale, int causal, int window, double softcap) {
  using TL = Tile<DP, CS, G, BKV>;
  constexpr int LDQ = TL::LDQ, LDV = TL::LDV, FS = TL::FS, FO = TL::FO;
  constexpr int GROUP = TL::GROUP;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int grp = tid / GROUP;     // the group's KV tiles: grp, grp + G, ..
  const int gtid = tid % GROUP;
  const int g = lane / 4;          // fragment row (A, C) / column (B)
  const int t = lane % 4;          // fragment column (A) / row (B)
  const int wr = ((warp % (GROUP / 32)) / CS) * RW;   // first row
  const int wc = (warp % CS) * (DP / CS);             // first column
  double* qs = reinterpret_cast<double*>(smem_raw);   // BQ x LDQ
  double* ks = qs + BQ * LDQ + grp * TL::KV;          // BKV x LDQ
  double* vs = ks + BKV * LDQ;                        // BKV x LDV

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int pos0 = (q_offset ? q_offset[bh] : 0) + q0;   // row q0's position
  const double* qb = q + bh * sq * d;
  const double* kb = k + bh * skv * d;
  const double* vb = v + bh * skv * d;
  double* ob = o + bh * sq * d;

  // KV tiles that hold a valid key for some row of the block
  const int2 keys = key_bounds(pos0, pos0 + min(BQ, sq - q0) - 1, skv,
                               causal, window);
  const int k_begin = (keys.x / BKV) * BKV + grp * BKV;
  const int k_end = keys.y;

  // the block's query rows (zero past Sq: never stored) and the first K
  dmma::stage_tile<BQ, DP, LDQ, TL::THREADS, VEC, 2>(qs, qb, q0, sq, d,
                                                     d, tid);
  if (k_begin < k_end)
    dmma::stage_tile<BKV, DP, LDQ, GROUP, VEC, 2>(ks, kb, k_begin, skv, d,
                                                  d, gtid);
  dmma::commit();
  dmma::wait<0>();
  __syncthreads();                 // Q is everyone's

  // this lane holds rows wr + g + 8 h (h = 0, 1): their running max and
  // sum, and acc[c][e + 2 h] = O[wr + g + 8 h][wc + 8 c + 2 t + e]
  double m[2] = {MASKED, MASKED}, l[2] = {0.0, 0.0}, acc[FO][4];
#pragma unroll
  for (int c = 0; c < FO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0;

  for (int kt = k_begin; kt < k_end; kt += G * BKV) {
    dmma::wait<0>();               // this thread's copies of K
    group_sync(1 + grp, GROUP);    // the group's; its last P V is done
    dmma::stage_tile<BKV, DP, LDV, GROUP, VEC, 2>(vs, vb, kt, skv, d, d,
                                                  gtid);
    dmma::commit();                // V's copy overlaps the scores

    // s[j][e + 2 h]: score of row wr + g + 8 h, key kt + 8 j + 2 t + e
    double s[FS][4];
#pragma unroll
    for (int j = 0; j < FS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0;
    const double* qa = qs + (wr + g) * LDQ + t;
    const double* kf = ks + g * LDQ + t;
    // unrolled 4 steps at a time: fully unrolled, the compiler runs far
    // ahead with Q and K loads and spills at D = 288
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += MK) {
      double af[MK / 2], bf[FS][MK / 4];
#pragma unroll
      for (int e = 0; e < MK / 2; ++e)     // Q[g + 8 (e % 2)][t + 4 (e / 2)]
        af[e] = qa[8 * (e % 2) * LDQ + dd + 4 * (e / 2)];
#pragma unroll
      for (int j = 0; j < FS; ++j)
#pragma unroll
        for (int u = 0; u < MK / 4; ++u)   // K[8 j + g][t + 4 u]
          bf[j][u] = kf[8 * j * LDQ + dd + 4 * u];
#pragma unroll
      for (int j = 0; j < FS; ++j) dmma::mma_m16n8k8(s[j], af, bf[j]);
    }

    // online softmax on the fragments; s becomes p
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = pos0 + wr + g + 8 * h;
      double tmax = MASKED;
#pragma unroll
      for (int j = 0; j < FS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kt + 8 * j + 2 * t + e;
          double x = s[j][e + 2 * h] * scale;
          if (softcap > 0.0) x = tanh(x / softcap) * softcap;
          bool ok = kp < skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          s[j][e + 2 * h] = ok ? x : MASKED;
          tmax = fmax(tmax, s[j][e + 2 * h]);
        }
      tmax = fmax(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmax(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const double m_new = fmax(m[h], tmax);
      double psum = 0.0;
#pragma unroll
      for (int j = 0; j < FS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kt + 8 * j + 2 * t + e;
          const double p = kp < skv ? exp(s[j][e + 2 * h] - m_new) : 0.0;
          s[j][e + 2 * h] = p;
          psum += p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const double corr = exp(m[h] - m_new);
      l[h] = l[h] * corr + psum;
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < FO; ++c) {
        acc[c][2 * h] *= corr;
        acc[c][2 * h + 1] *= corr;
      }
    }

    group_sync(1 + grp, GROUP);    // the group is done with K
    if (kt + G * BKV < k_end)      // the next K's copy overlaps P V
      dmma::stage_tile<BKV, DP, LDQ, GROUP, VEC, 2>(ks, kb, kt + G * BKV,
                                                    skv, d, d, gtid);
    dmma::commit();
    dmma::wait<1>();               // this thread's copies of V
    group_sync(1 + grp, GROUP);    // the group's

    // acc += P V. The k-th column of the A operand, k = t + 4 u, stands
    // for key 8 j + 2 t + u, which this lane holds as s[j][u + 2 h]: P
    // enters as it left Q K^T. V's rows are read in the same order; its
    // stride of 2 (mod 16) keeps rows 2 t + u free of bank conflicts.
    const double* vf = vs + 2 * t * LDV + wc + g;
#pragma unroll
    for (int j = 0; j < FS; ++j) {
      const double pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
      for (int c = 0; c < FO; ++c) {
        const double vb2[2] = {vf[8 * j * LDV + 8 * c],
                               vf[(8 * j + 1) * LDV + 8 * c]};
        dmma::mma_m16n8k8(acc[c], pa, vb2);
      }
    }
  }

  if constexpr (G > 1) {
    // combine the groups' (m, l, acc) through the K and V buffers of
    // group 0: the other groups write, group 0 merges and stores
    double* part = qs + BQ * LDQ;   // (G - 1) x BQ x (DP + 2)
    __syncthreads();               // every group's copies are read
    if (grp > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double* row = part + ((grp - 1) * BQ + wr + g + 8 * h) * (DP + 2);
        if (t == 0 && wc == 0) {
          row[DP] = m[h];
          row[DP + 1] = l[h];
        }
#pragma unroll
        for (int c = 0; c < FO; ++c) {
          row[wc + 8 * c + 2 * t] = acc[c][2 * h];
          row[wc + 8 * c + 2 * t + 1] = acc[c][2 * h + 1];
        }
      }
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int p = 0; p < G - 1; ++p) {
        const double* row = part + (p * BQ + wr + g + 8 * h) * (DP + 2);
        const double m_new = fmax(m[h], row[DP]);
        const double c0 = exp(m[h] - m_new);
        const double c1 = exp(row[DP] - m_new);
        l[h] = l[h] * c0 + row[DP + 1] * c1;
        m[h] = m_new;
#pragma unroll
        for (int c = 0; c < FO; ++c) {
          acc[c][2 * h] = acc[c][2 * h] * c0 + row[wc + 8 * c + 2 * t] * c1;
          acc[c][2 * h + 1] =
              acc[c][2 * h + 1] * c0 + row[wc + 8 * c + 2 * t + 1] * c1;
        }
      }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    if (r >= sq) continue;
    const double den = fmax(l[h], 1e-30);
    if (lse != nullptr && t == 0 && wc == 0)
      lse[bh * sq + r] = m[h] + log(den);
#pragma unroll
    for (int c = 0; c < FO; ++c) {
      const int col = wc + 8 * c + 2 * t;
      if (col < d) ob[(int64_t)r * d + col] = acc[c][2 * h] / den;
      if (col + 1 < d)
        ob[(int64_t)r * d + col + 1] = acc[c][2 * h + 1] / den;
    }
  }
}

template <int DP, int CS, int G, int BKV>
int launch_tile(const void* q, const void* k, const void* v, void* o,
                void* lse, const int* q_offset, int bh, int sq, int skv, int d,
                int causal, int window, double softcap, void* stream) {
  using TL = Tile<DP, CS, G, BKV>;
  // 16-byte copies where every row starts on 16 bytes
  const bool vec = d % 2 == 0
      && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
          | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  auto kern = vec ? flash_kernel<DP, CS, G, BKV, true>
                  : flash_kernel<DP, CS, G, BKV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)bh);
  kern<<<grid, TL::THREADS, TL::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(q), static_cast<const double*>(k),
      static_cast<const double*>(v), static_cast<double*>(o),
      static_cast<double*>(lse), q_offset, sq, skv, d, 1.0 / sqrt((double)d),
      causal, window, softcap);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const int* q_offset, int64_t bh, int64_t sq, int64_t skv,
           int64_t d, int causal, int window, double softcap, void* stream) {
  if (!sizes_ok(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  // the tile of D's class: a warp's accumulator (16 rows x DP / CS
  // columns) stays in registers and Q, K, V in shared memory
  using Launch = int (*)(const void*, const void*, const void*, void*, void*,
                         const int*, int, int, int, int, int, int, double,
                         void*);
  Launch fn = launch_tile<288, 2, 1, 16>;
  if (d <= 192) fn = launch_tile<192, 2, 1, 32>;
  if (d <= 128) fn = launch_tile<128, 1, 2, 32>;
  if (d <= 64) fn = launch_tile<64, 1, 2, 32>;
  if (d <= 32) fn = launch_tile<32, 1, 2, 32>;
  return fn(q, k, v, o, lse, q_offset, (int)bh, (int)sq, (int)skv, (int)d,
            causal, window, softcap, stream);
}

}  // namespace f64

}  // namespace

extern "C" {

int flash_attention_f64(const void* q, const void* k, const void* v, void* o,
                        void* lse, const void* q_offset, int64_t bh,
                        int64_t sq, int64_t skv, int64_t d, int causal,
                        int window, double softcap, void* stream) {
  return f64::launch(q, k, v, o, lse, static_cast<const int*>(q_offset), bh,
                     sq, skv, d, causal, window, softcap, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, const void* q_offset, int64_t bh,
                        int64_t sq, int64_t skv, int64_t d, int causal,
                        int window, double softcap, void* stream) {
  return launch<float, float>(q, k, v, o, lse,
                              static_cast<const int*>(q_offset), bh, sq, skv,
                              d, causal, window, softcap, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* q_offset, int64_t bh,
                         int64_t sq, int64_t skv, int64_t d, int causal,
                         int window, double softcap, void* stream) {
  return launch<__nv_bfloat16, float>(
      q, k, v, o, lse, static_cast<const int*>(q_offset), bh, sq, skv, d,
      causal, window, softcap, stream);
}

int flash_attention_abi() { return 2; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
