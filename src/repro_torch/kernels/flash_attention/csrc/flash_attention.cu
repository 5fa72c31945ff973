// Flash attention O = softmax(mask(softcap(Q K^T / sqrt(D)))) V for Hopper
// (sm_90a), on the single-KV-head layout q (BH, Sq, D), k/v (BH, Skv, D),
// and in bfloat16 also on the grouped-query layout q (B, Sq, H, D), k/v
// (B, Skv, KVH, D), read in place.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (body _flash_kernel): an online softmax whose running (max m, sum l,
// accumulator acc) was carried in VMEM scratch across the sequential KV
// grid axis. Here one block owns a tile of query rows of one bh and walks
// the KV tiles itself, so nothing carries between blocks (the split-KV
// decode below merges its blocks' partials in a second kernel).
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
// q_offset + Sq must stay below 2^31. On the grouped-query layout the
// offset is one per batch row, shared by its heads.
//
// Bound on an H100 SXM: 4 Sq Skv D operations on (2 Skv + 2 Sq) D values
// moved, so at the main path's chunk (Sq = Skv = 4096, D = 128, float64)
// some 500 operations per byte: bound by operations. In float64 the peak
// (67 TFLOP/s) is reached only on the tensor cores, through DMMA; in
// bfloat16 on the bf16 tensor cores (989 TFLOP/s), where a prefill or a
// training layer is bound by operations and a decode step (a few query
// rows over a long cache) by the bytes of K and V.
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
// float32 (flash_attention_f32): a plain FMA kernel. One block of 256
// threads owns BQ = 32 query rows and walks KV tiles of BK = 32 keys (K,
// then V, staged through one buffer), each thread owning 2 rows x
// ceil(D/16) columns of acc and a row's m and l replicated over the 16
// threads that share it. Its shared memory: Q tile BQ x (D+1), K/V tile
// BK x (D+1), P tile BQ x BK in float; the +1 row padding keeps a warp's
// reads of 16 different K rows in 16 different banks. float32 has no
// exact tensor-core mode.
//
// bfloat16 (flash_attention_bf16, and flash_attention_gqa_bf16 on the
// grouped-query layout; the bhsd entry is the latter's case H = KVH = 1
// with contiguous strides). Query head h reads KV head h / G, G = H / KVH,
// through the operands' strides (element strides of the batch, position
// and head dimensions, unit stride in D): a slice of a KV cache (B,
// max_seq, KVH, D) is read where it lies, and no K/V is repeated over the
// groups. O is written in q's layout (its own strides), the logsumexp as
// (B, H, Sq). Both kernels take every product on the tensor cores,
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (kernels/csrc/mma_bf16.cuh), with the same three steps (mma_scores,
// online_softmax, mma_pv_ld): S = Q K^T lands in float32 C fragments of
// 16 query rows; the online softmax runs on them in registers (a row's max
// reduces over the 4 lanes that hold it, its sum stays per lane until the
// end, where corr has scaled each lane's part alike; exponents are base
// 2, ex2.approx.ftz of (x - m) log2 e, the difference first, so that the
// masked -1e30 - (-1e30) stays an exact 0); P, packed to bf16, is the A
// operand of P V as it lies (mma_bf16::pack_a), never passing through
// shared memory. Q, K and V sit in shared memory as bf16, D zero-filled to
// its class DP (32, 64, 80, 128, 192 or 288; 80 is stablelm_3b's own), at
// a row stride of DP + 8 elements: an odd number of 16-byte chunks, so the
// 8 rows an ldmatrix block reads start in 8 different bank quads and
// ldmatrix / ldmatrix.trans read without conflicts at every class (an XOR
// swizzle of the chunks needs whole groups of 8 chunks a row: D = 80 and
// 288 have 10 and 36). Rows whose bytes or start are not whole 16-byte
// chunks (D = 1, 24 on a strided layout, ...) are copied element by
// element, the rest by 16-byte cp.async. The fragment wrappers are
// volatile asm, kept in source order, so each step's K and V fragments
// are loaded ahead of its products. Where 16 rows' accumulator no longer
// fits a warp's registers (D > 128: gemma2_2b's 288), two warps share the
// rows by halves of D (CS = 2; both compute the rows' scores), as the
// float64 kernel does. One host rule (use_decode) picks the kernel from R
// = Sq x G, the query rows that share one KV head, and Skv:
//
//   R <= DEC_ROWS (16): the split-KV decode. Its rows fit one 16-row
//     fragment, so a block reads each key once for all of them; the
//     tensor-core prefill kernel's blocks of 64 rows of one head would
//     leave at least 3/4 of their rows empty and read the keys once per
//     query head. Skv sets its split count (decode_split).
//   R > DEC_ROWS: the tensor-core kernel (prefill, training, short query
//     blocks).
//
// The tensor-core kernel (mma_fwd_kernel<DP, CS, BKV, MINB, CAP>): a
// block owns 64 query rows of one query head, 16 a warp (grid: batch x
// head, then the row tiles, the last first: under a causal mask they walk
// the most keys; neighbouring blocks are the heads of one KV head, which
// share K and V in L2). Up to D = 128 a warp keeps its Q fragments in
// registers for the walk; at CS = 2 it reads them from shared memory. K
// and V are double-buffered: the next tile's copies fly while this tile's
// products run. Tiles that hold no valid key for any row of the block are
// skipped (key_bounds); the element mask runs only on tiles that cross
// the causal diagonal, the window's edge or Skv for the warp's rows (a
// warp-uniform test). The softcap is a template argument. Tiles (one
// table for both kernels, by_class), chosen on an H100 with
// kernels/flash_attention/fwd_ab.py (PERF.md section 6): BKV keys a KV
// tile 64 at DP = 32 and 80, 32 at 64, 128 and above; the
// registers capped (MINB) so that 3 blocks share an SM up to DP = 128, 2
// above (the SM's shared memory allows them: the largest block takes 111
// KB at DP = 288); uncapped, D = 80 and 128 took 168-189 registers, 2
// blocks an SM, and ran 20-25 % slower. 16 rows a warp: 32 (two
// fragments) put the D = 128 kernel at 255 registers and 64 bytes of
// stack and ran 5-8 % slower; blocks of 128 rows (8 warps) were 15 %
// slower at D = 80 and 64 (7 % faster at 128).
//
// The split-KV decode (decode_kernel<DP, CS, STAGES>, then
// combine_kernel): the grid is (batch x KV head, key splits). A block
// takes the G query heads that share its KV head with all their Sq rows
// (row r = gi Sq + i: head kvh G + gi, query row i at q_offset + i) as one
// 16-row fragment, rows past G Sq zero, and reads its span of keys once
// for all of them, in tiles of DEC_BK = 32 keys. All 4 warps stage the
// tiles (STAGES buffers, STAGES - 1 tiles in flight: 4 up to D = 128, 2
// above, where a buffer of K and V takes 37 KB); the first CS warps take
// the products. A decode step reads K and V once, so the bytes bound it:
// the copies in flight, not the products, set its speed (an FMA version
// of the products, a lane per key, ran 3-5x slower than the bare copies).
// decode_split sizes the splits so that B x KVH x splits reaches
// DEC_BLOCKS_PER_SM blocks an SM: at 4 x 132 SMs, gemma2_2b's decode step
// (16 batch-KV heads, Skv = 8192) takes 32 splits of 256 keys, Jamba's
// (32 batch-KV heads) 16 of 512. A split that holds no key the batch
// row's block walks (key_bounds: past a slot's position, or before its
// window) exits at once. Each split writes a partial (m, l, acc[D]) per
// row in float32 to the workspace the caller allocates
// (flash_attention_gqa_workspace: B x H x Sq x splits x (D + 2) floats;
// 1.2 MB at gemma2_2b's decode step, 2.1 MB at Jamba's), and
// combine_kernel (a block per row) merges the walked splits in split
// order: M = max m_s, then the weights e^(m_s - M) into shared memory, l
// = sum l_s e^(m_s - M) and each column's sum over the splits in that
// fixed order, with no atomics, so a call gives the same bits every time
// (the served replays compare them). It writes O = acc / max(l, 1e-30)
// and lse = M + log(max(l, 1e-30)). With one split (a short cache, or the
// bhsd entry, which takes no workspace) the decode block writes O and lse
// itself.
//
// Rows with no valid key across splits: a split where a row has valid
// keys elsewhere but none of its own ends with m_s = -1e30, so its weight
// e^(-1e30 - M) is exactly 0 and it adds nothing. A row with no valid key
// anywhere makes its block walk every key (key_bounds gives [0, Skv)), so
// every split is walked, each with m_s = -1e30, l_s its key count and
// acc_s the sum of its V rows (P = 1 each); M = -1e30, every weight 1, and
// O is the mean of V over all Skv keys, as the FMA kernel gave it.
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
// flash_attention_gqa_bf16 takes q, k, v, o, lse or null, q_offset (int32
// (B,) or null), the workspace (or null: one split), B, Sq, Skv, H, KVH,
// D, a pointer to 12 element strides (batch, position and head of q, k,
// v and o), the options and the stream; flash_attention_gqa_workspace
// gives the floats of workspace a call needs (0: none).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dmma.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;        // 16 row groups x 16 column groups
constexpr int TM = 2;               // query rows per thread
constexpr int TN = 2;               // keys per thread in a score tile
constexpr int BQ = 16 * TM;         // query rows per block
constexpr int BK = 16 * TN;         // keys per KV tile
constexpr int MAX_D = 288;          // gemma2_2b: 2304 / 8 heads
constexpr double MASKED = -1e30;    // the reference's NEG_INF

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
template <int NC>
__global__ void __launch_bounds__(THREADS, 3)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse,
             const int* __restrict__ q_offset, int sq, int skv, int d,
             float scale, int causal, int window, float softcap) {
  using Acc = float;
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
  const float* qb = q + bh * sq * d;
  const float* kb = k + bh * skv * d;
  const float* vb = v + bh * skv * d;
  float* ob = o + bh * sq * d;

  // the block's query rows, zero past Sq (those rows are never stored)
  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    qs[r * ld + c] = (q0 + r < sq) ? qb[(int64_t)(q0 + r) * d + c] : Acc(0);
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
      kv[r * ld + c] = (kt + r < skv) ? kb[(int64_t)(kt + r) * d + c]
                                      : Acc(0);
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
        ps[(ty + 16 * i) * BK + tx + 16 * j] = p;
      }
      corr[i] = ex(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(psum);
      m[i] = m_new;
    }
    __syncthreads();            // scores done with K; P is in shared

    for (int e = tid; e < BK * d; e += THREADS) {
      const int r = e / d;
      const int c = e - r * d;
      kv[r * ld + c] = (kt + r < skv) ? vb[(int64_t)(kt + r) * d + c]
                                      : Acc(0);
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
      if (col < d) ob[(int64_t)r * d + col] = acc[i][c] / den;
    }
  }
}

template <int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o,
              void* lse, const int* q_offset, int bh, int sq, int skv, int d,
              int causal, int window, double softcap, void* stream) {
  const size_t smem = (size_t)(BQ * (d + 1) + BK * (d + 1) + BQ * BK)
                      * sizeof(float);
  auto kern = flash_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)bh);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), q_offset, sq, skv, d,
      (float)(1.0 / sqrt((double)d)), causal, window, (float)softcap);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, const int* q_offset, int64_t bh, int64_t sq,
               int64_t skv, int64_t d, int causal, int window,
               double softcap, void* stream) {
  if (!sizes_ok(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  // the register tile's width: the least instantiated ceil(D / 16)
  using Launch = int (*)(const void*, const void*, const void*, void*, void*,
                         const int*, int, int, int, int, int, int, double,
                         void*);
  Launch fn = launch_nc<18>;
  if (d <= 192) fn = launch_nc<12>;
  if (d <= 128) fn = launch_nc<8>;
  if (d <= 64) fn = launch_nc<4>;
  if (d <= 32) fn = launch_nc<2>;
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
// ---- bfloat16: the tensor-core kernel and the split-KV decode ----
namespace bf16 {

using B16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED_F = -1e30f;
constexpr int DEC_ROWS = 16;        // query rows (Sq x G) a decode block takes
constexpr int DEC_WARPS = 4;        // rows w, w + 4, .. of a decode block
constexpr int DEC_BK = 32;          // keys per decode tile: one a lane
constexpr int DEC_BLOCKS_PER_SM = 4;   // decode_split's target
constexpr int COMBINE_THREADS = 128;
constexpr int BQ = 64;              // query rows of a mma_fwd_kernel block

// the tiles of each D class, for both kernels (the note at the top says
// why): DP the class's padded width; CS the warps that share 16 query
// rows (by parts of D); BKV keys a tensor-core KV tile; MINB blocks an SM
// the tensor-core kernel's registers must allow; STAGES the decode's K/V
// buffers (STAGES - 1 tiles in flight)
template <int DP_, int CS_, int BKV_, int MINB_, int STAGES_>
struct Tiles {
  static constexpr int DP = DP_, CS = CS_, BKV = BKV_, MINB = MINB_,
                       STAGES = STAGES_;
};

// f(Tiles of D's class): the one dispatch on D of both kernels
template <typename F>
int by_class(int64_t d, F f) {
  //                          DP  CS BKV MINB STAGES
  if (d <= 32) return f(Tiles<32, 1, 64, 3, 4>{});
  if (d <= 64) return f(Tiles<64, 1, 32, 3, 4>{});
  if (d <= 80) return f(Tiles<80, 1, 64, 3, 4>{});
  if (d <= 128) return f(Tiles<128, 1, 32, 3, 4>{});
  if (d <= 192) return f(Tiles<192, 2, 32, 2, 2>{});
  return f(Tiles<288, 2, 32, 2, 2>{});
}

// element strides of the grouped-query layout (unit stride in D): q and o
// (B, Sq, H, D), k and v (B, Skv, KVH, D); heads H and group G = H / KVH
struct Layout {
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
  int heads, group;
};

// 2^x on the SFU, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int causal,
                                          int window) {
  bool ok = true;
  if (causal) ok = kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// rows [r0, r0 + rows) of a matrix with row stride rs (elements) into a
// rows x ld shared tile, columns [0, cols) (cols a multiple of 8): zero
// past row n and column d. With vec (d, rs and the matrix's start in whole
// 16-byte chunks), 16-byte cp.async copies that the caller commits and
// waits for; else element by element.
__device__ __forceinline__ void stage(B16* dst, const B16* src, int64_t rs,
                                      int r0, int rows, int n, int d,
                                      int cols, int ld, bool vec, int tid,
                                      int nthreads) {
  if (vec) {
    const int ch = cols / 8;          // 16-byte chunks a row
#pragma unroll 1
    for (int e = tid; e < rows * ch; e += nthreads) {
      const int r = e / ch;
      const int c = 8 * (e - r * ch);
      const bool ok = r0 + r < n && c < d;
      const B16* from = ok ? src + (int64_t)(r0 + r) * rs + c : src;
      dmma::copy16(dst + r * ld + c, from, ok);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      dst[r * ld + c] = (r0 + r < n && c < d)
          ? src[(int64_t)(r0 + r) * rs + c] : __float2bfloat16(0.0f);
    }
  }
}

// s = the raw scores of 16 query rows against NT 8-key tiles of a shared
// K tile: Q's fragments from qf (HOLD) or from shared memory at qa (the
// lane's ldmatrix address in Q), K's at kb (the lane's in K). Each step's
// K fragments are loaded ahead of their products (the fragment wrappers
// are volatile asm, kept in source order: a load right before its product
// stalls it)
template <int DP, int NT, bool HOLD>
__device__ __forceinline__ void mma_scores(
    float (&s)[NT][4], const uint32_t (&qf)[HOLD ? DP / 16 : 1][4],
    const __nv_bfloat16* qa, const __nv_bfloat16* kb) {
  constexpr int LD = DP + 8;
  // unrolled a few steps at a time where Q comes from shared memory:
  // fully unrolled, the compiler runs ahead with Q and K loads (the
  // float64 kernel spilled so at 288)
  constexpr int UNROLL = HOLD ? DP / 16 : 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll UNROLL
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    if constexpr (HOLD) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    } else {
      mma_bf16::ldmatrix_x4(a, qa + 16 * kk);
    }
    uint32_t bb[NT / 2][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp)
      mma_bf16::ldmatrix_x4(bb[jp], kb + 16 * jp * LD + 16 * kk);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      mma_bf16::mma(s[2 * jp], a, bb[jp][0], bb[jp][1]);
      mma_bf16::mma(s[2 * jp + 1], a, bb[jp][2], bb[jp][3]);
    }
  }
}

// the online softmax of a lane's two rows (at positions qp0 and qp1) on
// their scores' fragments: scaled, capped (CAP), masked where edge (keys
// k0 + 8 j + e of the lane, existing below n_keys), then m, l and acc
// rescaled; s becomes P. Exponents are base 2, the difference taken
// first so that a masked -1e30 - (-1e30) stays an exact 0
template <int NT, int DT, bool CAP>
__device__ __forceinline__ void online_softmax(
    float (&s)[NT][4], float (&m)[2], float (&l)[2], float (&acc)[DT][4],
    bool edge, int k0, int n_keys, int qp0, int qp1, int causal, int window,
    float scale, float softcap, float inv_cap) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = hh ? qp1 : qp0;
    float tmax = MASKED_F;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][e + 2 * hh] * scale;
        if constexpr (CAP) x = tanhf(x * inv_cap) * softcap;
        if (edge) {
          const int kp = k0 + 8 * j + e;
          x = kp < n_keys && key_valid(kp, qp, causal, window) ? x
                                                               : MASKED_F;
        }
        s[j][e + 2 * hh] = x;
        tmax = fmaxf(tmax, x);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m[hh], tmax);
    const float corr = ex2((m[hh] - m_new) * LOG2E);
    m[hh] = m_new;
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + e;
        const float p = !edge || kp < n_keys
            ? ex2((s[j][e + 2 * hh] - m_new) * LOG2E) : 0.0f;
        s[j][e + 2 * hh] = p;
        psum += p;
      }
    l[hh] = l[hh] * corr + psum;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      acc[c][2 * hh] *= corr;
      acc[c][2 * hh + 1] *= corr;
    }
  }
}

// acc += P V over BKV keys, 16 at a time: P's C fragments, packed to bf16,
// are the A fragment of its 16 keys; V's fragments (ldmatrix.trans from
// va, the lane's address in the V tile at the warp's first column) VB at
// a time ahead of their products
template <int DT, int BKV, int VB, int LD>
__device__ __forceinline__ void mma_pv_ld(float (&acc)[DT][4],
                                          const float (&p)[BKV / 8][4],
                                          const __nv_bfloat16* va) {
#pragma unroll
  for (int kq = 0; kq < BKV / 16; ++kq) {
    uint32_t pa[4];
    mma_bf16::pack_a(pa, p[2 * kq], p[2 * kq + 1]);
#pragma unroll
    for (int c0 = 0; c0 < DT / 2; c0 += VB) {
      uint32_t bb[VB][4];
#pragma unroll
      for (int c = 0; c < VB; ++c)
        mma_bf16::ldmatrix_x4_trans(bb[c], va + 16 * kq * LD + 16 * (c0 + c));
#pragma unroll
      for (int c = 0; c < VB; ++c) {
        mma_bf16::mma(acc[2 * (c0 + c)], pa, bb[c][0], bb[c][1]);
        mma_bf16::mma(acc[2 * (c0 + c) + 1], pa, bb[c][2], bb[c][3]);
      }
    }
  }
}

// the tensor-core kernel: BQ query rows of query head blockIdx.x % H of
// batch row blockIdx.x / H, 16 a warp. DP: D's class; CS: warps that
// share 16 rows (by parts of D); BKV: keys per KV tile; MINB: blocks an
// SM the registers must allow; CAP: with the softcap
template <int DP, int CS, int BKV, int MINB, bool CAP>
__global__ void __launch_bounds__(2 * BQ * CS, MINB)
mma_fwd_kernel(const B16* __restrict__ q, const B16* __restrict__ k,
               const B16* __restrict__ v, B16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ q_offset,
               Layout lay, int sq, int skv, int d, float scale, int causal,
               int window, float softcap, int vec) {
  constexpr int THREADS = 2 * BQ * CS;   // BQ / 16 row warps, CS each
  constexpr int LD = DP + 8;           // an odd number of 16-byte chunks
  constexpr int NT = BKV / 8;          // 8-key tiles of a warp's scores
  constexpr int DC = DP / CS;          // the warp's output columns
  constexpr int DT = DC / 8;           // their 8-column tiles
  constexpr bool HOLD = CS == 1;       // Q's fragments in registers
  // V fragments loaded ahead of their products: the fragment wrappers are
  // volatile asm, kept in source order, so a load right before its
  // product stalls it; with two warps to a row tile, one at a time keeps
  // the registers within 128
  constexpr int VB = CS == 1 ? DT / 2 : 1;
  static_assert(DP % 16 == 0 && DC % 16 == 0 && BKV % 16 == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  B16* qs = reinterpret_cast<B16*>(smem_raw);   // BQ x LD
  B16* ks = qs + BQ * LD;                        // 2 x BKV x LD
  B16* vs = ks + 2 * BKV * LD;                   // 2 x BKV x LD

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr = 16 * (warp / CS);                 // the warp's first row
  const int wc = (warp % CS) * DC;                 // and first column
  const int64_t bh = blockIdx.x;
  const int b = (int)(bh / lay.heads);
  const int h = (int)(bh % lay.heads);
  const int kvh = h / lay.group;
  // the last rows first: under a causal mask they walk the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int pos0 = (q_offset ? q_offset[b] : 0) + q0;   // row q0's position
  const int pw = pos0 + wr;                             // the warp's first
  const B16* qb = q + b * lay.qb + h * lay.qh;
  const B16* kb = k + b * lay.kb + kvh * lay.kh;
  const B16* vb = v + b * lay.vb + kvh * lay.vh;

  // KV tiles that hold a valid key for some row of the block
  const int2 keys = key_bounds(pos0, pos0 + min(BQ, sq - q0) - 1, skv,
                               causal, window);
  const int k_begin = (keys.x / BKV) * BKV;
  const int k_end = keys.y;

  auto load_kv = [&](int kt, int buf) {
    stage(ks + buf * BKV * LD, kb, lay.ks, kt, BKV, skv, d, DP, LD, vec,
          tid, THREADS);
    stage(vs + buf * BKV * LD, vb, lay.vs, kt, BKV, skv, d, DP, LD, vec,
          tid, THREADS);
  };
  stage(qs, qb, lay.qs, q0, BQ, sq, d, DP, LD, vec, tid, THREADS);
  if (k_begin < k_end) load_kv(k_begin, 0);
  dmma::commit();

  // this lane holds rows wr + g + 8 hh (hh = 0, 1): their running max,
  // its share of their sum, and acc[c][e + 2 hh] = O[..][wc + 8 c + 2 t + e]
  float m[2] = {MASKED_F, MASKED_F}, l[2] = {0.0f, 0.0f}, acc[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  dmma::wait<0>();
  __syncthreads();
  const B16* qw = qs + wr * LD;
  const int ao = mma_bf16::a_row(lane) * LD + mma_bf16::a_col(lane);
  const int bo = mma_bf16::b_row(lane) * LD + mma_bf16::b_col(lane);
  uint32_t qf[HOLD ? DP / 16 : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_bf16::ldmatrix_x4(qf[kk], qw + ao + 16 * kk);
  }
  const float inv_cap = CAP ? 1.0f / softcap : 0.0f;

  int buf = 0;
#pragma unroll 1
  for (int kt = k_begin; kt < k_end; kt += BKV, buf ^= 1) {
    dmma::wait<0>();            // this thread's copies of the tile
    __syncthreads();            // everyone's; the last tile is done
    if (kt + BKV < k_end) load_kv(kt + BKV, buf ^ 1);
    dmma::commit();             // the next tile's copies overlap this one
    const B16* kc = ks + buf * BKV * LD;
    const B16* vc = vs + buf * BKV * LD;

    // s[j][e + 2 hh]: raw score of row wr + g + 8 hh, key kt + 8 j + 2 t + e
    float s[NT][4];
    mma_scores<DP, NT, HOLD>(s, qf, qw + ao, kc + bo);
    const bool edge = kt + BKV > skv || (causal && kt + BKV - 1 > pw)
        || (window > 0 && kt <= pw + 15 - window);
    online_softmax<NT, DT, CAP>(s, m, l, acc, edge, kt + 2 * t, skv,
                                pw + g, pw + g + 8, causal, window, scale,
                                softcap, inv_cap);
    mma_pv_ld<DT, BKV, VB, LD>(acc, s, vc + ao + wc);
  }

  // each row's sum over the 4 lanes that hold it, then O and lse
  B16* ob = o + b * lay.ob + h * lay.oh;
  const bool pairs = ((lay.os | lay.oh | (int64_t)d) & 1) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = q0 + wr + g + 8 * hh;
    if (r >= sq) continue;
    const float den = fmaxf(lr, 1e-30f);
    if (lse != nullptr && t == 0 && wc == 0)
      lse[bh * sq + r] = m[hh] + logf(den);
    B16* orow = ob + (int64_t)r * lay.os;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int col = wc + 8 * c + 2 * t;
      const float v0 = acc[c][2 * hh] / den;
      const float v1 = acc[c][2 * hh + 1] / den;
      if (pairs && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(v0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// the split-KV decode: the G x Sq (at most 16) query rows that share KV
// head blockIdx.x % KVH of batch row blockIdx.x / KVH, as one 16-row
// fragment, against the keys of split blockIdx.y. All DEC_WARPS warps
// stage the K/V tiles (STAGES buffers, STAGES - 1 tiles in flight); the
// first CS take the products on the tensor cores, as mma_fwd_kernel's
// warps do (two at D > 128, by halves of D). With splits > 1 each row's
// (m, l, acc) goes to its record in part (m, l, then D accumulator
// values); with one split the block writes O and lse
template <int DP, int CS, int STAGES>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_kernel(const B16* __restrict__ q, const B16* __restrict__ k,
              const B16* __restrict__ v, B16* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ q_offset,
              float* __restrict__ part, Layout lay, int sq, int skv, int d,
              int split_len, int splits, float scale, int causal,
              int window, float softcap, int vec) {
  constexpr int THREADS = DEC_WARPS * 32;
  constexpr int LD = DP + 8;           // an odd number of 16-byte chunks
  constexpr int NT = DEC_BK / 8;       // 8-key tiles of the scores
  constexpr int DC = DP / CS;          // a computing warp's columns
  constexpr int DT = DC / 8;
  static_assert(CS <= DEC_WARPS && DC % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  B16* qs = reinterpret_cast<B16*>(smem_raw);   // 16 x LD
  B16* ks = qs + 16 * LD;                        // STAGES x BK x LD
  B16* vs = ks + STAGES * DEC_BK * LD;           // STAGES x BK x LD

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rows = lay.group * sq;
  const int kvheads = lay.heads / lay.group;
  const int b = blockIdx.x / kvheads;
  const int kvh = blockIdx.x % kvheads;
  const int split = blockIdx.y;
  const int off = q_offset ? q_offset[b] : 0;
  // the split's share of the keys the batch row's rows walk
  const int2 keys = key_bounds(off, off + sq - 1, skv, causal, window);
  const int lo = max(keys.x, split * split_len);
  const int hi = min(keys.y, split * split_len + split_len);
  if (lo >= hi) return;               // the combine skips this split
  const int tiles = (hi - lo + DEC_BK - 1) / DEC_BK;
  const bool every_row = !(causal && off < 0)
      && !(window > 0 && off + sq - window > skv - 1);   // as key_bounds
  const B16* kb = k + b * lay.kb + kvh * lay.kh;
  const B16* vb = v + b * lay.vb + kvh * lay.vh;

  auto load_kv = [&](int tile) {
    const int buf = tile % STAGES;
    const int kt = lo + tile * DEC_BK;
    stage(ks + buf * DEC_BK * LD, kb, lay.ks, kt, DEC_BK, hi, d, DP, LD, vec,
          tid, THREADS);
    stage(vs + buf * DEC_BK * LD, vb, lay.vs, kt, DEC_BK, hi, d, DP, LD, vec,
          tid, THREADS);
  };
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) {
    if (n < tiles) load_kv(n);
    dmma::commit();
  }
  // row r = gi Sq + i: query head kvh G + gi at query row i; rows past
  // G Sq are zero (never stored)
  for (int e = tid; e < 16 * DP; e += THREADS) {
    const int r = e / DP;
    const int c = e - r * DP;
    const int gi = r / sq;
    const int i = r - gi * sq;
    qs[r * LD + c] = r < rows && c < d
        ? q[b * lay.qb + i * lay.qs + (kvh * lay.group + gi) * lay.qh + c]
        : __float2bfloat16(0.0f);
  }
  __syncthreads();

  const bool computes = warp < CS;
  const int wc = warp * DC;            // a computing warp's first column
  const int ao = mma_bf16::a_row(lane) * LD + mma_bf16::a_col(lane);
  const int bo = mma_bf16::b_row(lane) * LD + mma_bf16::b_col(lane);
  uint32_t qf[DP / 16][4];
  if (computes) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_bf16::ldmatrix_x4(qf[kk], qs + ao + 16 * kk);
  }
  // this lane's rows g and g + 8 sit at off + (row % Sq)
  const int qp0 = off + g % sq;
  const int qp1 = off + (g + 8) % sq;
  float m[2] = {MASKED_F, MASKED_F}, l[2] = {0.0f, 0.0f}, acc[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    dmma::wait<STAGES - 2>();   // this thread's copies of the tile
    __syncthreads();            // everyone's; the last tile is done
    if (n + STAGES - 1 < tiles) load_kv(n + STAGES - 1);
    dmma::commit();
    if (!computes) continue;
    const int kt = lo + n * DEC_BK;
    const B16* kc = ks + (n % STAGES) * DEC_BK * LD;
    const B16* vc = vs + (n % STAGES) * DEC_BK * LD;
    float s[NT][4];
    mma_scores<DP, NT, true>(s, qf, qs + ao, kc + bo);
    // where every row has a valid key, every key of [lo, hi) is valid for
    // a single query row; with more rows (positions off .. off + Sq - 1)
    // the edges are masked, and everywhere where a row has none
    const bool edge = kt + DEC_BK > hi || !every_row || (sq > 1 && (
        (causal && kt + DEC_BK - 1 > off)
        || (window > 0 && kt <= off + sq - 1 - window)));
    if (softcap > 0.0f)
      online_softmax<NT, DT, true>(s, m, l, acc, edge, kt + 2 * t, hi, qp0,
                                   qp1, causal, window, scale, softcap,
                                   inv_cap);
    else
      online_softmax<NT, DT, false>(s, m, l, acc, edge, kt + 2 * t, hi, qp0,
                                    qp1, causal, window, scale, softcap,
                                    inv_cap);
    mma_pv_ld<DT, DEC_BK, DT / 2, LD>(acc, s, vc + ao + wc);
  }
  if (!computes) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = g + 8 * hh;
    if (r >= rows) continue;
    const int gi = r / sq;
    const int qi = r - gi * sq;
    const int hq = kvh * lay.group + gi;
    const int64_t row = ((int64_t)b * lay.heads + hq) * sq + qi;  // (B, H, Sq)
    if (splits == 1) {
      const float den = fmaxf(lr, 1e-30f);
      if (lse != nullptr && t == 0 && wc == 0) lse[row] = m[hh] + logf(den);
      B16* orow = o + b * lay.ob + qi * lay.os + hq * lay.oh;
#pragma unroll
      for (int c = 0; c < DT; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wc + 8 * c + 2 * t + e;
          if (col < d) orow[col] = __float2bfloat16(acc[c][2 * hh + e] / den);
        }
    } else {
      float* rec = part + (row * splits + split) * (d + 2);
      if (t == 0 && wc == 0) {
        rec[0] = m[hh];
        rec[1] = lr;
      }
#pragma unroll
      for (int c = 0; c < DT; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wc + 8 * c + 2 * t + e;
          if (col < d) rec[2 + col] = acc[c][2 * hh + e];
        }
    }
  }
}

// the decode's second step: a block per query row (b, h, i) merges the
// records of the splits its block walked, in split order: the weights
// e^(m_s - M) into shared memory, then l and each column's sum over the
// splits in that order
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, B16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ q_offset,
               Layout lay, int sq, int skv, int d, int split_len,
               int splits, int causal, int window) {
  extern __shared__ float wts[];                     // the walked splits'
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int qi = (int)(row % sq);
  const int64_t bhq = row / sq;
  const int hq = (int)(bhq % lay.heads);
  const int b = (int)(bhq / lay.heads);
  const int off = q_offset ? q_offset[b] : 0;
  const int2 keys = key_bounds(off, off + sq - 1, skv, causal, window);
  const int s0 = keys.x / split_len;
  const int ns = (keys.y - 1) / split_len + 1 - s0;  // the walked splits
  const float* rec = part + (row * splits + s0) * (d + 2);
  for (int s = tid; s < ns; s += COMBINE_THREADS) wts[s] = rec[s * (d + 2)];
  __syncthreads();
  float mm = MASKED_F;
  for (int s = 0; s < ns; ++s) mm = fmaxf(mm, wts[s]);
  __syncthreads();
  for (int s = tid; s < ns; s += COMBINE_THREADS)
    wts[s] = expf(wts[s] - mm);
  __syncthreads();
  float l = 0.0f;
  for (int s = 0; s < ns; ++s) l += rec[s * (d + 2) + 1] * wts[s];
  const float den = fmaxf(l, 1e-30f);
  if (lse != nullptr && tid == 0) lse[row] = mm + logf(den);
  B16* orow = o + b * lay.ob + qi * lay.os + hq * lay.oh;
  for (int c = tid; c < d; c += COMBINE_THREADS) {
    float a = 0.0f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) a += rec[s * (d + 2) + 2 + c] * wts[s];
    orow[c] = __float2bfloat16(a / den);
  }
}

// the kernel rule: the decode where the rows that share a KV head are few
// (the note at the top says why), the tensor cores otherwise
bool use_decode(int64_t sq, int64_t group) { return sq * group <= DEC_ROWS; }

// the current device's SM count, asked of the driver once a device
int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return 132;
  n = counts[dev].load(std::memory_order_relaxed);
  if (n > 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess || n < 1)
    return 132;
  counts[dev].store(n, std::memory_order_relaxed);
  return n;
}

// the decode's split length (a multiple of DEC_BK) and count: enough
// splits that the batch-KV heads fill DEC_BLOCKS_PER_SM blocks an SM
void decode_split(int64_t bkv, int64_t skv, int* split_len, int* splits) {
  const int64_t target = (int64_t)DEC_BLOCKS_PER_SM * sm_count();
  const int64_t want = (target + bkv - 1) / bkv;
  int64_t len = (skv + want - 1) / want;
  len = ((len + DEC_BK - 1) / DEC_BK) * DEC_BK;
  *split_len = (int)len;
  *splits = (int)((skv + len - 1) / len);
}

// the most shared memory an SM has, so that as many blocks fit as their
// shared memory allows (by default the driver may split the SM's memory
// towards L1 and fit fewer)
template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, const int* q_offset, const Layout& lay, int batch,
               int sq, int skv, int d, int causal, int window, double softcap,
               int vec, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * T::BKV) * (T::DP + 8) * sizeof(B16);
  auto kern = softcap > 0.0
      ? mma_fwd_kernel<T::DP, T::CS, T::BKV, T::MINB, true>
      : mma_fwd_kernel<T::DP, T::CS, T::BKV, T::MINB, false>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((int64_t)batch * lay.heads),
                  (unsigned)((sq + BQ - 1) / BQ));
  kern<<<grid, 2 * BQ * T::CS, smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<B16*>(o),
      static_cast<float*>(lse), q_offset, lay, sq, skv, d,
      (float)(1.0 / sqrt((double)d)), causal, window, (float)softcap, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  void* lse, const int* q_offset, float* part,
                  const Layout& lay, int batch, int sq, int skv, int d,
                  int causal, int window, double softcap, int vec,
                  cudaStream_t stream) {
  const int kvheads = lay.heads / lay.group;
  int split_len = skv, splits = 1;
  if (part != nullptr)
    decode_split((int64_t)batch * kvheads, skv, &split_len, &splits);
  const size_t smem = (size_t)(16 + 2 * T::STAGES * DEC_BK) * (T::DP + 8)
                      * sizeof(B16);
  auto kern = decode_kernel<T::DP, T::CS, T::STAGES>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)((int64_t)batch * kvheads), (unsigned)splits),
         DEC_WARPS * 32, smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<B16*>(o),
      static_cast<float*>(lse), q_offset, part, lay, sq, skv, d, split_len,
      splits, (float)(1.0 / sqrt((double)d)), causal, window, (float)softcap,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_kernel<<<(unsigned)((int64_t)batch * lay.heads * sq),
                   COMBINE_THREADS, splits * sizeof(float), stream>>>(
      part, static_cast<B16*>(o), static_cast<float*>(lse), q_offset, lay,
      sq, skv, d, split_len, splits, causal, window);
  return (int)cudaGetLastError();
}

bool sizes_ok(int64_t batch, int64_t sq, int64_t skv, int64_t heads,
              int64_t kvheads, int64_t d) {
  return d >= 1 && d <= MAX_D && batch >= 1 && kvheads >= 1
         && heads >= kvheads && heads % kvheads == 0
         && batch * heads * sq <= ((int64_t)1 << 31) - 1 && sq >= 1
         && sq <= (int64_t)65535 * BQ && skv >= 1 && skv <= (int64_t)1 << 30;
}

// floats of workspace a call needs: the decode's partials, where it runs
// with more than one split
int64_t workspace(int64_t batch, int64_t sq, int64_t skv, int64_t heads,
                  int64_t kvheads, int64_t d) {
  if (!sizes_ok(batch, sq, skv, heads, kvheads, d)
      || !use_decode(sq, heads / kvheads))
    return 0;
  int split_len = 0, splits = 1;
  decode_split(batch * kvheads, skv, &split_len, &splits);
  return splits > 1 ? batch * heads * sq * splits * (d + 2) : 0;
}

// st: element strides (batch, position, head) of q, k, v and o
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const int* q_offset, void* workspace, int64_t batch, int64_t sq,
           int64_t skv, int64_t heads, int64_t kvheads, int64_t d,
           const int64_t* st, int causal, int window, double softcap,
           void* stream_ptr) {
  if (!sizes_ok(batch, sq, skv, heads, kvheads, d))
    return (int)cudaErrorInvalidValue;
  const Layout lay{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                   st[8], st[9], st[10], st[11], (int)heads,
                   (int)(heads / kvheads)};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // 16-byte copies where every row of q, k and v starts on 16 bytes
  int64_t rows_or = d;
  for (int i = 0; i < 9; ++i) rows_or |= st[i];
  const int vec = rows_or % 8 == 0
      && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
          | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int b = (int)batch, s = (int)sq, n = (int)skv, dd = (int)d;
  if (use_decode(sq, lay.group))
    return by_class(d, [&](auto tiles) {
      return launch_decode<decltype(tiles)>(
          q, k, v, o, lse, q_offset, static_cast<float*>(workspace), lay, b,
          s, n, dd, causal, window, softcap, vec, stream);
    });
  return by_class(d, [&](auto tiles) {
    return launch_mma<decltype(tiles)>(q, k, v, o, lse, q_offset, lay, b, s,
                                       n, dd, causal, window, softcap, vec,
                                       stream);
  });
}

}  // namespace bf16

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
  return launch_f32(q, k, v, o, lse, static_cast<const int*>(q_offset), bh,
                    sq, skv, d, causal, window, softcap, stream);
}

// the bhsd layout: the grouped-query entry at B = BH, H = KVH = 1, with
// contiguous strides and no workspace (a decode then runs one split)
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* q_offset, int64_t bh,
                         int64_t sq, int64_t skv, int64_t d, int causal,
                         int window, double softcap, void* stream) {
  if (!sizes_ok(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {sq * d, d, d, skv * d, d, d,
                          skv * d, d, d, sq * d, d, d};
  return bf16::launch(q, k, v, o, lse, static_cast<const int*>(q_offset),
                      nullptr, bh, sq, skv, 1, 1, d, st, causal, window,
                      softcap, stream);
}

int flash_attention_gqa_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_offset,
                             void* workspace, int64_t batch, int64_t sq,
                             int64_t skv, int64_t heads, int64_t kvheads,
                             int64_t d, const int64_t* strides, int causal,
                             int window, double softcap, void* stream) {
  return bf16::launch(q, k, v, o, lse, static_cast<const int*>(q_offset),
                      workspace, batch, sq, skv, heads, kvheads, d, strides,
                      causal, window, softcap, stream);
}

int64_t flash_attention_gqa_workspace(int64_t batch, int64_t sq, int64_t skv,
                                      int64_t heads, int64_t kvheads,
                                      int64_t d) {
  return bf16::workspace(batch, sq, skv, heads, kvheads, d);
}

int flash_attention_abi() { return 2; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
