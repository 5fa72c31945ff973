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
// the preamble (a warp per query row); a dK/dV kernel, one block per
// (batch-head, tile of keys) that walks the query tiles its keys can be
// seen from and keeps its dK and dV rows in registers; a dQ kernel, one
// block per (batch-head, tile of query rows) that walks the key tiles its
// rows see (the forward's bounds) and keeps its dQ rows in registers. Both
// recompute S and dO Vᵀ. No block writes what another block writes and
// nothing is atomic, so a rerun gives the same bits (the training's resume
// compares loss bits across a restart).
//
// Bound on an H100 SXM: 5 products of 2·D operations for each valid
// (query, key) pair (S, dO Vᵀ, dV, dK, dQ) against (4 Sq + 4 Skv) D
// values moved: bound by operations at a training layer's shapes (S =
// 4096: ~1000 operations a byte), on the bf16 tensor cores 989 TFLOP/s.
// The design computes 7 products a pair, 8 on the tensor cores: dq's
// kernel recomputes S and dO Vᵀ, since a dQ summed across the dK/dV
// blocks needs atomics (other bits each run) or a workspace of one dQ
// per key tile (gigabytes at a training layer's shape); and dK takes dS
// in two bf16 parts (below).
//
// bf16, every D (up to 288): the tensor cores (mma_dkdv_kernel,
// mma_dq_kernel). Every product is mma.sync m16n8k16 (bf16 in, float32
// accumulation; the helpers are kernels/csrc/mma_bf16.cuh). Up to D =
// 128 (past it, below):
//   - dK/dV: a block of 8 warps owns 128 keys, a warp 16 of them, and
//     walks BR query rows a step. Sᵀ = K Qᵀ and dPᵀ = V dOᵀ land in
//     float32 fragments; P and dS are computed there (grad_pair's math,
//     the exponent in base 2: grad_pair2); their fragments, rounded to
//     bf16, are the A operands of dV += Pᵀ dO and dK += dSᵀ Q without
//     passing through shared memory (an accumulator's layout is the A
//     fragment's).
//   - dQ: a block of 4 warps owns 64 query rows, a warp 16, and walks 64
//     keys a step: S = Q Kᵀ, dP = dO Vᵀ, dS in registers, dQ += dS
//     K. Blocks run from the last rows, which walk the most keys under a
//     causal mask.
//   - P and dS go into their second products rounded to bf16, as SDPA's
//     backward does, but dK takes dS as its rounding plus the rounding's
//     rest (two products, dS to ~16 bits): a query row drawn far larger
//     than the rest (a pushed row) multiplies dS's rounding into dK beyond
//     the 2e-2 element tolerance the kernel is held to, which an
//     emulation of the single rounding crossed (2.6 times it at
//     stablelm's shape), the two parts do not (0.37). The second part
//     costs ~7 % of the time.
//   - The walked tile (Q and dO; K and V) is double-buffered: the next
//     step's 16-byte cp.async copies fly while the step computes. The
//     own tile stays in shared memory for the whole walk.
//   - Shared tiles hold bf16 rows padded with zeros to DP, D rounded up to
//     a multiple of 16 of at least 32 (one instantiation each), at a
//     stride of DP + 8: an odd number of 16-byte chunks, so the 8 rows an
//     ldmatrix block reads start in 8 different bank quads and ldmatrix /
//     ldmatrix.trans read without conflicts at every DP. (An XOR swizzle
//     of the chunks needs 8 chunks a row: D = 80 has 10.) Rows of D % 8 !=
//     0, or operands not 16-byte aligned, are copied element by element.
//   - The element mask runs only on steps that cross the causal diagonal,
//     the window's edge or the ragged end (a warp-uniform test); the
//     tile bounds are the FMA kernels'. The softcap is a template
//     argument: tested in the element loop it cost ~7 %.
//   - Tiles and registers, chosen on an H100 with kernels/flash_attention/
//     bwd_ab.py at stablelm's (D = 80) and seamless's (D = 64) training
//     shapes (PERF.md section 6), times of the whole backward:
//     * BR = 64 up to DP = 80, 32 above (at DP = 128 the dK and dV
//       accumulators alone take 128 registers a thread): 64 rows against
//       32 took the D = 80 case from 4.12 to 3.87 ms.
//     * A warp keeps its 16 rows' A fragments of the own tile (K and V; Q
//       and dO) in registers instead of reading them at every step where
//       that neither spills nor costs a block an SM: dK/dV up to DP = 80
//       (64 with the softcap; 3.92 -> 3.65 ms at D = 80), dQ up to DP =
//       32.
//     * dQ is bounded to 3 blocks an SM up to DP = 80 (168 registers; 2
//       above): at 174 registers (DP = 64 with its fragments held) it ran
//       2 blocks an SM and took 1.47 ms of seamless's case, against 1.05
//       at 3 blocks, which spilled 4 bytes; without the held fragments
//       1.26.
//     * dK/dV blocks of 8 warps rather than 4 (one block an SM either way,
//       at 246-254 registers): the Q and dO tiles feed twice the keys a
//       copy; 3.20 -> 3.10 ms at D = 80, 2.69 -> 2.59 at D = 64.
//     * ex2.approx.ftz for P (ex2_ftz) rather than exp2f: 3.61 -> 3.11
//       ms at D = 80.
//
// bf16 past D = 128 (SPLIT_D; gemma2_2b's 288): the bound at its layer
// (8 batch-heads, causal, window 4096, softcap 50) is 0.196 ms at S =
// 4096, as phase 11 trains it (6.71e7 valid pairs), and 0.586 ms at S =
// 8192 (2.01e8), by operations. One warp cannot own 16 rows there: 16
// keys x 288 columns of dK and dV in float32 are 288 registers a thread,
// over the 255 a thread may have. So a pair of warps owns each 16 rows
// (keys in dK/dV, query rows in dQ), each warp half of the accumulators'
// columns (DC = DP / 2: 144 registers for dK and dV, 72 for dQ), and each
// contracts half of D for the pair's scores: its DC columns of K Qᵀ and
// V dOᵀ (Q Kᵀ and dO Vᵀ), whose partial float32 fragments pass through a
// slot of shared memory a warp (pair_sum, a barrier of the pair's 64
// threads; a + b and b + a are the same float, so both warps compute the
// same P and dS bits). The products a pair makes are the function's 5,
// plus dK's second part and dQ's recomputed S and dP, as below D = 128.
//   - Tiles: D padded to a multiple of 32 (each warp's half in whole
//     16-column blocks: classes 160, 192, 224, 256, 288); a dK/dV block
//     of 8 warps owns 64 keys and walks 32 query rows a step, a dQ block
//     of 8 warps owns 64 query rows and walks 32 keys a step. At DP = 288
//     (rows of 296 bf16): dK/dV 2 x 64 + 2 x 2 x 32 rows = 151,552 B and
//     32 KB of slots, dQ the same, one block an SM; 249 and 196 registers,
//     0 spills (the tiles of D <= 128, 2 x 128 + 4 x 32 rows, would need
//     227,840 B and leave no room for the double buffer to grow).
//   - Chosen with kernels/flash_attention/bwd_ab.py on an H100 (PERF.md
//     section 6), the whole backward at S = 4096 / 8192: each warp of a
//     pair contracting all of D (7 products a pair in dK/dV, 5 in dQ, no
//     slots, dQ walking 64 keys) 3.25 / 8.24 ms; sharing the contraction
//     in dK/dV 3.06-3.12 / 7.74, in dQ 3.18 / 7.91, in both 2.96-3.00 /
//     7.40 (this design); 16 query rows a dK/dV step 3.51-3.55 / 8.9; dQ
//     unsplit (4 warps of 16 rows x 288 columns, 32 keys a step) 3.25-3.30
//     / 8.1-8.2. The FMA kernels took 26.1-26.6 / 76.7-77.1 ms. At these
//     tiles each warp reads its B fragments (the walked rows) from shared
//     memory for itself: ldmatrix traffic, not the tensor cores, is the
//     likely limit (~15x the bound).
//
// float64 and float32 run the FMA kernels dkdv_kernel and dq_kernel,
// chosen statically by dtype and D in launch(). 256 threads as 16 x 16;
// thread (ty, tx)
// owns rows ty + 16a (a < TA) of the block's own tile and columns tx + 16c
// (c < NC, NC = ceil(D / 16) rounded up to an instantiated size) of its
// accumulators, and the pairs (ty + 16a, tx + 16b) of each score tile
// (b < TB). Tiles live in shared memory in the accumulation type with rows
// of D + 1 values (conflict-free column reads); P and dS pass through two
// small shared tiles. Float64 takes TB = 1 (16 rows a step), so the tiles
// of D = 288 fit the 227 KB a block may have; float32 takes TB = 2.
//
// Query positions: row i of batch-head r sits at position q_offset[r] + i
// (the forward's q_offset; null: i). Every kernel reads its batch-head's
// offset and moves its tile bounds and element masks with it.
//
// Rows with no valid key (a window past the last key, or a causal row
// before the first): the forward gives such a row the mean of V over all
// Skv keys (P uniform, as the reference's softmax over scores masked at
// -1e30), and the reference's gradient through it (jnp.where passes none
// to masked scores) is dQ = 0, nothing to dK, and dO_i / Skv to dV of
// every key. Here P is 0 on every masked pair, so such a row adds nothing
// to dQ, dK or dV in the kernels above; where the caller can have one (a
// q_offset, or window > 0 with Sq >= Skv + window) the preamble also sums
// dO over each batch-head's empty rows in row order (esum, BH x D in the
// accumulation type: extra blocks of delta_kernel, no atomics), and the
// dK/dV kernels add esum / Skv to dV of every key. Without one nothing
// changes.
//
// Types: double in, double accumulation; float in, float; bf16 in, float.
//
// C interface (loaded with ctypes): pointers (q, k, v, o, dO, lse,
// q_offset (int32 (BH,), null: none), the delta scratch of BH x (Sq + D)
// accumulation values, dq, dk, dv), the sizes, the options and the CUDA
// stream; each entry returns a cudaError_t. flash_attention_bwd_abi names
// the entries' signature (2: with q_offset and empty rows), for tools
// that call other checkouts.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "dmma.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;        // 16 row groups x 16 column groups
constexpr int MAX_D = 288;          // gemma2_2b: 2304 / 8 heads
constexpr float LOG2E = 1.4426950408889634f;

template <typename Acc, typename T>
__device__ __forceinline__ Acc to_acc(T v) { return static_cast<Acc>(v); }
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T from_acc(Acc v) { return static_cast<T>(v); }

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

// whether the row at position qp has no valid key among skv
__device__ __forceinline__ bool no_key(int qp, int skv, int causal,
                                       int window) {
  const int lo = window > 0 ? max(0, qp - window + 1) : 0;
  const int hi = causal ? min(skv - 1, qp) : skv - 1;
  return lo > hi;
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

// 2^x on the SFU, results below 2^-126 flushed to 0 (exp2f keeps them,
// at several instructions more an element: 15 % of the backward's time)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grad_pair in base 2, for the tensor-core kernels: P = 2^(x log2 e -
// lse log2 e), the exponent one FMA from the raw score s (scale2 = scale
// log2 e, lse2 = lse log2 e) and the power ex2_ftz, where expf takes
// several instructions more; P's relative error from the rounded
// exponent (~|x - lse| 2^-24) and from ex2 (~2^-22) lies far below the
// bf16 rounding P then takes, and a P below 2^-126 adds nothing a bf16
// sum of the gradients keeps. CAP: with the softcap (a template argument
// of the kernels: a branch on the softcap in the element loop costs
// registers and time)
template <bool CAP>
__device__ __forceinline__ void grad_pair2(float s, float dp, bool ok,
                                           float lse2, float delta,
                                           float scale, float scale2,
                                           float softcap, float* p_out,
                                           float* ds_out) {
  float e2 = s * scale2 - lse2;
  float t = 0.0f;
  if constexpr (CAP) {
    t = tanhf(s * scale / softcap);
    e2 = t * softcap * LOG2E - lse2;
  }
  const float p = ok ? ex2_ftz(e2) : 0.0f;
  float ds = ok ? p * (dp - delta) : 0.0f;
  if constexpr (CAP) ds *= 1.0f - t * t;
  *p_out = p;
  *ds_out = ds;
}

// the preamble: delta[r] = sum_c dO[r][c] O[r][c], a warp per row, in
// the first row_blocks blocks; with esum, one block per batch-head after
// them: esum[bh][c] = the sum of dO[bh][i][c] over the rows i with no
// valid key, in row order
template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             Acc* __restrict__ delta, Acc* __restrict__ esum,
             const int* __restrict__ q_offset, int64_t rows,
             int64_t row_blocks, int sq, int skv, int d, int causal,
             int window) {
  if (blockIdx.x >= row_blocks) {
    const int64_t bh = blockIdx.x - row_blocks;
    const int off = q_offset ? q_offset[bh] : 0;
    const T* db = dout + bh * sq * d;
    for (int c = threadIdx.x; c < d; c += THREADS) {
      Acc sum = Acc(0);
      for (int i = 0; i < sq; ++i)
        if (no_key(off + i, skv, causal, window))
          sum += to_acc<Acc>(db[(int64_t)i * d + c]);
      esum[bh * d + c] = sum;
    }
    return;
  }
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
            const Acc* __restrict__ esum, const int* __restrict__ q_offset,
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
  const int off = q_offset ? q_offset[bh] : 0;   // row 0's position
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
  int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window > 0 ? min(sq, k_last + window - off) : sq;
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
        const bool ok = kp < skv && qp < sq
            && valid(off + qp, kp, causal, window);
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
        // the empty rows' uniform P: dO summed over them, over Skv
        const Acc e = esum ? esum[bh * d + col] / Acc(skv) : Acc(0);
        dkb[(int64_t)r * d + col] = from_acc<T, Acc>(gk[a][c] * scale);
        dvb[(int64_t)r * d + col] = from_acc<T, Acc>(gv[a][c] + e);
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
          const int* __restrict__ q_offset, T* __restrict__ dq, int sq,
          int skv, int d, Acc scale, int causal, int window, Acc softcap) {
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
  const int off = q_offset ? q_offset[bh] : 0;   // row 0's position
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

  // the keys the block's rows see (none for a row with no valid key)
  const int q_last = min(q0 + BA, sq) - 1;
  int k_begin = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int k_end = causal ? min(skv, off + q_last + 1) : skv;
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
        const bool ok = kp < skv && qp < sq
            && valid(off + qp, kp, causal, window);
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

// ---------------------------------------------------------------------
// bf16 on the tensor cores (D <= MMA_MAX_D)
// ---------------------------------------------------------------------

// a dK/dV block: KV_WARPS warps, 16 keys each (NS warps to the same 16
// keys past SPLIT_D); a dQ block: Q_ROWS query rows, 16 a warp (NS warps
// to the same 16 rows past SPLIT_D), walking Q_STEP keys a step
constexpr int KV_WARPS = 8;
constexpr int KV_THREADS = 32 * KV_WARPS;
constexpr int KV_KEYS = 16 * KV_WARPS;
constexpr int Q_THREADS = 128;
constexpr int Q_ROWS = 16 * (Q_THREADS / 32);
constexpr int Q_STEP = 64;
constexpr int MMA_MAX_D = MAX_D;
// past SPLIT_D a pair of warps owns each 16 rows (keys in dK/dV, query
// rows in dQ): each accumulates half of the columns and contracts half
// of D for the pair's scores; the wide classes' dK/dV step (WIDE_BR
// query rows) and dQ step (WIDE_Q_STEP keys) (the note at the top says
// why)
constexpr int SPLIT_D = 128;
constexpr int WIDE_BR = 32;
constexpr int WIDE_Q_STEP = 32;

// rows of a shared bf16 tile padded to DP columns: DP + 8 elements, an odd
// number of 16-byte chunks, so the 8 rows that one ldmatrix block reads
// start in 8 different bank quads
template <int DP>
__host__ __device__ constexpr int mma_ld() { return DP + 8; }

// copies rows [r0, r0 + ROWS) of a row-major (n, d) bf16 matrix into a
// ROWS x (DP + 8) shared tile; elements past row n or column d are zero.
// With vec (d % 8 == 0 and a 16-byte aligned src), 16-byte cp.async copies
// that the caller commits and waits for; else element by element.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void mma_stage(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int r0, int n, int d, bool vec,
                                          int tid) {
  constexpr int LD = mma_ld<DP>();
  if (vec) {
    constexpr int CH = DP / 8;          // 16-byte chunks a row
#pragma unroll 1
    for (int e = tid; e < ROWS * CH; e += THREADS) {
      const int r = e / CH;
      const int c = 8 * (e - r * CH);
      const bool ok = r0 + r < n && c < d;
      const __nv_bfloat16* from =
          ok ? src + (int64_t)(r0 + r) * d + c : src;
      dmma::copy16(dst + r * LD + c, from, ok);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < ROWS * DP; e += THREADS) {
      const int r = e / DP;
      const int c = e - r * DP;
      dst[r * LD + c] = (r0 + r < n && c < d)
          ? src[(int64_t)(r0 + r) * d + c] : __float2bfloat16(0.0f);
    }
  }
}

// the A fragments of a warp's 16 rows of a shared tile, DP / 16 blocks of
// 16 columns; the kernels keep their own tile's in registers for the walk
template <int DP>
__device__ __forceinline__ void mma_load_a(uint32_t (&f)[DP / 16][4],
                                           const __nv_bfloat16* rows,
                                           int lane) {
  constexpr int LD = mma_ld<DP>();
  const int o = mma_bf16::a_row(lane) * LD + mma_bf16::a_col(lane);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    mma_bf16::ldmatrix_x4(f[kk], rows + o + 16 * kk);
}

// the raw scores and dO . V of one warp's 16 own rows of shared tiles x1,
// x2 against NT * 8 walked rows of shared tiles y1, y2, each a float32 C
// fragment: s = x1 y1ᵀ, dp = x2 y2ᵀ (in mma_dkdv_kernel x = (K, V), y =
// (Q, dO), giving Sᵀ and dPᵀ; in mma_dq_kernel x = (Q, dO), y = (K, V),
// giving S and dP). With HOLD the own rows' A fragments come from x1f,
// x2f (mma_load_a), else from x1, x2 at every call. The sums run over the
// KN blocks of 16 columns from col0 (all of DP unless a share of it).
template <int DP, int NT, bool HOLD, int KN = DP / 16>
__device__ __forceinline__ void mma_pair_products(
    const uint32_t (&x1f)[HOLD ? DP / 16 : 1][4],
    const uint32_t (&x2f)[HOLD ? DP / 16 : 1][4],
    const __nv_bfloat16* x1, const __nv_bfloat16* x2,
    const __nv_bfloat16* y1, const __nv_bfloat16* y2, int lane,
    float (&s)[NT][4], float (&dp)[NT][4], int col0 = 0) {
  static_assert(!HOLD || KN == DP / 16, "held fragments cover all of DP");
  constexpr int LD = mma_ld<DP>();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
  const int xo = mma_bf16::a_row(lane) * LD + mma_bf16::a_col(lane) + col0;
  const int yo = mma_bf16::b_row(lane) * LD + mma_bf16::b_col(lane) + col0;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    uint32_t a1[4], a2[4];
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = x1f[kk][i];
        a2[i] = x2f[kk][i];
      }
    } else {
      mma_bf16::ldmatrix_x4(a1, x1 + xo + 16 * kk);
      mma_bf16::ldmatrix_x4(a2, x2 + xo + 16 * kk);
    }
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      mma_bf16::ldmatrix_x4(b, y1 + 16 * jp * LD + yo + 16 * kk);
      mma_bf16::mma(s[2 * jp], a1, b[0], b[1]);
      mma_bf16::mma(s[2 * jp + 1], a1, b[2], b[3]);
      mma_bf16::ldmatrix_x4(b, y2 + 16 * jp * LD + yo + 16 * kk);
      mma_bf16::mma(dp[2 * jp], a2, b[0], b[1]);
      mma_bf16::mma(dp[2 * jp + 1], a2, b[2], b[3]);
    }
  }
}

// the scores' partial sums of the two warps of a pair (warp ^ 1): each
// warp stores its own (s, dp) fragments in its slot of xs (lane-major:
// conflict-free), waits on the pair's barrier (id 1 + the pair's index)
// and adds its partner's. a + b and b + a are the same float, so both
// warps hold the same bits. The slot is rewritten only after the next
// __syncthreads of the block, when the partner has read it.
template <int NT>
__device__ __forceinline__ void pair_sum(float* xs, int warp, int lane,
                                         float (&s)[NT][4],
                                         float (&dp)[NT][4]) {
  float* mine = xs + warp * (2 * NT * 4 * 32);
  const float* theirs = xs + (warp ^ 1) * (2 * NT * 4 * 32);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(j * 4 + e) * 32 + lane] = s[j][e];
      mine[((NT + j) * 4 + e) * 32 + lane] = dp[j][e];
    }
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + warp / 2) : "memory");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] += theirs[(j * 4 + e) * 32 + lane];
      dp[j][e] += theirs[((NT + j) * 4 + e) * 32 + lane];
    }
}

// dK and dV of the KV_KEYS / NS keys from k0 of batch-head blockIdx.y:
// warp w owns keys k0 + 16 (w / NS) .. + 15 and columns DC (w % NS) ..
// + DC - 1 of their dK and dV (DC = DP / NS; with NS = 2 the pair forms
// its keys' Sᵀ and dPᵀ each over its DC columns of D, summed by
// pair_sum) and walks BR query rows a step; with HOLD it keeps its keys'
// K and V fragments in registers; CAP: with the softcap
template <int DP, int BR, bool HOLD, bool CAP, int NS>
__global__ void __launch_bounds__(KV_THREADS)
mma_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ esum,
                const int* __restrict__ q_offset,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int sq, int skv, int d,
                float scale, int causal, int window, float softcap,
                int vec) {
  constexpr int LD = mma_ld<DP>();
  constexpr int KEYS = KV_KEYS / NS;  // keys of the block
  constexpr int DC = DP / NS;         // columns of dK and dV a warp owns
  constexpr int NT = BR / 8;          // 8-row tiles of the walked rows
  constexpr int DT = DC / 8;          // 8-column tiles of them
  static_assert(DC % 16 == 0, "a warp's columns in 16-column blocks");
  static_assert(NS <= 2 && (!HOLD || NS == 1), "pairs of warps at most");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + KEYS * LD;
  __nv_bfloat16* qs = vs + KEYS * LD;                // 2 x BR x LD
  __nv_bfloat16* dos = qs + 2 * BR * LD;             // 2 x BR x LD
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BR * LD);  // 2 x BR
  float* del_s = lse_s + 2 * BR;                                // 2 x BR
  float* xs = del_s + 2 * BR;          // NS = 2: KV_WARPS x 2 x BR x 16

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kg = warp / NS;                          // the warp's keys
  const int c0 = DC * (warp % NS);                   // and columns
  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * KEYS;
  const int kw = k0 + 16 * kg;
  const int off = q_offset ? q_offset[bh] : 0;       // row 0's position
  const float scale2 = scale * LOG2E;
  const __nv_bfloat16* qb = q + bh * sq * d;
  const __nv_bfloat16* dob = dout + bh * sq * d;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  // the query rows that see a key of the block (as dkdv_kernel)
  const int k_last = min(k0 + KEYS, skv) - 1;
  int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window > 0 ? min(sq, k_last + window - off) : sq;
  q_begin = (q_begin / BR) * BR;

  auto load_rows = [&](int qt, int buf) {
    mma_stage<BR, DP, KV_THREADS>(qs + buf * BR * LD, qb, qt, sq, d, vec,
                                  tid);
    mma_stage<BR, DP, KV_THREADS>(dos + buf * BR * LD, dob, qt, sq, d, vec,
                                  tid);
    if (tid < BR) {
      lse_s[buf * BR + tid] = qt + tid < sq ? lb[qt + tid] * LOG2E : 0.0f;
      del_s[buf * BR + tid] = qt + tid < sq ? db[qt + tid] : 0.0f;
    }
  };
  mma_stage<KEYS, DP, KV_THREADS>(ks, k + bh * skv * d, k0, skv, d, vec,
                                  tid);
  mma_stage<KEYS, DP, KV_THREADS>(vs, v + bh * skv * d, k0, skv, d, vec,
                                  tid);
  if (q_begin < q_end) load_rows(q_begin, 0);
  dmma::commit();

  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.0f;

  // the warp's K and V fragments, once the first copies have landed
  dmma::wait<0>();
  __syncthreads();
  const __nv_bfloat16* kw_s = ks + 16 * kg * LD;
  const __nv_bfloat16* vw_s = vs + 16 * kg * LD;
  uint32_t kf[HOLD ? DP / 16 : 1][4], vf[HOLD ? DP / 16 : 1][4];
  if constexpr (HOLD) {
    mma_load_a<DP>(kf, kw_s, lane);
    mma_load_a<DP>(vf, vw_s, lane);
  }
  const int to = mma_bf16::a_row(lane) * LD + mma_bf16::a_col(lane) + c0;
  int buf = 0;
#pragma unroll 1
  for (int qt = q_begin; qt < q_end; qt += BR, buf ^= 1) {
    dmma::wait<0>();            // this thread's copies of the step's rows
    __syncthreads();            // everyone's; the last step is done
    if (qt + BR < q_end) load_rows(qt + BR, buf ^ 1);
    dmma::commit();             // the next rows' copies overlap this step
    const __nv_bfloat16* qc = qs + buf * BR * LD;
    const __nv_bfloat16* doc = dos + buf * BR * LD;
    const float* lc = lse_s + buf * BR;
    const float* dc = del_s + buf * BR;

    float s[NT][4], dp[NT][4];
    mma_pair_products<DP, NT, HOLD, DC / 16>(kf, vf, kw_s, vw_s, qc, doc,
                                             lane, s, dp, c0);
    if constexpr (NS == 2) pair_sum<NT>(xs, warp, lane, s, dp);

    // Pᵀ and dSᵀ in place; the element mask only where the warp's keys
    // and the step's rows are not all valid pairs
    const int pt = off + qt;                  // the step's first position
    const bool edge = kw + 16 > skv || qt + BR > sq
        || (causal && pt < kw + 15)
        || (window > 0 && pt + BR - 1 - window >= kw);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        const int kp = kw + g + 8 * (e >> 1);
        const bool ok = !edge
            || (kp < skv && qt + r < sq && valid(pt + r, kp, causal, window));
        grad_pair2<CAP>(s[j][e], dp[j][e], ok, lc[r], dc[r], scale, scale2,
                        softcap, &s[j][e], &dp[j][e]);
      }

    // dV += Pᵀ dO and dK += dSᵀ Q on the warp's columns, 16 query rows at
    // a time; dS goes in as its bf16 rounding plus the rounding's rest
#pragma unroll
    for (int kq = 0; kq < BR / 16; ++kq) {
      uint32_t pa[4], da[4], dr[4];
      mma_bf16::pack_a(pa, s[2 * kq], s[2 * kq + 1]);
      mma_bf16::pack_a(da, dp[2 * kq], dp[2 * kq + 1]);
      mma_bf16::pack_a_rest(dr, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int c = 0; c < DT / 2; ++c) {
        uint32_t b[4];
        mma_bf16::ldmatrix_x4_trans(b, doc + 16 * kq * LD + to + 16 * c);
        mma_bf16::mma(gv[2 * c], pa, b[0], b[1]);
        mma_bf16::mma(gv[2 * c + 1], pa, b[2], b[3]);
        mma_bf16::ldmatrix_x4_trans(b, qc + 16 * kq * LD + to + 16 * c);
        mma_bf16::mma(gk[2 * c], da, b[0], b[1]);
        mma_bf16::mma(gk[2 * c + 1], da, b[2], b[3]);
        mma_bf16::mma(gk[2 * c], dr, b[0], b[1]);
        mma_bf16::mma(gk[2 * c + 1], dr, b[2], b[3]);
      }
    }
  }

  __nv_bfloat16* dkb = dk + bh * skv * d;
  __nv_bfloat16* dvb = dv + bh * skv * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kw + g + 8 * h;
    if (r >= skv) continue;
#pragma unroll
    for (int c = 0; c < DT; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * c + 2 * t + e;
        if (col < d) {
          // the empty rows' uniform P: dO summed over them, over Skv
          const float ex = esum ? esum[bh * d + col] / (float)skv : 0.0f;
          dkb[(int64_t)r * d + col] =
              __float2bfloat16(gk[c][2 * h + e] * scale);
          dvb[(int64_t)r * d + col] =
              __float2bfloat16(gv[c][2 * h + e] + ex);
        }
      }
  }
}

// dQ of the Q_ROWS query rows from q0 of batch-head blockIdx.y: warp w
// owns rows q0 + 16 (w / NS) .. + 15 and columns DC (w % NS) .. + DC - 1
// of their dQ (DC = DP / NS; with NS = 2 the pair forms its rows' S and
// dP each over its DC columns of D, summed by pair_sum) and walks STEP
// keys a step; with HOLD it keeps its rows' Q and dO fragments in
// registers; CAP: with the softcap; MINB blocks must fit an SM (the
// register budget)
template <int DP, bool HOLD, bool CAP, int MINB, int NS, int STEP>
__global__ void __launch_bounds__(Q_THREADS * NS, MINB)
mma_dq_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ q_offset,
              __nv_bfloat16* __restrict__ dq, int sq, int skv, int d,
              float scale, int causal, int window, float softcap, int vec) {
  constexpr int THREADS_Q = Q_THREADS * NS;
  constexpr int LD = mma_ld<DP>();
  constexpr int DC = DP / NS;         // columns of dQ a warp owns
  constexpr int NT = STEP / 8;        // 8-key tiles of a step
  constexpr int DT = DC / 8;          // 8-column tiles of dQ
  static_assert(DC % 16 == 0, "a warp's columns in 16-column blocks");
  static_assert(NS <= 2 && (!HOLD || NS == 1), "pairs of warps at most");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + Q_ROWS * LD;
  __nv_bfloat16* ks = dos + Q_ROWS * LD;             // 2 x STEP x LD
  __nv_bfloat16* vs = ks + 2 * STEP * LD;            // 2 x STEP x LD
  // NS = 2: warps x 2 x STEP x 16
  float* xs = reinterpret_cast<float*>(vs + 2 * STEP * LD);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp / NS;                          // the warp's rows
  const int c0 = DC * (warp % NS);                   // and columns
  const int64_t bh = blockIdx.y;
  // the last rows first: under a causal mask they walk the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Q_ROWS;
  const int qw = q0 + 16 * rg;
  const int off = q_offset ? q_offset[bh] : 0;       // row 0's position
  const int pw = off + qw;                           // their position
  const float scale2 = scale * LOG2E;
  const __nv_bfloat16* kb = k + bh * skv * d;
  const __nv_bfloat16* vb = v + bh * skv * d;

  // the keys the block's rows see (as dq_kernel)
  const int q_last = min(q0 + Q_ROWS, sq) - 1;
  int k_begin = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int k_end = causal ? min(skv, off + q_last + 1) : skv;
  k_begin = (k_begin / STEP) * STEP;

  auto load_keys = [&](int kt, int buf) {
    mma_stage<STEP, DP, THREADS_Q>(ks + buf * STEP * LD, kb, kt, skv, d,
                                   vec, tid);
    mma_stage<STEP, DP, THREADS_Q>(vs + buf * STEP * LD, vb, kt, skv, d,
                                   vec, tid);
  };
  mma_stage<Q_ROWS, DP, THREADS_Q>(qs, q + bh * sq * d, q0, sq, d, vec,
                                   tid);
  mma_stage<Q_ROWS, DP, THREADS_Q>(dos, dout + bh * sq * d, q0, sq, d, vec,
                                   tid);
  if (k_begin < k_end) load_keys(k_begin, 0);
  dmma::commit();

  // lse and Δ of the lane's two rows, qw + g and qw + g + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw + g + 8 * h;
    lse_r[h] = r < sq ? lse[bh * sq + r] * LOG2E : 0.0f;
    del_r[h] = r < sq ? delta[bh * sq + r] : 0.0f;
  }

  float gq[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[c][e] = 0.0f;

  // the warp's Q and dO fragments, once the first copies have landed
  dmma::wait<0>();
  __syncthreads();
  const __nv_bfloat16* qw_s = qs + 16 * rg * LD;
  const __nv_bfloat16* dow_s = dos + 16 * rg * LD;
  uint32_t qf[HOLD ? DP / 16 : 1][4], dof[HOLD ? DP / 16 : 1][4];
  if constexpr (HOLD) {
    mma_load_a<DP>(qf, qw_s, lane);
    mma_load_a<DP>(dof, dow_s, lane);
  }
  const int to = mma_bf16::a_row(lane) * LD + mma_bf16::a_col(lane) + c0;
  int buf = 0;
#pragma unroll 1
  for (int kt = k_begin; kt < k_end; kt += STEP, buf ^= 1) {
    dmma::wait<0>();            // this thread's copies of the step's keys
    __syncthreads();            // everyone's; the last step is done
    if (kt + STEP < k_end) load_keys(kt + STEP, buf ^ 1);
    dmma::commit();             // the next keys' copies overlap this step
    const __nv_bfloat16* kc = ks + buf * STEP * LD;
    const __nv_bfloat16* vc = vs + buf * STEP * LD;

    float s[NT][4], dp[NT][4];
    mma_pair_products<DP, NT, HOLD, DC / 16>(qf, dof, qw_s, dow_s, kc, vc,
                                             lane, s, dp, c0);
    if constexpr (NS == 2) pair_sum<NT>(xs, warp, lane, s, dp);

    const bool edge = qw + 16 > sq || kt + STEP > skv
        || (causal && kt + STEP - 1 > pw)
        || (window > 0 && kt <= pw + 15 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qw + g + 8 * (e >> 1);
        const int kp = kt + 8 * j + 2 * t + (e & 1);
        const bool ok = !edge
            || (kp < skv && qp < sq && valid(off + qp, kp, causal, window));
        grad_pair2<CAP>(s[j][e], dp[j][e], ok, lse_r[e >> 1], del_r[e >> 1],
                        scale, scale2, softcap, &s[j][e], &dp[j][e]);
      }

    // dQ += dS K on the warp's columns, 16 keys at a time
#pragma unroll
    for (int kq = 0; kq < STEP / 16; ++kq) {
      uint32_t da[4];
      mma_bf16::pack_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int c = 0; c < DT / 2; ++c) {
        uint32_t b[4];
        mma_bf16::ldmatrix_x4_trans(b, kc + 16 * kq * LD + to + 16 * c);
        mma_bf16::mma(gq[2 * c], da, b[0], b[1]);
        mma_bf16::mma(gq[2 * c + 1], da, b[2], b[3]);
      }
    }
  }

  __nv_bfloat16* dqb = dq + bh * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw + g + 8 * h;
    if (r >= sq) continue;
#pragma unroll
    for (int c = 0; c < DT; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * c + 2 * t + e;
        if (col < d)
          dqb[(int64_t)r * d + col] =
              __float2bfloat16(gq[c][2 * h + e] * scale);
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
              const void* lse, const void* delta, const void* esum,
              const int* q_offset, void* dq, void* dk, void* dv, int bh,
              int sq, int skv, int d, int causal, int window, double softcap,
              cudaStream_t stream) {
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
      static_cast<const Acc*>(esum), q_offset, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, skv, d, scale, causal, window, Acc(softcap));
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
      q_offset, static_cast<T*>(dq), sq, skv, d, scale, causal, window,
      Acc(softcap));
  return (int)cudaGetLastError();
}

// shared bytes: the tiles, lse and Δ, and with pairs of warps (NS = 2)
// each warp's slot of pair_sum
template <int DP, int BR, int NS>
size_t mma_dkdv_smem() {
  return (size_t)(2 * KV_KEYS / NS + 4 * BR) * mma_ld<DP>()
      * sizeof(__nv_bfloat16) + 4 * BR * sizeof(float)
      + (NS == 2 ? KV_WARPS * 2 * BR * 16 * sizeof(float) : 0);
}

template <int DP, int STEP, int NS>
size_t mma_dq_smem() {
  return (size_t)(2 * Q_ROWS + 4 * STEP) * mma_ld<DP>()
      * sizeof(__nv_bfloat16)
      + (NS == 2 ? Q_THREADS / 32 * NS * 2 * STEP * 16 * sizeof(float) : 0);
}

// the tensor-core kernels of one padded head dim DP: dK/dV walking BR
// query rows a step, dQ walking STEP keys; past SPLIT_D pairs of warps
// (the note at the top says why)
template <int DP>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* esum, const int* q_offset, void* dq, void* dk,
               void* dv, int bh, int sq, int skv, int d, int causal,
               int window, double softcap, cudaStream_t stream) {
  constexpr bool WIDE = DP > SPLIT_D;
  constexpr int NS = WIDE ? 2 : 1;        // warps a 16-row group
  constexpr int BR = WIDE ? WIDE_BR : DP <= 80 ? 64 : 32;
  constexpr int STEP = WIDE ? WIDE_Q_STEP : Q_STEP;
  constexpr bool HOLD_KV = DP <= 80;      // with the softcap: DP <= 64
  constexpr bool HOLD_Q = DP <= 32;
  constexpr int MINB_Q = DP <= 80 ? 3 : WIDE ? 1 : 2;
  constexpr int KEYS = KV_KEYS / NS;
  using B16 = __nv_bfloat16;
  const float scale = (float)(1.0 / sqrt((double)d));
  // 16-byte copies need whole 16-byte chunks of every row
  const int vec = d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v
                                 | (uintptr_t)dout) % 16 == 0;
  const bool cap = softcap > 0.0;
  auto kv_kern = cap
      ? mma_dkdv_kernel<DP, BR, HOLD_KV && DP <= 64, true, NS>
      : mma_dkdv_kernel<DP, BR, HOLD_KV, false, NS>;
  const size_t kv_smem = mma_dkdv_smem<DP, BR, NS>();
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  kv_kern<<<dim3((unsigned)((skv + KEYS - 1) / KEYS), (unsigned)bh),
            KV_THREADS, kv_smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<const B16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(esum), q_offset, static_cast<B16*>(dk),
      static_cast<B16*>(dv), sq, skv, d, scale, causal, window,
      (float)softcap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto q_kern = cap ? mma_dq_kernel<DP, HOLD_Q, true, MINB_Q, NS, STEP>
                    : mma_dq_kernel<DP, HOLD_Q, false, MINB_Q, NS, STEP>;
  const size_t q_smem = mma_dq_smem<DP, STEP, NS>();
  err = cudaFuncSetAttribute(
      q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  q_kern<<<dim3((unsigned)((sq + Q_ROWS - 1) / Q_ROWS), (unsigned)bh),
           Q_THREADS * NS, q_smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k),
      static_cast<const B16*>(v), static_cast<const B16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      q_offset, static_cast<B16*>(dq), sq, skv, d, scale, causal, window,
      (float)softcap, vec);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, const int*,
                       void*, void*, void*, int, int, int, int, int, int,
                       double, cudaStream_t);

template <typename T, typename Acc>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* q_offset_ptr,
           void* delta, void* dq, void* dk, void* dv, int64_t bh, int64_t sq,
           int64_t skv, int64_t d, int causal, int window, double softcap,
           void* stream_ptr) {
  if (d < 1 || d > MAX_D || bh > 65535 || sq > ((int64_t)1 << 30)
      || skv > ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* q_offset = static_cast<const int*>(q_offset_ptr);
  const int64_t rows = bh * sq;
  const int64_t rows_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  // rows with no valid key: possible with an offset, or with a window
  // that lies past the last key (Sq >= Skv + window); their dO sums go
  // after delta
  Acc* esum = q_offset != nullptr || (window > 0 && sq >= skv + window)
      ? static_cast<Acc*>(delta) + rows : nullptr;
  delta_kernel<T, Acc><<<(unsigned)(rows_blocks + (esum ? bh : 0)),
                         THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<Acc*>(delta), esum, q_offset, rows, rows_blocks,
      (int)sq, (int)skv, (int)d, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Launch fn = nullptr;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16: the tensor-core kernels at every D, padded to a multiple of
    // 16 of at least 32 up to SPLIT_D and of 32 past it (a warp's half of
    // the columns in whole 16-column blocks)
    constexpr Launch by_dp[] = {
        launch_mma<32>, launch_mma<32>, launch_mma<48>, launch_mma<64>,
        launch_mma<80>, launch_mma<96>, launch_mma<112>, launch_mma<128>,
        launch_mma<160>, launch_mma<160>, launch_mma<192>, launch_mma<192>,
        launch_mma<224>, launch_mma<224>, launch_mma<256>, launch_mma<256>,
        launch_mma<288>, launch_mma<288>};
    static_assert(sizeof(by_dp) / sizeof(by_dp[0]) == MMA_MAX_D / 16,
                  "one entry per multiple of 16");
    fn = by_dp[(d + 15) / 16 - 1];
  } else {
    // the register tile's width: the least instantiated ceil(D / 16)
    fn = launch_nc<T, Acc, 18>;
    if (d <= 192) fn = launch_nc<T, Acc, 12>;
    if (d <= 128) fn = launch_nc<T, Acc, 8>;
    if (d <= 64) fn = launch_nc<T, Acc, 4>;
    if (d <= 32) fn = launch_nc<T, Acc, 2>;
  }
  return fn(q, k, v, dout, lse, delta, esum, q_offset, dq, dk, dv, (int)bh,
            (int)sq, (int)skv, (int)d, causal, window, softcap, stream);
}

}  // namespace

extern "C" {

#define FLASH_BWD_ENTRY(NAME, T, ACC)                                        \
  int NAME(const void* q, const void* k, const void* v, const void* o,      \
           const void* dout, const void* lse, const void* q_offset,         \
           void* delta, void* dq, void* dk, void* dv, int64_t bh,           \
           int64_t sq, int64_t skv, int64_t d, int causal, int window,      \
           double softcap, void* stream) {                                  \
    return launch<T, ACC>(q, k, v, o, dout, lse, q_offset, delta, dq, dk,   \
                          dv, bh, sq, skv, d, causal, window, softcap,      \
                          stream);                                           \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f64, double, double)
FLASH_BWD_ENTRY(flash_attention_bwd_f32, float, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16, float)

int flash_attention_bwd_abi() { return 2; }

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
