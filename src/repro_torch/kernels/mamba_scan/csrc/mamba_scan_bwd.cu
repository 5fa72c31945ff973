// The gradient of the selective scan (Mamba) for Hopper (sm_90a): from the
// output's gradient dy (and, where the forward handed out the final state,
// that state's gradient dh_L), with A = -exp(a), dA_t = exp(dt_t A) and the
// adjoint g_t = dL/dh_t,
//
//   g_t = dy_t (x) C_t + dA_{t+1} (.) g_{t+1},  g_L = dy_L (x) C_L + dh_L
//   dx_t  = d_skip dy_t + dt_t sum_n g_t B_t
//   ddt_t = x_t sum_n g_t B_t + sum_n g_t h_{t-1} A dA_t
//   dB_t = sum_i g_t dt_t x_t,   dC_t = sum_i dy_t h_t
//   da = sum_{b,t} g_t h_{t-1} dA_t dt_t A,   dd_skip = sum_{b,t} dy_t x_t
//
// It replaces no TPU kernel: the TPU package differentiates its jnp scan
// (repro/models/ssm.py::_mamba_scan_train) with JAX's autodiff, and its
// Pallas scan has no gradient. The port runs the scan on the card through
// csrc/mamba_scan.cu, so training the hybrid family there needs this.
//
// Both kernels run the forward's chained scan backwards, in one grid: a
// block takes its chunk index (LC = 64 steps, the last chunk first) from
// an atomic counter and the adjoint entering its chunk from a fixed-order
// look-back over flags (release stores, acquire loads) in groups of GROUP
// chunks, as the forward looks back over the earlier ones; a chunk maps
// the adjoint as g -> exp(A S) g + g_chunk, S its sum of dt. The adjoint
// entering the last chunk is dh_L (0 without one). Nothing divides by a
// cumulative decay. h is recomputed from the forward's own entry state of
// each 16-step segment (h_seg, (B, segments, N, I)), with the forward's
// step (state_step), so the states are the forward's bits. No atomics but
// the counter (an index, not a sum): dB and dC of each (batch, step) are
// written per channel tile, da and dd_skip per (batch, chunk), into the
// workspace; sum_kernel adds each over its tiles or chunks in order and
// casts to the operand's dtype: every call gives the same bits.
//
// float32 and bf16 (the accumulator float): scan_bwd_kernel, redesigned
// for Hopper. Measured first (PERF.md, section 6): the first design's
// kernel (below, kept for float64) spent ~1.0 of its 2.78 ms at the Jamba
// layer (B = 1, L = 4096, I = 16384, N = 16) staging its tile, walking
// and looking back while three of its four warps waited on the fourth,
// ~0.44 on a 32-lane reduce-scatter of dB and dC each step and ~0.30 on
// their partials; its exps did not set the pace (ex2 replaced by two FP32
// operations ran slower). So:
// * A warp owns 16 channels over the whole chunk: a lane two neighbouring
//   channels (a pair) and a quarter of their states (4 of each at N = 16;
//   N = 1 pads three quarters). Each warp runs walk 1 (the adjoint over
//   the chunk from 0), its own look-back (its own flags and records),
//   walk 2 (from each segment's entry state, the state at each
//   mini-block's start into shared memory) and walk 3 (back over the
//   mini-blocks of K = 2 steps: the steps' exps and states recomputed
//   into registers, dC taken on the way, then the adjoint back over
//   them). No warp waits on another until a segment's sums.
// * A block is 8 warps, 128 channels of one chunk. dB and dC are summed
//   over the pair in registers, over the warp's 8 pairs by a
//   reduce-scatter of shuffles (lane bits 4 .. 2), into one slot a (step,
//   state) in shared memory; after each segment the block adds the 8
//   warps' slots in order: one partial a 128-channel tile (4x fewer than
//   the first design's 32-channel tiles: 34 MB each at the Jamba layer).
//   dx and ddt: the 4 quarters of a pair add their sums over n (4
//   shuffles); one lane writes each dx or ddt.
// * exps a (b, t, i, n): 1 in walk 1, 7/8 in walk 2 (the states at the
//   starts of the 8 mini-blocks but the first), 1 in walk 3 (each step's
//   dA_t once, for h_t, the adjoint's step and ddt): 2.875, against the
//   first design's 3.5 and the function's 1 (h's step to t and the
//   adjoint's step to t - 1 share dA_t). g_t dA_t h_{t-1} is
//   u_{t-1} h_{t-1} (u the adjoint carried to t - 1), one multiply.
// * x, dt and dy reach the walks through shared memory, staged by each
//   warp with cp.async (16 bytes a copy where aligned): walk 1's dt and
//   dy of the whole chunk into the warp's area (which then holds the
//   mini-blocks' states), each segment's dt, x and dy with the forward's
//   state entering it once the segment after it is done (the last
//   segment's while the warp looks back).
// * At N = 16: 112 KB of shared memory a block, 128 registers and no
//   spills (__launch_bounds__ for 2 blocks, 16 warps an SM), every loop
//   over a register array unrolled. It runs the Jamba layer in ~2.15 ms
//   (NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 6), 5.4x the bound;
//   what holds it there is walk 3 (the adjoint ~0.75 ms, the recompute
//   ~0.45 against ~0.65 of issue slots): latency the 16 warps do not
//   hide (12 warps an SM ran slower, 8 twice as slow).
//
// float64: scan_bwd_f64_kernel, the first design, unchanged: a block owns 32
// channels (a lane each) of a chunk, warp w the w-th segment; it stages
// the chunk's x, dt and dy (cp.async); walk 1 runs each warp's segment,
// warp 0 folds the warps and looks back; walks 2 and 3 per warp as above
// in passes of 4 states (mini-blocks of 2 steps), dB and dC reduced over
// the warp's 32 lanes each step.
//
// Bound on an H100 SXM: x, dt, dy read and dx, ddt written once (5 x 268
// MB at the Jamba layer at L = 4096: 0.40 ms at 3.35 TB/s) against one
// exp per (b, t, i, n) (1.07e9 on the SFU at 4.2e12 a second, 0.26 ms):
// memory bounds it.
//
// Types: the arithmetic in promote(dtype, float32); dx, ddt, dB, dC, da
// and dd_skip in the operands' dtype; h_seg, dh_L and the workspace in
// the accumulator type.
//
// C interface (loaded with ctypes): pointers (x, dt, Bm, Cm, a, d_skip,
// dy, h_seg, dh_last (null: none), dx, ddt, dBm, dCm, da, dd_skip, the
// workspace), the sizes and the CUDA stream; each entry returns a
// cudaError_t. mamba_scan_bwd_work_bytes gives the workspace's size.

#include "mamba_scan.cuh"

namespace {

// 1 / the decays' scale (scale_decay): ln 2 for float, 1 for double
__device__ __forceinline__ float unscale(float) {
  return 0.6931471805599453f;
}
__device__ __forceinline__ double unscale(double) { return 1.0; }

__host__ __device__ inline int64_t up16(int64_t v) {
  return (v + 15) / 16 * 16;
}

// the workspace: the counter and the look-back's flags (zeroed per call),
// its records ((B, chunks, NS + 1, channels) as the forward's), the
// partials of dB and dC (tiles, B, L, N), of da (B, chunks, N, I) and of
// dd_skip (B, chunks, I). A tile is a block's channels; flags a block:
// one in the float64 kernel, one a warp in the float kernel.
struct Shape {
  int64_t chunks, tiles, blocks, flag_bytes, records_at, pb_at, pc_at,
      pa_at, pd_at, bytes;
};

inline Shape shape_of(int64_t batch, int64_t len, int64_t inner, int64_t n,
                      int64_t acc_bytes, int64_t tile_ch,
                      int64_t block_flags) {
  Shape s;
  s.chunks = (len + LC - 1) / LC;
  s.tiles = (inner + tile_ch - 1) / tile_ch;
  s.blocks = batch * s.tiles * s.chunks;
  s.flag_bytes = 4 * (1 + s.blocks * block_flags);
  s.records_at = up16(s.flag_bytes);
  s.pb_at = up16(s.records_at + batch * s.chunks * (state_size(n) + 1) *
                                    s.tiles * tile_ch * acc_bytes);
  const int64_t pbc = s.tiles * batch * len * n * acc_bytes;
  s.pc_at = up16(s.pb_at + pbc);
  s.pa_at = up16(s.pc_at + pbc);
  s.pd_at = up16(s.pa_at + batch * s.chunks * n * inner * acc_bytes);
  s.bytes = s.pd_at + batch * s.chunks * inner * acc_bytes;
  return s;
}

// ---------------------------------------------------------------------
// float64: the first design's kernel

// steps of a mini-block: walk 3 holds K states of a pass in registers.
// At 4, nvcc 12.9 (-O3) miscompiled the kernels of one pass (N <= 4): in
// the PTX, the
// rolled walk 2 addresses its mini-block states from the dt tile's row
// pointer with the offset the states have from the x tile, so they and
// the da store that reuses that address land one tile (16 KB) past their
// place, outside the block's shared memory (0x11000 for 0xd000 at N =
// 1), and the card reports an illegal address. Every index the source
// computes was in bounds when checked on the card, the same source runs
// with walks 2 and 3 unrolled or built with -G, and ptx_check.py finds
// every shared store of each instantiation in its place at these
// constant (and the misplaced ones at 4): PERF.md, section 6.
constexpr int MINI_STEPS = 2;
// the states kept at the start of each mini-block but the first (whose is
// the segment's entry state, read again from h_seg)
constexpr int KEPT = SUB / MINI_STEPS - 1;

// states a walk pass holds in registers: 4 (8 spilled a few bytes)
__host__ __device__ constexpr int pass_states(int ns) {
  return ns < 4 ? ns : 4;
}

// dynamic shared memory: WARPS + 2 slots of (NS + 1) x 32 accumulators
// (each warp's adjoint span, the chunk's aggregate, the carry into it),
// one more for the decays with several passes; the x, dt and dy tiles (LC
// x 32); the B and C rows (LC x NS); the mini-blocks' states (WARPS x KEPT
// x NG x 32); with several passes the sums over n of dx and ddt (2 x LC x
// 32). At N = 16: 154 KB
template <typename T, typename Acc>
__host__ __device__ inline int64_t smem_bytes(int64_t n) {
  const int64_t ns = state_size(n);
  const int64_t ng = pass_states((int)ns);
  const bool split = ng < ns;
  const int64_t acc = sizeof(Acc);
  return (WARPS + 2 + split) * (ns + 1) * LANES * acc +
         3 * LC * LANES * (int64_t)sizeof(T) + 2 * LC * ns * acc +
         WARPS * KEPT * ng * LANES * acc +
         split * 2 * LC * LANES * acc;
}

// the sum over the warp's lanes of each of NG values, in a fixed order:
// lane l ends with the sum of value l / (32 / NG) (each held by 32 / NG
// lanes). NG halves at each of log2(NG) levels (the lane's bit keeps the
// upper half), then the last levels add whole. One template a level, so
// that every loop has a constant trip count: a loop whose count came from
// the enclosing one stayed rolled, and its indexing put v in local memory
// (128 bytes of stack in the float32 kernels at NG = 16).
template <int L, typename Acc, int NG>
__device__ __forceinline__ void reduce_level(Acc (&v)[NG], int lane) {
  constexpr int LV = NG >= 16 ? 4 : NG >= 8 ? 3 : NG >= 4 ? 2 : NG >= 2;
  if constexpr (L < LV) {
    constexpr int mask = 16 >> L;
    constexpr int half = NG >> (L + 1);
    const bool up = lane & mask;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const Acc lo = v[j], hi = v[j + half];
      v[j] = (up ? hi : lo) +
             __shfl_xor_sync(0xffffffffu, up ? lo : hi, mask);
    }
    reduce_level<L + 1, Acc, NG>(v, lane);
  } else if constexpr (L < 5) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16 >> L);
    reduce_level<L + 1, Acc, NG>(v, lane);
  }
}

template <typename Acc, int NG>
__device__ __forceinline__ Acc reduce_scatter(Acc (&v)[NG], int lane) {
  reduce_level<0, Acc, NG>(v, lane);
  return v[0];
}

// one step of the recurrence, the forward's (mamba_scan.cu::step) for the
// NG states g0 .. g0 + NG - 1
template <typename Acc, int NS, bool SPLIT, int NG>
__device__ __forceinline__ void step(Acc (&h)[NG],
                                     const Decays<Acc, NS, SPLIT>& dec,
                                     int g0, Acc dtt, Acc dx,
                                     const Acc* b_row) {
  constexpr int V = NG % (16 / sizeof(Acc)) == 0 ? 16 / sizeof(Acc) : 1;
#pragma unroll
  for (int s0 = 0; s0 < NG; s0 += V) {
    Acc bv[V];
    load_row<Acc, V>(bv, b_row + g0 + s0);
#pragma unroll
    for (int v = 0; v < V; ++v)
      h[s0 + v] = state_step(xp(dtt * dec[g0 + s0 + v]), h[s0 + v], dx,
                             bv[v]);
  }
}

template <typename T, typename Acc, int NS>
__global__ void __launch_bounds__(LANES * WARPS, 1)
scan_bwd_f64_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const T* __restrict__ a, const T* __restrict__ d_skip,
                const T* __restrict__ dy, const Acc* __restrict__ h_seg,
                const Acc* __restrict__ dh_last, T* __restrict__ dx,
                T* __restrict__ ddt, Acc* __restrict__ records,
                unsigned* __restrict__ flags, Acc* __restrict__ pb,
                Acc* __restrict__ pc, Acc* __restrict__ pa,
                Acc* __restrict__ pd, int64_t len, int inner, int n,
                int64_t chunks, int tiles, int64_t batch, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_vid;
  constexpr int SLOT = (NS + 1) * LANES;
  constexpr int NG = pass_states(NS);
  constexpr bool SPLIT = NG < NS;
  constexpr int V = NG % (16 / sizeof(Acc)) == 0 ? 16 / sizeof(Acc) : 1;
  constexpr int K = MINI_STEPS;
  constexpr int CKS = SUB / K;                   // mini-blocks a segment
  const int tid = threadIdx.x;
  const int lane = tid & (LANES - 1);
  const int warp = tid / LANES;

  // the chunk index from the counter, the last chunk first: every block
  // this one waits on took its index earlier and has started
  if (tid == 0) s_vid = atomicAdd(flags, 1u);
  __syncthreads();
  const unsigned vid = s_vid;
  const unsigned rows = (unsigned)batch * (unsigned)tiles;
  const int64_t cr = vid / rows;                 // counted from the last
  const int64_t c = chunks - 1 - cr;
  const int64_t b = (vid % rows) / (unsigned)tiles;
  const int tile = (int)((vid % rows) % (unsigned)tiles);
  const int64_t t0 = c * LC;
  const int i = tile * LANES + lane;
  const bool live = i < inner;

  Acc* comb = reinterpret_cast<Acc*>(smem);      // WARPS + 2 (+ 1) slots
  T* xs = reinterpret_cast<T*>(comb + (WARPS + 2 + SPLIT) * SLOT);
  T* dts = xs + LC * LANES;
  T* dys = dts + LC * LANES;
  Acc* bs = reinterpret_cast<Acc*>(dys + LC * LANES);
  Acc* cs = bs + LC * NS;
  Acc* ckpt = cs + LC * NS;                      // WARPS x KEPT x NG x 32
  Acc* sums = ckpt + WARPS * KEPT * NG * LANES;  // with SPLIT: 2 x LC x 32

  const int64_t row0 = b * len * inner;
  stage_rows<T>(xs, x + row0, t0, len, tile * LANES, inner, vec, tid);
  stage_rows<T>(dts, dt + row0, t0, len, tile * LANES, inner, vec, tid);
  stage_rows<T>(dys, dy + row0, t0, len, tile * LANES, inner, vec, tid);
  dmma::commit();
  {
    const T* bsrc = bm + (b * len + t0) * n;
    const T* csrc = cm + (b * len + t0) * n;
    const int64_t steps = len - t0 < LC ? len - t0 : LC;
    for (int e = tid; e < LC * NS; e += LANES * WARPS) {
      const int r = e / NS, s = e - r * NS;
      const bool ok = r < steps && s < n;
      bs[e] = ok ? to_acc<Acc>(bsrc[r * n + s]) : Acc(0);
      cs[e] = ok ? to_acc<Acc>(csrc[r * n + s]) : Acc(0);
    }
  }
  Acc* agg = comb + WARPS * SLOT;
  Acc* carry = agg + SLOT;
  Decays<Acc, NS, SPLIT> dec;
  dec.bind(carry + SLOT + lane);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const Acc v = to_acc<Acc>(a[(int64_t)(live ? i : 0) * n +
                                (s < n ? s : n - 1)]);
    dec.set(s, live && s < n ? scale_decay(-exp(v)) : Acc(0));
  }
  dmma::wait<0>();
  __syncthreads();

  // walk 1: the adjoint over this warp's SUB steps, back from 0
  const int r0 = warp * SUB;
#pragma unroll
  for (int g0 = 0; g0 < NS; g0 += NG) {
    Acc u[NG], S = Acc(0);
#pragma unroll
    for (int s = 0; s < NG; ++s) u[s] = Acc(0);
#pragma unroll 2
    for (int r = r0 + SUB - 1; r >= r0; --r) {
      const Acc dtt = to_acc<Acc>(dts[r * LANES + lane]);
      const Acc dyt = to_acc<Acc>(dys[r * LANES + lane]);
      S += dtt;
#pragma unroll
      for (int s0 = 0; s0 < NG; s0 += V) {
        Acc cv[V];
        load_row<Acc, V>(cv, cs + r * NS + g0 + s0);
#pragma unroll
        for (int v = 0; v < V; ++v)
          u[s0 + v] = xp(dtt * dec[g0 + s0 + v]) * (u[s0 + v] + dyt * cv[v]);
      }
    }
    Acc* mine = comb + warp * SLOT;
    if (g0 == 0) mine[lane] = S;
#pragma unroll
    for (int s = 0; s < NG; ++s) mine[(1 + g0 + s) * LANES + lane] = u[s];
  }
  __syncthreads();

  // warp 0: the chunk's aggregate, the look-back over the later chunks,
  // the publishing (the forward's, with chunks counted from the last)
  if (warp == 0) {
    // fold the warps from the last: each slot keeps its exclusive suffix
#pragma unroll
    for (int k = 0; k <= NS; ++k) agg[k * LANES + lane] = Acc(0);
    for (int w = WARPS - 1; w >= 0; --w) {
      Acc* slot = comb + w * SLOT;
      const Acc sw = slot[lane];
      slot[lane] = agg[lane];
      agg[lane] += sw;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        const Acc gw = slot[k];
        slot[k] = agg[k];
        agg[k] = xp(sw * dec[s]) * agg[k] + gw;
      }
    }

    const int64_t ld = (int64_t)tiles * LANES;
    const int64_t rec_size = (NS + 1) * ld;
    const Acc* recs = records + b * chunks * rec_size + i;
    Acc* rec = records + (b * chunks + cr) * rec_size + i;
    unsigned* flag = flags + 1 + (b * tiles + tile) * chunks;
    const bool ends_group = cr % GROUP == GROUP - 1;
    if (cr + 1 < chunks && !ends_group) {
#pragma unroll
      for (int k = 0; k <= NS; ++k) rec[k * ld] = agg[k * LANES + lane];
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flag + cr, 1u);
    }

    // the adjoint entering chunk cr: P(g - 1) (dh_L for g = 0) carried
    // back over the aggregates of chunks g .. cr - 1
    const int64_t g = cr - cr % GROUP;
    if (lane < cr - g) {
      while (load_acquire(flag + g + lane) == 0) {
      }
    }
    __syncwarp();
    Acc sum_s = Acc(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) carry[(1 + s) * LANES + lane] = Acc(0);
    for (int64_t j = g; j < cr; ++j) {
      const Acc* rj = recs + j * rec_size;
      const Acc sj = __ldcg(rj);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        carry[k] = xp(sj * dec[s]) * carry[k] + __ldcg(rj + (1 + s) * ld);
      }
      sum_s += sj;
    }
    if (g > 0) {
      if (lane == 0) {
        while (load_acquire(flag + g - 1) == 0) {
        }
      }
      __syncwarp();
      const Acc* p = recs + (g - 1) * rec_size;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        carry[k] = xp(sum_s * dec[s]) * __ldcg(p + (1 + s) * ld) + carry[k];
      }
    } else if (dh_last != nullptr && live) {
      const Acc* dh = dh_last + (b * inner + i) * n;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        const Acc v = dh[s < n ? s : n - 1];
        if (s < n) carry[k] = xp(sum_s * dec[s]) * v + carry[k];
      }
    }
    if (cr + 1 < chunks && ends_group) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        rec[(1 + s) * ld] = xp(agg[lane] * dec[s]) * carry[k] + agg[k];
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flag + cr, 1u);
    }
  }
  __syncthreads();

  // walks 2 and 3, pass by pass. The segment's entry state of state s
  // (0 for an idle lane or a padded state, read at an address inside
  // h_seg either way: a guarded load may still be issued)
  const Acc* hseg = h_seg + ((b * chunks + c) * WARPS + warp) * n * inner +
                    (live ? i : 0);
  auto entry = [&](int s) {
    const Acc v = hseg[(int64_t)(s < n ? s : n - 1) * inner];
    return live && s < n ? v : Acc(0);
  };
  Acc* ck = ckpt + warp * KEPT * NG * LANES + lane;
  const Acc dskip = live ? to_acc<Acc>(d_skip[i]) : Acc(0);
  T* dxb = dx + (b * len + t0) * inner + i;
  T* ddtb = ddt + (b * len + t0) * inner + i;
  const int64_t bc_at = (int64_t)tile * batch * len * n + (b * len + t0) * n;
  const int per = LANES / NG;                    // lanes holding a state
  const int end = len - t0 < r0 + SUB ? (int)(len - t0) : r0 + SUB;
  Acc dd = Acc(0);
#pragma unroll
  for (int g0 = 0; g0 < NS; g0 += NG) {
    // the adjoint entering the segment, and its entry state
    const Acc* mine = comb + warp * SLOT;
    Acc u[NG], h[NG];
#pragma unroll
    for (int s = 0; s < NG; ++s) {
      u[s] = xp(mine[lane] * dec[g0 + s]) *
                 carry[(1 + g0 + s) * LANES + lane] +
             mine[(1 + g0 + s) * LANES + lane];
      h[s] = entry(g0 + s);
    }
    // walk 2: the state at the start of each mini-block after the first
#pragma unroll 1
    for (int m = 1; m < CKS; ++m) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = r0 + (m - 1) * K + k;
        const Acc dtt = to_acc<Acc>(dts[r * LANES + lane]);
        step<Acc, NS, SPLIT, NG>(h, dec, g0, dtt,
                                 dtt * to_acc<Acc>(xs[r * LANES + lane]),
                                 bs + r * NS);
      }
#pragma unroll
      for (int s = 0; s < NG; ++s) ck[((m - 1) * NG + s) * LANES] = h[s];
    }
    // walk 3: back over the mini-blocks
    Acc da_acc[NG];
#pragma unroll
    for (int s = 0; s < NG; ++s) da_acc[s] = Acc(0);
#pragma unroll 1
    for (int m = CKS - 1; m >= 0; --m) {
      Acc hb[K][NG];                             // h_{t-1} of its K steps
#pragma unroll
      for (int s = 0; s < NG; ++s)
        hb[0][s] = m > 0 ? ck[((m - 1) * NG + s) * LANES] : entry(g0 + s);
#pragma unroll
      for (int k = 1; k < K; ++k) {
        const int r = r0 + m * K + k - 1;
        const Acc dtt = to_acc<Acc>(dts[r * LANES + lane]);
#pragma unroll
        for (int s = 0; s < NG; ++s) hb[k][s] = hb[k - 1][s];
        step<Acc, NS, SPLIT, NG>(hb[k], dec, g0, dtt,
                                 dtt * to_acc<Acc>(xs[r * LANES + lane]),
                                 bs + r * NS);
      }
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const int r = r0 + m * K + k;
        const Acc dtt = to_acc<Acc>(dts[r * LANES + lane]);
        const Acc xt = to_acc<Acc>(xs[r * LANES + lane]);
        const Acc dyt = to_acc<Acc>(dys[r * LANES + lane]);
        const Acc dtx = dtt * xt;
        Acc gb = Acc(0), gq = Acc(0), vb[NG], vc[NG];
#pragma unroll
        for (int s0 = 0; s0 < NG; s0 += V) {
          Acc bv[V], cv[V];
          load_row<Acc, V>(bv, bs + r * NS + g0 + s0);
          load_row<Acc, V>(cv, cs + r * NS + g0 + s0);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int s = s0 + v;
            const Acc ab = xp(dtt * dec[g0 + s]);
            const Acc q = ab * hb[k][s];         // dA_t h_{t-1}
            const Acc gt = u[s] + dyt * cv[v];   // g_t
            const Acc z = gt * q;
            gb += gt * bv[v];
            gq += z * dec[g0 + s];
            da_acc[s] += z * dtt;
            vb[s] = gt * dtx;
            vc[s] = dyt * (q + dtx * bv[v]);     // dy_t h_t
            u[s] = ab * gt;                      // on to t - 1
          }
        }
        const Acc sb = reduce_scatter<Acc, NG>(vb, lane);
        const Acc sc = reduce_scatter<Acc, NG>(vc, lane);
        const int st = g0 + lane / per;
        if (lane % per == 0 && st < n && r < end) {
          pb[bc_at + r * n + st] = sb;
          pc[bc_at + r * n + st] = sc;
        }
        if (SPLIT) {
          Acc* gbs = sums + r * LANES + lane;
          Acc* gqs = gbs + LC * LANES;
          if (g0 > 0) {
            gb += *gbs;
            gq += *gqs;
          }
          if (g0 + NG < NS) {
            *gbs = gb;
            *gqs = gq;
          }
        }
        if (g0 + NG >= NS && live && r < end) {
          dxb[(int64_t)r * inner] = from_acc<T, Acc>(dskip * dyt + dtt * gb);
          ddtb[(int64_t)r * inner] =
              from_acc<T, Acc>(xt * gb + gq * unscale(Acc(0)));
        }
        if (g0 == 0) dd += dyt * xt;
      }
    }
    // this pass's da and (first pass) dd_skip, summed over the warps in
    // order, through the mini-blocks' states (each warp's own, now free)
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NG; ++s) ck[s * LANES] = da_acc[s];
    if (g0 == 0) ck[NG * LANES] = dd;
    __syncthreads();
    const int64_t bc = b * chunks + c;
    for (int e = tid; e < (NG + (g0 == 0)) * LANES; e += LANES * WARPS) {
      const int s = e / LANES, l = e - s * LANES;
      const int ii = tile * LANES + l;
      Acc sum = Acc(0);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += ckpt[w * KEPT * NG * LANES + e];
      if (ii >= inner) continue;
      if (s < NG) {
        if (g0 + s < n)
          pa[(bc * n + g0 + s) * inner + ii] =
              -exp(to_acc<Acc>(a[(int64_t)ii * n + g0 + s])) * sum;
      } else {
        pd[bc * inner + ii] = sum;
      }
    }
    __syncthreads();
  }
}

// out[o(j)] = sum over r < rows of p[r * cols + j], in order of r, cast to
// T; o(j) = j, or with transpose the (inner, n) place of the (n, inner) j
template <typename T, typename Acc>
__global__ void __launch_bounds__(256)
sum_kernel(const Acc* __restrict__ p, T* __restrict__ out, int64_t rows,
           int64_t cols, int64_t inner, int64_t n, int transpose) {
  for (int64_t j = (int64_t)blockIdx.x * 256 + threadIdx.x; j < cols;
       j += (int64_t)gridDim.x * 256) {
    Acc sum = Acc(0);
#pragma unroll 4
    for (int64_t r = 0; r < rows; ++r) sum += p[r * cols + j];
    out[transpose ? (j % inner) * n + j / inner : j] = from_acc<T, Acc>(sum);
  }
}

template <typename T, typename Acc>
int sum_rows(const Acc* p, void* out, int64_t rows, int64_t cols,
             int64_t inner, int64_t n, int transpose, cudaStream_t stream) {
  const int64_t blocks = (cols + 255) / 256;
  sum_kernel<T, Acc><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                       stream>>>(p, static_cast<T*>(out), rows, cols, inner,
                                 n, transpose);
  return (int)cudaGetLastError();
}

// the partials of a launch summed into the gradients: dB, dC over the
// tiles; da (into a's (I, N) layout), dd_skip over the (batch, chunk)
// blocks
template <typename T, typename Acc>
int sum_partials(const Shape& sh, char* w, void* const* out, int64_t batch,
                 int64_t len, int64_t inner, int64_t n, cudaStream_t stream) {
  const int64_t blc = batch * sh.chunks;
  int e;
  if ((e = sum_rows<T, Acc>(reinterpret_cast<Acc*>(w + sh.pb_at), out[2],
                            sh.tiles, batch * len * n, 1, 1, 0, stream)) ||
      (e = sum_rows<T, Acc>(reinterpret_cast<Acc*>(w + sh.pc_at), out[3],
                            sh.tiles, batch * len * n, 1, 1, 0, stream)) ||
      (e = sum_rows<T, Acc>(reinterpret_cast<Acc*>(w + sh.pa_at), out[4],
                            blc, n * inner, inner, n, 1, stream)))
    return e;
  return sum_rows<T, Acc>(reinterpret_cast<Acc*>(w + sh.pd_at), out[5], blc,
                          inner, 1, 1, 0, stream);
}

template <typename T, typename Acc, int NS>
int launch_f64(const void* const* in, void* const* out, void* work,
               int64_t batch, int64_t len, int64_t inner, int64_t n,
               cudaStream_t stream) {
  const Shape sh = shape_of(batch, len, inner, n, sizeof(Acc), LANES, 1);
  const int64_t smem = smem_bytes<T, Acc>(n);
  auto kernel = scan_bwd_f64_kernel<T, Acc, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies when every 32-channel row segment starts on 16 bytes
  const bool vec = (inner * (int64_t)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in[0]) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in[1]) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in[6]) % 16 == 0;
  char* w = static_cast<char*>(work);
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)sh.flag_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)sh.blocks, (unsigned)(WARPS * LANES), (size_t)smem,
           stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const Acc*>(in[7]),
      static_cast<const Acc*>(in[8]), static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), reinterpret_cast<Acc*>(w + sh.records_at),
      reinterpret_cast<unsigned*>(w), reinterpret_cast<Acc*>(w + sh.pb_at),
      reinterpret_cast<Acc*>(w + sh.pc_at),
      reinterpret_cast<Acc*>(w + sh.pa_at),
      reinterpret_cast<Acc*>(w + sh.pd_at), len, (int)inner, (int)n,
      sh.chunks, (int)sh.tiles, batch, vec);
  const int e = (int)cudaGetLastError();
  return e ? e : sum_partials<T, Acc>(sh, w, out, batch, len, inner, n,
                                      stream);
}

// ---------------------------------------------------------------------
// float32 and bf16: scan_bwd_kernel

constexpr int WCH = 16;                 // channels a warp
constexpr int BWARPS = 8;               // warps a block
constexpr int BCH = WCH * BWARPS;       // channels a block
constexpr int SEGS = LC / SUB;          // the forward's segments a chunk

// A lane holds two channels (a pair: lane bits 4 .. 2) and a quarter of
// their states (lane bits 1, 0): lane_states of them (N = 1: one each,
// three quarters padded)
template <int NS>
__host__ __device__ constexpr int lane_states() {
  return NS >= 4 ? NS / 4 : 1;
}
// steps of a mini-block: walk 3 holds each step's exps and states of the
// lane's 2 x lane_states elements, 2 K - 1 of them, in registers
template <int NS>
__host__ __device__ constexpr int mini_block() {
  return NS <= 4 ? 4 : 2;
}
// blocks an SM: two (at most 128 registers) up to 16 states
template <int NS>
__host__ __device__ constexpr int min_blocks32() {
  return NS <= 16 ? 2 : 1;
}
// a warp's work area, in floats: walk 1's staged dt and dy (2 x LC x 16),
// then walks 2 and 3's states at the start of each mini-block of a
// segment (SUB / K of 2 lane_states x 32)
template <int NS>
__host__ __device__ constexpr int64_t warp_area() {
  constexpr int64_t states =
      (int64_t)(SUB / mini_block<NS>()) * 2 * lane_states<NS>() * LANES;
  return states > 2 * LC * WCH ? states : 2 * LC * WCH;
}

// dynamic shared memory, in floats: the chunk's B and C rows (LC x 4
// lane_states, padded states 0); each warp's area; each warp's staged
// dt, x and dy of a segment (3 x SUB x 16); the dB/dC slots of a segment
// (BWARPS x SUB steps x 2 x 4 lane_states)
template <int NS>
__host__ __device__ constexpr int64_t smem32_floats() {
  constexpr int NC = 4 * lane_states<NS>();
  return 2 * LC * NC + BWARPS * warp_area<NS>() + BWARPS * 3 * SUB * WCH +
         BWARPS * SUB * 2 * NC;
}

// the lane's S values of a staged row (from its quarter)
template <int S>
__device__ __forceinline__ void lane_row(float (&dst)[S], const float* row) {
  if constexpr (S >= 4) {
#pragma unroll
    for (int g = 0; g < S / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(row + 4 * g);
      dst[4 * g] = v.x;
      dst[4 * g + 1] = v.y;
      dst[4 * g + 2] = v.z;
      dst[4 * g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < S; ++p) dst[p] = row[p];
  }
}

// two neighbouring staged values (a pair's), as floats
__device__ __forceinline__ float2 pair_of(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_of(const __nv_bfloat16* p) {
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}

// A warp stages ROWS rows of its 16 channels of a (len, inner) slice,
// from src (row 0, the warp's first channel) into dst (ROWS x 16), zero
// past valid rows and past inner: cp.async, 16 bytes a copy where every
// row segment is 16-byte aligned (vec), else 4 (float) or element loads
// (bf16)
template <typename T, int ROWS>
__device__ __forceinline__ void stage_warp(T* dst, const T* src, int valid,
                                           int64_t inner, int i0, bool vec,
                                           int lane) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);          // values a copy
    constexpr int CPR = WCH / PER;               // copies a row
    for (int e = lane; e < ROWS * CPR; e += LANES) {
      const int r = e / CPR, c = (e - r * CPR) * PER;
      const bool ok = r < valid && i0 + c < inner;
      dmma::copy16(dst + r * WCH + c, ok ? src + (int64_t)r * inner + c : src,
                   ok);
    }
  } else {
    for (int e = lane; e < ROWS * WCH; e += LANES) {
      const int r = e / WCH, c = e - r * WCH;
      const bool ok = r < valid && i0 + c < inner;
      if constexpr (sizeof(T) == 4)
        copy4(dst + e, ok ? src + (int64_t)r * inner + c : src, ok);
      else
        dst[e] = ok ? src[(int64_t)r * inner + c] : from_acc<T, float>(0.0f);
    }
  }
}

// the reduce-scatter of a lane's S values (one a state, summed over its
// pair) over the 8 pairs of a quarter (lane bits 4 .. 2), in a fixed
// order. Level L pairs lanes across bit 4 - L, the lane's bit keeping the
// upper half; once one value is left, the last levels add whole. A lane
// ends with v[0], the sum over the warp's 16 channels of the state
// owner() names. One template a level, every loop of a constant trip
// count.
template <int L, int V>
__device__ __forceinline__ void scatter_level(float (&v)[V], int lane) {
  if constexpr (L < 3) {
    constexpr int live = V >> L;
    constexpr int mask = 16 >> L;
    if constexpr (live >= 2) {
      constexpr int half = live / 2;
      const bool up = lane & mask;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float lo = v[j], hi = v[j + half];
        v[j] = (up ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, up ? lo : hi, mask);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
    }
    scatter_level<L + 1, V>(v, lane);
  }
}

// the state whose sum a lane holds after the reduce-scatter
template <int NS>
__device__ __forceinline__ int owner(int lane, int sbase) {
  constexpr int S = lane_states<NS>();
  int j = 0;
#pragma unroll
  for (int L = 0; L < 3; ++L)
    if ((S >> L) >= 2) j += ((lane >> (4 - L)) & 1) * ((S >> L) / 2);
  return sbase + j;
}

// A block: 8 warps, 128 channels of one (batch, chunk); warp w channels
// tile * 128 + 16 w + 2 (lane >> 2) + c (c = 0, 1), lane quarter lane & 3
// (the states quarter * S + p, p < S); a lane's element e = c * S + p
template <typename T, int NS>
__global__ void __launch_bounds__(LANES * BWARPS, min_blocks32<NS>())
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const T* __restrict__ a, const T* __restrict__ d_skip,
                const T* __restrict__ dy, const float* __restrict__ h_seg,
                const float* __restrict__ dh_last, T* __restrict__ dx,
                T* __restrict__ ddt, float* __restrict__ records,
                unsigned* __restrict__ flags, float* __restrict__ pb,
                float* __restrict__ pc, float* __restrict__ pa,
                float* __restrict__ pd, int64_t len, int inner, int n,
                int64_t chunks, int tiles, int64_t batch, bool vec) {
  constexpr int S = lane_states<NS>();
  constexpr int E = 2 * S;               // a lane's elements
  constexpr int NC = 4 * S;              // columns of a staged row
  constexpr int K = mini_block<NS>();
  constexpr int CKS = SUB / K;           // mini-blocks a segment
  constexpr int XS = 2 * NC;             // dB/dC slots a warp and step
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_vid;
  const int tid = threadIdx.x;
  const int lane = tid & (LANES - 1);
  const int warp = tid / LANES;
  const int quarter = lane & 3;
  const int cp = 2 * (lane >> 2);                // the pair's first channel
  const int crow = (lane >> 1) & 1;              // the channel whose dx or ddt
  const bool writes_dx = (lane & 1) == 0;        //   the lane writes

  // the chunk index from the counter, the last chunk first: every block
  // this one waits on took its index earlier and has started
  if (tid == 0) s_vid = atomicAdd(flags, 1u);
  __syncthreads();
  const unsigned vid = s_vid;
  const unsigned rows = (unsigned)batch * (unsigned)tiles;
  const int64_t cr = vid / rows;                 // counted from the last
  const int64_t c = chunks - 1 - cr;
  const int64_t b = (vid % rows) / (unsigned)tiles;
  const int tile = (int)((vid % rows) % (unsigned)tiles);
  const int64_t t0 = c * LC;
  const int steps = len - t0 < LC ? (int)(len - t0) : LC;
  const int i0 = tile * BCH + warp * WCH;        // the warp's first channel
  const int sbase = quarter * S;
  auto state = [&](int p) { return sbase + p; };
  auto chan = [&](int ch) { return i0 + cp + ch; };

  float* bs = reinterpret_cast<float*>(smem);    // (LC, NC)
  float* cs = bs + LC * NC;                      // (LC, NC)
  float* wa = cs + LC * NC + warp * warp_area<NS>();   // this warp's area
  T* sg = reinterpret_cast<T*>(cs + LC * NC + BWARPS * warp_area<NS>() +
                               warp * 3 * SUB * WCH);  // (3, SUB, 16)
  float* xb = cs + LC * NC + BWARPS * (warp_area<NS>() + 3 * SUB * WCH);
  float* xw = xb + warp * SUB * XS;              // this warp's slots
  // walk 1's dt and dy of the chunk (2, LC, 16) into the warp's area
  const int64_t row0 = (b * len + t0) * inner + i0;
  T* w1 = reinterpret_cast<T*>(wa);
  stage_warp<T, LC>(w1, dt + row0, steps, inner, i0, vec, lane);
  stage_warp<T, LC>(w1 + LC * WCH, dy + row0, steps, inner, i0, vec, lane);
  dmma::commit();
  {
    const T* bsrc = bm + (b * len + t0) * n;
    const T* csrc = cm + (b * len + t0) * n;
    for (int e = tid; e < LC * NC; e += LANES * BWARPS) {
      const int r = e / NC, s = e - r * NC;
      const bool ok = r < steps && s < n;
      bs[e] = ok ? to_acc<float>(bsrc[r * n + s]) : 0.0f;
      cs[e] = ok ? to_acc<float>(csrc[r * n + s]) : 0.0f;
    }
  }
  float dec[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int ch = chan(e / S), s = state(e % S);
    const bool ok = ch < inner && s < n;
    const float v = to_acc<float>(
        a[(int64_t)(ch < inner ? ch : 0) * n + (s < n ? s : n - 1)]);
    dec[e] = ok ? scale_decay(-exp(v)) : 0.0f;
  }
  const int irow = chan(crow);
  const float dskip = irow < inner ? to_acc<float>(d_skip[irow]) : 0.0f;
  dmma::wait<0>();
  __syncthreads();

  // walk 1: the adjoint over the chunk, back from 0, and each channel's
  // sum of dt (the steps past len read as 0: the identity)
  float u[E], ssum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < E; ++e) u[e] = 0.0f;
#pragma unroll 4
  for (int r = LC - 1; r >= 0; --r) {
    const float2 dt2 = pair_of(w1 + r * WCH + cp);
    const float2 dy2 = pair_of(w1 + (LC + r) * WCH + cp);
    float cv[S];
    lane_row<S>(cv, cs + r * NC + sbase);
    ssum[0] += dt2.x;
    ssum[1] += dt2.y;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float dtt = e < S ? dt2.x : dt2.y, dyt = e < S ? dy2.x : dy2.y;
      u[e] = xp(dtt * dec[e]) * (u[e] + dyt * cv[e % S]);
    }
  }
  __syncwarp();

  // the last segment's dt, x, dy and the forward's state entering it,
  // staged while the warp looks back (the area's states start with it)
  float* cw = wa + lane;                         // [m][e] x 32
  auto stage_segment = [&](int seg) {
    const int r0 = seg * SUB;
    const int64_t off = row0 + (int64_t)r0 * inner;
    stage_warp<T, SUB>(sg, dt + off, steps - r0, inner, i0, vec, lane);
    stage_warp<T, SUB>(sg + SUB * WCH, x + off, steps - r0, inner, i0, vec,
                       lane);
    stage_warp<T, SUB>(sg + 2 * SUB * WCH, dy + off, steps - r0, inner, i0,
                       vec, lane);
    // (0 for an idle channel or a padded state, read at an address inside
    // h_seg either way)
    const float* he = h_seg + ((b * chunks + c) * SEGS + seg) * n * inner;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int ch = chan(e / S), s = state(e % S);
      copy4(cw + e * LANES,
            he + (int64_t)(s < n ? s : n - 1) * inner + (ch < inner ? ch : 0),
            ch < inner && s < n);
    }
    dmma::commit();
  };
  stage_segment(SEGS - 1);

  // this warp's look-back over the later chunks (the forward's, with
  // chunks counted from the last): publish the aggregate (S, u), or for a
  // group's last chunk the adjoint entering the chunk before it
  {
    const int64_t ld_ = (int64_t)tiles * BCH;
    const int64_t rec_size = (NS + 1) * ld_;
    const float* recs = records + b * chunks * rec_size + i0 + cp;
    float* rec = records + (b * chunks + cr) * rec_size + i0 + cp;
    unsigned* flag =
        flags + 1 + ((b * tiles + tile) * BWARPS + warp) * chunks;
    auto row = [&](int e) {                     // a record's row offset
      const int s = state(e % S) < NS ? state(e % S) : NS - 1;
      return (1 + s) * ld_ + e / S;
    };
    const bool ends_group = cr % GROUP == GROUP - 1;
    if (cr + 1 < chunks && !ends_group) {
      if (quarter == 0) {
        rec[0] = ssum[0];
        rec[1] = ssum[1];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (state(e % S) < NS) rec[row(e)] = u[e];
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flag + cr, 1u);
    }
    const int64_t g = cr - cr % GROUP;
    if (lane < cr - g) {
      while (load_acquire(flag + g + lane) == 0) {
      }
    }
    __syncwarp();
    float carry[E], sum_s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < E; ++e) carry[e] = 0.0f;
    for (int64_t j = g; j < cr; ++j) {
      const float* rj = recs + j * rec_size;
      const float sj[2] = {__ldcg(rj), __ldcg(rj + 1)};
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = __ldcg(rj + row(e));
        carry[e] = xp(sj[e / S] * dec[e]) * carry[e] +
                   (state(e % S) < NS ? v : 0.0f);
      }
      sum_s[0] += sj[0];
      sum_s[1] += sj[1];
    }
    if (g > 0) {
      if (lane == 0) {
        while (load_acquire(flag + g - 1) == 0) {
        }
      }
      __syncwarp();
      const float* pr = recs + (g - 1) * rec_size;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = __ldcg(pr + row(e));
        carry[e] = xp(sum_s[e / S] * dec[e]) *
                       (state(e % S) < NS ? v : 0.0f) +
                   carry[e];
      }
    } else if (dh_last != nullptr) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int ch = chan(e / S), s = state(e % S);
        const float v = dh_last[(b * inner + (ch < inner ? ch : 0)) * n +
                                (s < n ? s : n - 1)];
        if (ch < inner && s < n)
          carry[e] = xp(sum_s[e / S] * dec[e]) * v + carry[e];
      }
    }
    if (cr + 1 < chunks && ends_group) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (state(e % S) < NS)
          rec[row(e)] = xp(ssum[e / S] * dec[e]) * carry[e] + u[e];
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flag + cr, 1u);
    }
    // the adjoint entering the chunk's last step
#pragma unroll
    for (int e = 0; e < E; ++e) u[e] = carry[e];
  }

  // walks 2 and 3, segment by segment from the last
  const float un = unscale(0.0f);
  const int own = owner<NS>(lane, sbase);        // the state the lane sums
  float da[E], dd = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) da[e] = 0.0f;
  // a staged step's dt (q = 0), x (1) or dy (2) of the lane's pair
  auto at = [&](int q, int k) {
    return pair_of(sg + (q * SUB + k) * WCH + cp);
  };
#pragma unroll 1
  for (int seg = SEGS - 1; seg >= 0; --seg) {
    const int r0 = seg * SUB;
    dmma::wait<0>();
    __syncwarp();
    // walk 2: from the forward's state entering the segment, the state
    // at the start of each mini-block after the first
    {
      float h[E];
#pragma unroll
      for (int e = 0; e < E; ++e) h[e] = cw[e * LANES];
#pragma unroll 1
      for (int m = 0; m + 1 < CKS; ++m) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = m * K + k;
          float bv[S];
          lane_row<S>(bv, bs + (r0 + j) * NC + sbase);
          const float2 dt2 = at(0, j), x2 = at(1, j);
          const float dx0 = dt2.x * x2.x, dx1 = dt2.y * x2.y;
#pragma unroll
          for (int e = 0; e < E; ++e)
            h[e] = state_step(xp((e < S ? dt2.x : dt2.y) * dec[e]), h[e],
                              e < S ? dx0 : dx1, bv[e % S]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) cw[((m + 1) * E + e) * LANES] = h[e];
      }
    }
    // walk 3: back over the mini-blocks
#pragma unroll 1
    for (int m = CKS - 1; m >= 0; --m) {
      const int jb = m * K;                      // its first step
      // forward over the mini-block from its first state: each step's
      // dA_t and h_t (kept for the adjoint as h_{t-1} of the next step),
      // and dC (dy_t h_t over the warp's 16 channels, into the step's
      // slot)
      float dA[K][E], hk[K > 1 ? K - 1 : 1][E];
      {
        float h[E];
#pragma unroll
        for (int e = 0; e < E; ++e) h[e] = cw[(m * E + e) * LANES];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float bv[S], vc[S];
          lane_row<S>(bv, bs + (r0 + jb + k) * NC + sbase);
          const float2 dt2 = at(0, jb + k), x2 = at(1, jb + k);
          const float2 dy2 = at(2, jb + k);
          const float dx0 = dt2.x * x2.x, dx1 = dt2.y * x2.y;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dA[k][e] = xp((e < S ? dt2.x : dt2.y) * dec[e]);
            h[e] = state_step(dA[k][e], h[e], e < S ? dx0 : dx1, bv[e % S]);
            if (k + 1 < K) hk[k][e] = h[e];
          }
#pragma unroll
          for (int p = 0; p < S; ++p) vc[p] = dy2.x * h[p] + dy2.y * h[S + p];
          scatter_level<0, S>(vc, lane);
          xw[(jb + k) * XS + NC + own] = vc[0];
        }
      }
      // the adjoint back over them
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const int j = jb + k, r = r0 + j;
        float bv[S], cv[S], vb[S];
        lane_row<S>(bv, bs + r * NC + sbase);
        lane_row<S>(cv, cs + r * NC + sbase);
        const float2 dt2 = at(0, j), x2 = at(1, j), dy2 = at(2, j);
        const float dtx0 = dt2.x * x2.x, dtx1 = dt2.y * x2.y;
        float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // gb, gq of each channel
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int ch = e / S, p = e % S;
          const float hp = k > 0 ? hk[k - 1][e] : cw[(m * E + e) * LANES];
          const float gt = u[e] + (ch ? dy2.y : dy2.x) * cv[p];   // g_t
          rs[2 * ch] += gt * bv[p];
          u[e] = dA[k][e] * gt;                     // on to t - 1
          const float w = u[e] * hp;                // g_t dA_t h_{t-1}
          rs[2 * ch + 1] += w * dec[e];
          da[e] += w * (ch ? dt2.y : dt2.x);
          if (ch == 0)
            vb[p] = gt * dtx0;                      // dB's, over the pair
          else
            vb[p] += gt * dtx1;
        }
        // dx and ddt: the channel's quarters added; (gb, gq) of channel
        // crow to the lane, which writes dx or ddt
        {
          const bool up = lane & 2;
          const float gb = (up ? rs[2] : rs[0]) +
                           __shfl_xor_sync(0xffffffffu, up ? rs[0] : rs[2], 2);
          const float gq = (up ? rs[3] : rs[1]) +
                           __shfl_xor_sync(0xffffffffu, up ? rs[1] : rs[3], 2);
          const float gbt = gb + __shfl_xor_sync(0xffffffffu, gb, 1);
          const float gqt = gq + __shfl_xor_sync(0xffffffffu, gq, 1);
          const float dtt = crow ? dt2.y : dt2.x, xt = crow ? x2.y : x2.x;
          const float dyt = crow ? dy2.y : dy2.x;
          // one store without a branch: a branch here put a convergence
          // check before the next shuffles, which no instruction crossed
          T* out = (writes_dx ? dx : ddt) + row0 + (int64_t)r * inner + cp +
                   crow;
          const float val =
              writes_dx ? dskip * dyt + dtt * gbt : xt * gbt + gqt * un;
          if (irow < inner && r < steps) *out = from_acc<T, float>(val);
          dd += writes_dx ? dyt * xt : 0.0f;
        }
        // dB over the warp's 16 channels, into this step's slot
        scatter_level<0, S>(vb, lane);
        xw[j * XS + own] = vb[0];
      }
    }
    // the next segment's staging, behind the block's sums
    __syncwarp();
    if (seg > 0) stage_segment(seg - 1);
    // the block's sums of the segment: each (step, dB or dC, state) over
    // the 8 warps in order, one partial of the 128-channel tile
    __syncthreads();
    for (int e = tid; e < SUB * XS; e += LANES * BWARPS) {
      const int k = e / XS, qs = e - k * XS, q = qs / NC, s = qs - q * NC;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < BWARPS; ++w) sum += xb[w * SUB * XS + e];
      const int r = r0 + k;
      if (r < steps && s < n)
        (q ? pc : pb)[((int64_t)tile * batch * len + b * len + t0 + r) * n +
                      s] = sum;
    }
    __syncthreads();
  }
  // da (times A) and dd_skip of this chunk
  const int64_t bc = b * chunks + c;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int ch = chan(e / S), s = state(e % S);
    if (ch < inner && s < n)
      pa[(bc * n + s) * inner + ch] =
          -exp(to_acc<float>(a[(int64_t)ch * n + s])) * da[e];
  }
  if (writes_dx && irow < inner) pd[bc * inner + irow] = dd;
}

template <typename T, int NS>
int launch32(const void* const* in, void* const* out, void* work,
             int64_t batch, int64_t len, int64_t inner, int64_t n,
             cudaStream_t stream) {
  const Shape sh = shape_of(batch, len, inner, n, 4, BCH, BWARPS);
  const int64_t smem = smem32_floats<NS>() * 4;
  auto kernel = scan_bwd_kernel<T, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies when every 16-channel row segment starts on 16 bytes
  const bool vec = (inner * (int64_t)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in[0]) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in[1]) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in[6]) % 16 == 0;
  char* w = static_cast<char*>(work);
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)sh.flag_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)sh.blocks, (unsigned)(BWARPS * LANES), (size_t)smem,
           stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), reinterpret_cast<float*>(w + sh.records_at),
      reinterpret_cast<unsigned*>(w), reinterpret_cast<float*>(w + sh.pb_at),
      reinterpret_cast<float*>(w + sh.pc_at),
      reinterpret_cast<float*>(w + sh.pa_at),
      reinterpret_cast<float*>(w + sh.pd_at), len, (int)inner, (int)n,
      sh.chunks, (int)sh.tiles, batch, vec);
  const int e = (int)cudaGetLastError();
  return e ? e : sum_partials<T, float>(sh, w, out, batch, len, inner, n,
                                        stream);
}

// the workspace's shape for promote(dtype, float32) of acc_bytes
inline Shape work_shape(int64_t batch, int64_t len, int64_t inner, int64_t n,
                        int64_t acc_bytes) {
  return acc_bytes == 8 ? shape_of(batch, len, inner, n, 8, LANES, 1)
                        : shape_of(batch, len, inner, n, 4, BCH, BWARPS);
}

template <typename T, typename Acc>
int launch(const void* const* in, void* const* out, void* work,
           int64_t batch, int64_t len, int64_t inner, int64_t n,
           void* stream) {
  constexpr bool f64 = sizeof(Acc) == 8;
  const int64_t smem = f64 ? smem_bytes<T, Acc>(n)
                           : (state_size(n) == 32 ? smem32_floats<32>() * 4
                                                  : smem32_floats<16>() * 4);
  if (n < 1 || n > MAX_N || batch < 1 || len < 1 || inner < 1 ||
      inner > (int64_t)1 << 30 || smem > MAX_SMEM || in[7] == nullptr)
    return (int)cudaErrorInvalidValue;
  // block indices and the counter are 32-bit
  if (work_shape(batch, len, inner, n, sizeof(Acc)).blocks >=
      (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void* const*, void* const*, void*, int64_t,
                         int64_t, int64_t, int64_t, cudaStream_t);
  Launch fn;
  if constexpr (f64) {
    switch (state_size(n)) {
      case 1: fn = launch_f64<T, Acc, 1>; break;
      case 4: fn = launch_f64<T, Acc, 4>; break;
      case 16: fn = launch_f64<T, Acc, 16>; break;
      default: fn = launch_f64<T, Acc, 32>; break;
    }
  } else {
    switch (state_size(n)) {
      case 1: fn = launch32<T, 1>; break;
      case 4: fn = launch32<T, 4>; break;
      case 16: fn = launch32<T, 16>; break;
      default: fn = launch32<T, 32>; break;
    }
  }
  return fn(in, out, work, batch, len, inner, n,
            static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

#define SCAN_BWD_ENTRY(NAME, T, ACC)                                         \
  int NAME(const void* x, const void* dt, const void* bm, const void* cm,    \
           const void* a, const void* d_skip, const void* dy,               \
           const void* h_seg, const void* dh_last, void* dx, void* ddt,     \
           void* dbm, void* dcm, void* da, void* dd_skip, void* work,       \
           int64_t batch, int64_t len, int64_t inner, int64_t n,            \
           void* stream) {                                                   \
    const void* in[] = {x, dt, bm, cm, a, d_skip, dy, h_seg, dh_last};      \
    void* out[] = {dx, ddt, dbm, dcm, da, dd_skip};                         \
    return launch<T, ACC>(in, out, work, batch, len, inner, n, stream);     \
  }

SCAN_BWD_ENTRY(mamba_scan_bwd_f64, double, double)
SCAN_BWD_ENTRY(mamba_scan_bwd_f32, float, float)
SCAN_BWD_ENTRY(mamba_scan_bwd_bf16, __nv_bfloat16, float)

// bytes of workspace for one call; acc_bytes is the size of
// promote(dtype, float32)
int64_t mamba_scan_bwd_work_bytes(int64_t batch, int64_t len, int64_t inner,
                                  int64_t n, int64_t acc_bytes) {
  return work_shape(batch, len, inner, n, acc_bytes).bytes;
}

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
