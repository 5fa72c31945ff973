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
// Design: the forward's chained scan run backwards, in one grid, then a
// small kernel that sums the partial reductions in a fixed order.
// * A block owns 32 channels (a lane each) of one batch entry over one
//   chunk of LC = 64 steps, warp w the w-th segment of SUB = 16 steps, as
//   in the forward. It stages its chunk of x, dt and dy (cp.async, 16
//   bytes a copy where aligned) and B and C rows in shared memory.
// * Walk 1 (back): each warp runs the adjoint over its segment from 0: a
//   span of steps maps g to exp(A S) g + g_span (S its sum of dt), the
//   forward's combine. Warp 0 folds the warps from the last, publishes,
//   and looks back over the later chunks exactly as the forward looks
//   back over the earlier ones (blocks take their chunk index from an
//   atomic counter, last chunk first; groups of GROUP chunks; flags with
//   release stores and acquire loads; a fixed fold order, so every call
//   gives the same bits). The adjoint entering the last chunk is dh_L (0
//   without one). Nothing divides by a cumulative decay.
// * Each warp then needs h_{t-1} and g_t together, the one walking
//   forward and the other back. Its segment's entry state is the
//   forward's own (h_seg, written by the forward's walk 2 where a
//   gradient will be asked for: (B, 4 chunks, N, I), 268 MB at the Jamba
//   layer at L = 4096), so the states it recomputes are the forward's.
//   Walk 2 (forward) keeps the state at the start of each mini-block of K
//   steps (4 in float, 2 in double: mini_steps) but the first in shared
//   memory (the
//   first's is the entry state, read again); walk 3 goes back over them,
//   recomputing each one's K states h_{t-1} into registers (K - 1 steps)
//   and then running the adjoint back over them: dx and ddt are written
//   at once, da and dd_skip sum per lane in registers, and dB and dC are
//   reduced over the warp's 32 channels each step by a reduce-scatter of
//   shuffles (log2(32) levels, a state per lane pair).
// * States run in passes of NG (8 in float, 4 in double), N padded to
//   the instantiated NS with B = C = 0 and decay 0. With more than one
//   pass the decays live in shared memory and the sums over n of dx and
//   ddt add up across passes there. Every loop has a constant trip count
//   (a rolled loop indexing a register array put it in local memory).
// * No atomics (the chunk counter is an index, not a sum): dB and dC of
//   each (batch, step) are written per 32-channel tile, da and dd_skip per
//   (batch, chunk), into the workspace; sum_kernel adds each over its
//   tiles or chunks in order and casts to the operand's dtype. At the
//   Jamba layer (B = 1, L = 4096, I = 16384, N = 16, float32) the partials
//   of dB and dC take 268 MB, da's 67 MB, the look-back's records 71 MB.
//
// Bound on an H100 SXM: x, dt, dy read and dx, ddt written once (5 x 268
// MB at the Jamba layer at L = 4096: 0.40 ms at 3.35 TB/s) against one
// exp per (b, t, i, n) (h's step to t and the adjoint's step to t - 1
// share dA_t = exp(dt_t A): 1.07e9 exps on the SFU at 4.2e12 a second,
// 0.26 ms): memory bounds it. This design takes each exp about 3.5 times
// (walk 1, walk 2 without its last mini-block, the K - 1 recomputed
// steps of each mini-block, walk 3), for registers: keeping h for a
// segment's 16 steps would take 256 registers a lane in float32 at N =
// 16, and for the chunk 128 KB of shared memory. It runs 2.96 ms there
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 6), 7.4x the bound;
// its 3.5 exps an element alone would take 0.9 ms at the SFU's rate.
// What holds the rest is not measured (no ncu on that machine): the
// walks' dependent steps and the reduce-scatter's shuffle latency at 12
// warps an SM are the suspects.
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

// steps of a mini-block: walk 3 holds K states of a pass in registers;
// 4 in float (2 took 3.80 ms at the Jamba layer against 2.96,
// kernels/mamba_scan/bwd_ab.py), 2 in double. At 4, nvcc 12.9 (-O3)
// miscompiled the double kernels of one pass (N <= 4): in the PTX, the
// rolled walk 2 addresses its mini-block states from the dt tile's row
// pointer with the offset the states have from the x tile, so they and
// the da store that reuses that address land one tile (16 KB) past their
// place, outside the block's shared memory (0x11000 for 0xd000 at N =
// 1), and the card reports an illegal address. Every index the source
// computes was in bounds when checked on the card, the same source runs
// with walks 2 and 3 unrolled or built with -G, and ptx_check.py finds
// every shared store of each instantiation in its place at these
// constants (and the misplaced ones at K = 4 in double): PERF.md,
// section 6.
template <typename Acc>
__host__ __device__ constexpr int mini_steps() {
  return sizeof(Acc) == 8 ? 2 : 4;
}
// the states kept at the start of each mini-block but the first (whose is
// the segment's entry state, read again from h_seg)
template <typename Acc>
__host__ __device__ constexpr int kept() {
  return SUB / mini_steps<Acc>() - 1;
}

// states a walk pass holds in registers: 8 in float, 4 in double. Passes
// of 16 in float spilled 20 bytes at 255 registers and held two blocks an
// SM (3.31 ms at the Jamba layer, bwd_ab.py); passes of 8 fit three blocks
// at 168 registers with none (2.96 ms). 8 in double spilled a few bytes.
__host__ __device__ constexpr int pass_states(int acc_bytes, int ns) {
  return acc_bytes == 8 ? (ns < 4 ? ns : 4) : (ns < 8 ? ns : 8);
}

// 1 / the decays' scale (scale_decay): ln 2 for float, 1 for double
__device__ __forceinline__ float unscale(float) {
  return 0.6931471805599453f;
}
__device__ __forceinline__ double unscale(double) { return 1.0; }

__host__ __device__ inline int64_t up16(int64_t v) {
  return (v + 15) / 16 * 16;
}

// the workspace: the counter and a flag a block (zeroed per call), the
// look-back's records (as the forward's), the partials of dB and dC
// (tiles, B, L, N), of da (B, chunks, N, I) and of dd_skip (B, chunks, I)
struct Shape {
  int64_t chunks, tiles, blocks, flag_bytes, records_at, pb_at, pc_at,
      pa_at, pd_at, bytes;
};

inline Shape shape_of(int64_t batch, int64_t len, int64_t inner, int64_t n,
                      int64_t acc_bytes) {
  Shape s;
  s.chunks = (len + LC - 1) / LC;
  s.tiles = (inner + LANES - 1) / LANES;
  s.blocks = batch * s.tiles * s.chunks;
  s.flag_bytes = 4 * (1 + s.blocks);
  s.records_at = up16(s.flag_bytes);
  s.pb_at = up16(s.records_at + batch * s.chunks * (state_size(n) + 1) *
                                    s.tiles * LANES * acc_bytes);
  const int64_t pbc = s.tiles * batch * len * n * acc_bytes;
  s.pc_at = up16(s.pb_at + pbc);
  s.pa_at = up16(s.pc_at + pbc);
  s.pd_at = up16(s.pa_at + batch * s.chunks * n * inner * acc_bytes);
  s.bytes = s.pd_at + batch * s.chunks * inner * acc_bytes;
  return s;
}

// dynamic shared memory: WARPS + 2 slots of (NS + 1) x 32 accumulators
// (each warp's adjoint span, the chunk's aggregate, the carry into it),
// one more for the decays with several passes; the x, dt and dy tiles (LC
// x 32); the B and C rows (LC x NS); the mini-blocks' states (WARPS x KEPT
// x NG x 32); with several passes the sums over n of dx and ddt (2 x LC x
// 32). In float32 at N = 16: 75 KB
template <typename T, typename Acc>
__host__ __device__ inline int64_t smem_bytes(int64_t n) {
  const int64_t ns = state_size(n);
  const int64_t ng = pass_states(sizeof(Acc), (int)ns);
  const bool split = ng < ns;
  const int64_t acc = sizeof(Acc);
  return (WARPS + 2 + split) * (ns + 1) * LANES * acc +
         3 * LC * LANES * (int64_t)sizeof(T) + 2 * LC * ns * acc +
         WARPS * kept<Acc>() * ng * LANES * acc +
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
      h[s0 + v] = xp(dtt * dec[g0 + s0 + v]) * h[s0 + v] + dx * bv[v];
  }
}

// blocks an SM must hold: three in float up to 16 states (75 KB of
// shared memory and at most 168 registers each); the others are held to
// one or two by shared memory anyway
template <typename Acc, int NS>
__host__ __device__ constexpr int bwd_min_blocks() {
  return sizeof(Acc) == 4 && NS <= 16 ? 3 : 1;
}

template <typename T, typename Acc, int NS>
__global__ void __launch_bounds__(LANES * WARPS, bwd_min_blocks<Acc, NS>())
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
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
  constexpr int NG = pass_states(sizeof(Acc), NS);
  constexpr bool SPLIT = NG < NS;
  constexpr int V = NG % (16 / sizeof(Acc)) == 0 ? 16 / sizeof(Acc) : 1;
  constexpr int K = mini_steps<Acc>();
  constexpr int CKS = SUB / K;                   // mini-blocks a segment
  constexpr int KEPT = kept<Acc>();
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

template <typename T, typename Acc, int NS>
int launch_kernel(const void* const* in, void* const* out, void* work,
                  int64_t batch, int64_t len, int64_t inner, int64_t n,
                  cudaStream_t stream) {
  const Shape sh = shape_of(batch, len, inner, n, sizeof(Acc));
  const int64_t smem = smem_bytes<T, Acc>(n);
  auto kernel = scan_bwd_kernel<T, Acc, NS>;
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
  Acc* pb = reinterpret_cast<Acc*>(w + sh.pb_at);
  Acc* pc = reinterpret_cast<Acc*>(w + sh.pc_at);
  Acc* pa = reinterpret_cast<Acc*>(w + sh.pa_at);
  Acc* pd = reinterpret_cast<Acc*>(w + sh.pd_at);
  kernel<<<(unsigned)sh.blocks, (unsigned)(WARPS * LANES), (size_t)smem,
           stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const Acc*>(in[7]),
      static_cast<const Acc*>(in[8]), static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), reinterpret_cast<Acc*>(w + sh.records_at),
      reinterpret_cast<unsigned*>(w), pb, pc, pa, pd, len, (int)inner,
      (int)n, sh.chunks, (int)sh.tiles, batch, vec);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  // dB, dC over the tiles; da (into a's (I, N) layout), dd_skip over the
  // (batch, chunk) blocks
  const int64_t blc = batch * sh.chunks;
  if ((e = sum_rows<T, Acc>(pb, out[2], sh.tiles, batch * len * n, 1, 1, 0,
                            stream)) != 0 ||
      (e = sum_rows<T, Acc>(pc, out[3], sh.tiles, batch * len * n, 1, 1, 0,
                            stream)) != 0 ||
      (e = sum_rows<T, Acc>(pa, out[4], blc, n * inner, inner, n, 1,
                            stream)) != 0)
    return e;
  return sum_rows<T, Acc>(pd, out[5], blc, inner, 1, 1, 0, stream);
}

template <typename T, typename Acc>
int launch(const void* const* in, void* const* out, void* work,
           int64_t batch, int64_t len, int64_t inner, int64_t n,
           void* stream) {
  if (n < 1 || n > MAX_N || batch < 1 || len < 1 || inner < 1 ||
      inner > (int64_t)1 << 30 || smem_bytes<T, Acc>(n) > MAX_SMEM ||
      in[7] == nullptr)
    return (int)cudaErrorInvalidValue;
  // block indices and the counter are 32-bit
  if (shape_of(batch, len, inner, n, sizeof(Acc)).blocks >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void* const*, void* const*, void*, int64_t,
                         int64_t, int64_t, int64_t, cudaStream_t);
  Launch fn;
  switch (state_size(n)) {
    case 1: fn = launch_kernel<T, Acc, 1>; break;
    case 4: fn = launch_kernel<T, Acc, 4>; break;
    case 16: fn = launch_kernel<T, Acc, 16>; break;
    default: fn = launch_kernel<T, Acc, 32>; break;
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
  return shape_of(batch, len, inner, n, acc_bytes).bytes;
}

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
