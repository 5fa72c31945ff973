// Selective scan (Mamba) for Hopper (sm_90a):
//   h_t = exp(dt_t * -exp(a)) (.) h_{t-1} + (dt_t x_t) (x) B_t
//   y_t = h_t . C_t + d_skip (.) x_t
// with x, dt (B, L, I), Bm, Cm (B, L, N), a (I, N), d_skip (I,), y (B, L, I).
//
// Replaces the TPU kernel repro/kernels/mamba_scan/mamba_scan.py::mamba_scan
// (body _scan_kernel), which carried the (I, N) state in VMEM scratch
// across a sequential grid axis of L-chunks. Blocks on Hopper run in no
// order, so here the carry passes between blocks explicitly, by the
// associative combine of models/ssm.py: a span of steps acts on the state
// as h -> exp(decay * S) h + h_end, with S the span's sum of dt and h_end
// its state walked from h = 0, and two spans compose as
// (S1, h1) . (S2, h2) = (S1 + S2, exp(decay * S2) h1 + h2).
// Nothing divides by a cumulative decay (in float32 the products underflow
// to 0 within a few steps of strong decay).
//
// Design: a chunked scan, parallel in L, in one grid (a chained scan with
// a decoupled look-back).
// * A block owns 32 channels (one per lane: loads and stores of x, dt and
//   y are row segments of the (B, L, I) layout) of one batch entry over
//   one chunk of LC = WARPS * SUB = 64 steps; warp w takes the w-th SUB
//   steps. The last chunk is ragged: its steps past L are zero-filled,
//   and a step with dt = 0, x = 0 leaves the state as it is, so no walk
//   is masked. N is padded to the instantiated NS with B = C = 0 and
//   decay = 0, states that stay 0, so the walks have no branch. In float64 at NS = 32 each
//   walk runs in two passes of 16 states (split_states), which keeps the
//   kernel free of register spills.
// * The block stages its chunk of x and dt (LC x 32) with cp.async into
//   shared memory, 16 bytes a copy where every row segment is 16-byte
//   aligned (else element loads), and B and C (LC x NS) beside them.
// * Walk 1: each warp walks its SUB steps from h = 0 out of shared memory:
//   (S, h_end) per channel and state. Warp 0 folds the warps' pairs in
//   order (each warp's exclusive prefix in shared memory) into the chunk's
//   aggregate.
// * Look-back: each block takes its chunk index from an atomic counter,
//   chunk-major, so every block it waits on has started. Chunks form
//   groups of G. Every chunk but a group's last publishes its aggregate
//   as soon as it has it; the last publishes its inclusive prefix P (the
//   state after it) once it knows it; each behind a flag (fence, then a
//   release store). Chunk c, in the group that starts at g, folds the
//   aggregates of chunks g .. c - 1 in order (lanes watch their flags in
//   parallel, with acquire loads), then applies that to P(g - 1) (0 for
//   the first group): the chain of P costs one load and one combine per
//   group. A look-back that took whatever was ready would add in another
//   order from run to run; this one makes every call give the same bits.
//   Each warp then applies its exclusive prefix to the chunk's carry: its
//   state on entry.
// * Walk 2: each warp walks its SUB steps again, from its entry state, out
//   of the same staged tile (each input byte crosses HBM once), writing y.
//   Where the caller asks for the final state h_L (h_last, (B, I, N) in
//   the accumulator type: a prompt's prefill hands it to decode), the last
//   warp of each (batch, tile)'s last chunk writes it from its registers
//   after its walk: the steps past L leave the state as it is, so that
//   warp ends at h_L whether or not its own steps reach L. Nothing else
//   changes, and a null h_last writes nothing.
// * For the gradient (csrc/mamba_scan_bwd.cu), where the caller passes
//   h_seg ((B, segments, N, I) in the accumulator type, a segment being
//   one warp's SUB steps), each warp writes its entry state there before
//   walk 2: the backward walks each segment again from it and so meets
//   the forward's h bit for bit. A null h_seg writes nothing.
// The wrapper allocates the scratch per call; the launcher zeroes its
// flags and counter with an asynchronous memset on the stream before the
// grid. Nothing allocates or synchronises the device here, and each call
// is one grid.
//
// Roofs on an H100 SXM (3.35 TB/s; 132 SMs at 1.98 GHz):
// * Bytes: x, dt and y once each (B, C, a, d_skip are small); the records
//   add NS + 1 accumulator values per channel and chunk, written once and
//   read from L2.
// * float32 (and bf16, which computes in float32): NS exps per (b, t, i)
//   in each walk, on the SFU (ex2 of a pre-scaled decay: one MUFU.EX2)
//   at 16 per clock per SM, 4.2e12 a second. At the Jamba-1.5-Large
//   layer (I = 16384, N = 16, L = 2048) one walk's 537 M exps take 0.13
//   ms beside a 0.121 ms bytes bound. This kernel walks twice and
//   computes each exp twice (keeping the tile's exp(dt * decay) would
//   need LC x 32 x NS values of shared memory), so it is held near 0.26
//   ms there.
// * float64: exp is a software routine of about 20 operations on the FP64
//   units (34 TFLOP/s; the 67 TFLOP/s of DMMA does not apply), again
//   twice. At the compiler's scan path (N = 1) bytes bound it.
//
// Types: the state and arithmetic in promote(dtype, float32): double in,
// double; float in, float; bf16 in, float. y has the input type.
//
// C interface (loaded with ctypes): pointers (h_last after y, null when
// the final state is not wanted; h_seg after it, null when no gradient
// will be asked for), the sizes and the CUDA stream; each entry returns a
// cudaError_t (0 on success). mamba_scan_scratch_bytes gives the size of
// the scratch the wrapper allocates: the flags and counter, then the
// chunks' records. mamba_scan_segments gives h_seg's segments.
// mamba_scan_abi names the entries' signature (2: with h_last; 3: with
// h_seg), for tools that call other checkouts.

#include "mamba_scan.cuh"

namespace {

// chunks of LC steps, 32-channel tiles, and the records: per (b, chunk)
// NS + 1 rows of tiles * 32 accumulator values (S and the aggregate's
// states, or the inclusive prefix's states for a group's last chunk)
// The scratch: the counter and one flag a block (32-bit words, zeroed
// per call), then, from a 16-byte boundary, the records.
struct Shape {
  int64_t chunks, tiles, blocks, flag_bytes, records_at, scratch_bytes;
};

inline Shape shape_of(int64_t batch, int64_t len, int64_t inner, int64_t n,
                      int64_t acc_bytes) {
  Shape s;
  s.chunks = (len + LC - 1) / LC;
  s.tiles = (inner + LANES - 1) / LANES;
  s.blocks = batch * s.tiles * s.chunks;
  s.flag_bytes = 4 * (1 + s.blocks);
  s.records_at = (s.flag_bytes + 15) / 16 * 16;
  s.scratch_bytes = s.records_at + batch * s.chunks * (state_size(n) + 1) *
                                       s.tiles * LANES * acc_bytes;
  return s;
}

// dynamic shared memory: WARPS + 2 slots of (NS + 1) x 32 accumulators (each
// warp's (S, h), the chunk's aggregate, the carry into the chunk), with
// split states one more slot (the decays) and y's partial sums (LC x
// 32); the x and dt tiles (LC x 32) and the B and C rows (LC x NS, as
// accumulators)
template <typename T, typename Acc>
__host__ __device__ inline int64_t smem_bytes(int64_t n) {
  const int64_t ns = state_size(n);
  const bool split = ns == 32 && split_states<Acc, 32>();
  return (WARPS + 2 + split) * (ns + 1) * LANES * (int64_t)sizeof(Acc) +
         split * LC * LANES * (int64_t)sizeof(Acc) +
         2 * LC * LANES * (int64_t)sizeof(T) +
         2 * LC * ns * (int64_t)sizeof(Acc);
}

// one step of the recurrence for the NG states g0 .. g0 + NG - 1 of NS;
// returns their part of C_t . h_t
template <typename Acc, int NS, int NG, bool OUT>
__device__ __forceinline__ Acc step(Acc (&h)[NG],
                                    const Decays<Acc, NS>& dec, int g0,
                                    Acc dtt, Acc dx, const Acc* b_row,
                                    const Acc* c_row) {
  constexpr int V = NG % (16 / sizeof(Acc)) == 0 ? 16 / sizeof(Acc) : 1;
  Acc yt = Acc(0);
#pragma unroll
  for (int s0 = 0; s0 < NG; s0 += V) {
    Acc bv[V], cv[V];
    load_row<Acc, V>(bv, b_row + g0 + s0);
    if constexpr (OUT) load_row<Acc, V>(cv, c_row + g0 + s0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      h[s0 + v] = state_step(xp(dtt * dec[g0 + s0 + v]), h[s0 + v], dx,
                             bv[v]);
      if constexpr (OUT) yt += h[s0 + v] * cv[v];
    }
  }
  return yt;
}

// blocks an SM must hold: for the float32 kernels up to 16 states, 5
// (at most 102 registers) ran the Jamba layers faster than no minimum
// (114 registers, 4 blocks); 6 spilled in bf16. Wider states need the
// registers.
template <typename Acc, int NS>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(Acc) == 4 && NS <= 16 ? 5 : 1;
}

template <typename T, typename Acc, int NS>
__global__ void __launch_bounds__(LANES * WARPS, min_blocks<Acc, NS>())
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const T* __restrict__ a, const T* __restrict__ d_skip,
            T* __restrict__ y, Acc* __restrict__ h_last,
            Acc* __restrict__ h_seg, Acc* __restrict__ scratch,
            unsigned* __restrict__ flags, int64_t len, int inner, int n,
            int64_t chunks, int tiles, int64_t batch, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_vid;
  constexpr int SLOT = (NS + 1) * LANES;         // accumulators per slot
  const int tid = threadIdx.x;
  const int lane = tid & (LANES - 1);
  const int warp = tid / LANES;

  // the chunk index from the counter: chunk-major, so every block this
  // one waits on took its index earlier and has started
  if (tid == 0) s_vid = atomicAdd(flags, 1u);
  __syncthreads();
  // 32-bit index arithmetic (the launcher keeps the grid under 2^31)
  const unsigned vid = s_vid;
  const unsigned rows = (unsigned)batch * (unsigned)tiles;
  const int64_t c = vid / rows;
  const int64_t b = (vid % rows) / (unsigned)tiles;
  const int tile = (int)((vid % rows) % (unsigned)tiles);
  const int64_t t0 = c * LC;
  const int i = tile * LANES + lane;
  const bool live = i < inner;

  constexpr bool SPLIT = split_states<Acc, NS>();
  constexpr int NG = SPLIT ? 16 : NS;            // states per walk pass
  Acc* comb = reinterpret_cast<Acc*>(smem);      // WARPS + 2 (+ 1) slots
  Acc* ysum = comb + (WARPS + 2 + SPLIT) * SLOT; // (LC, 32) if SPLIT
  T* xs = reinterpret_cast<T*>(ysum + (SPLIT ? LC * LANES : 0));
  T* dts = xs + LC * LANES;
  Acc* bs = reinterpret_cast<Acc*>(dts + LC * LANES);
  Acc* cs = bs + LC * NS;

  stage_rows<T>(xs, x + b * len * inner, t0, len, tile * LANES, inner, vec,
                tid);
  stage_rows<T>(dts, dt + b * len * inner, t0, len, tile * LANES, inner, vec,
                tid);
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
  Acc* carry = comb + (WARPS + 1) * SLOT;
  Decays<Acc, NS> dec;
  dec.bind(carry + SLOT + lane);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    dec.set(s, live && s < n
                   ? scale_decay(-exp(to_acc<Acc>(a[(int64_t)i * n + s])))
                   : Acc(0));
  const Acc dskip = live ? to_acc<Acc>(d_skip[i]) : Acc(0);
  dmma::wait<0>();
  __syncthreads();

  // walk 1: this warp's SUB steps from h = 0
  const int r0 = warp * SUB;
#pragma unroll
  for (int g0 = 0; g0 < NS; g0 += NG) {
    Acc h[NG], S = Acc(0);
#pragma unroll
    for (int s = 0; s < NG; ++s) h[s] = Acc(0);
#pragma unroll(NG < 32 ? 2 : 1)
    for (int r = r0; r < r0 + SUB; ++r) {
      const Acc dtt = to_acc<Acc>(dts[r * LANES + lane]);
      const Acc dx = dtt * to_acc<Acc>(xs[r * LANES + lane]);
      S += dtt;
      step<Acc, NS, NG, false>(h, dec, g0, dtt, dx, bs + r * NS, nullptr);
    }
    Acc* mine = comb + warp * SLOT;
    if (g0 == 0) mine[lane] = S;
#pragma unroll
    for (int s = 0; s < NG; ++s) mine[(1 + g0 + s) * LANES + lane] = h[s];
  }
  __syncthreads();

  // warp 0: the chunk's aggregate, the look-back, the publishing. The
  // per-state values live in shared memory (agg, carry), not registers.
  Acc* agg = comb + WARPS * SLOT;
  if (warp == 0) {
    // fold the warps in order: each slot keeps its exclusive prefix
#pragma unroll
    for (int k = 0; k <= NS; ++k) agg[k * LANES + lane] = Acc(0);
    for (int w = 0; w < WARPS; ++w) {
      Acc* slot = comb + w * SLOT;
      const Acc sw = slot[lane];
      slot[lane] = agg[lane];
      agg[lane] += sw;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        const Acc hw = slot[k];
        slot[k] = agg[k];
        agg[k] = xp(sw * dec[s]) * agg[k] + hw;
      }
    }

    const int64_t ld = (int64_t)tiles * LANES;
    const int64_t rec_size = (NS + 1) * ld;
    const Acc* recs = scratch + b * chunks * rec_size + i;
    Acc* rec = scratch + (b * chunks + c) * rec_size + i;
    unsigned* flag = flags + 1 + (b * tiles + tile) * chunks;
    const bool ends_group = c % GROUP == GROUP - 1;
    // a chunk of the same group follows: publish the aggregate at once
    if (c + 1 < chunks && !ends_group) {
#pragma unroll
      for (int k = 0; k <= NS; ++k) rec[k * ld] = agg[k * LANES + lane];
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flag + c, 1u);
    }

    // look back: the state entering chunk c is P(g - 1) (0 for g = 0)
    // followed by the aggregates of chunks g .. c - 1. Those are folded
    // first (lane k watches chunk g + k), so a group's chain of P waits
    // only for one load and one combine per chunk group.
    const int64_t g = c - c % GROUP;
    if (lane < c - g) {
      while (load_acquire(flag + g + lane) == 0) {
      }
    }
    __syncwarp();
    Acc sum_s = Acc(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) carry[(1 + s) * LANES + lane] = Acc(0);
    for (int64_t j = g; j < c; ++j) {
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
    }
    // the last chunk of a group publishes the state after it, P(c)
    if (c + 1 < chunks && ends_group) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (1 + s) * LANES + lane;
        rec[(1 + s) * ld] = xp(agg[lane] * dec[s]) * carry[k] + agg[k];
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flag + c, 1u);
    }
  }
  __syncthreads();

  // walk 2: this warp's SUB steps again, from its entry state, writing y
  T* yb = y + (b * len + t0) * inner + i;
  const int end = len - t0 < r0 + SUB ? (int)(len - t0) : r0 + SUB;
#pragma unroll
  for (int g0 = 0; g0 < NS; g0 += NG) {
    // the state on entry: the chunk's carry, then the warps before this
    Acc h[NG];
    const Acc* mine = comb + warp * SLOT;
#pragma unroll
    for (int s = 0; s < NG; ++s)
      h[s] = xp(mine[lane] * dec[g0 + s]) *
                 carry[(1 + g0 + s) * LANES + lane] +
             mine[(1 + g0 + s) * LANES + lane];
    // the segment's entry state, for the backward
    if (h_seg != nullptr && live) {
      Acc* hs = h_seg + ((b * chunks + c) * WARPS + warp) * n * inner + i;
#pragma unroll
      for (int s = 0; s < NG; ++s)
        if (g0 + s < n) hs[(int64_t)(g0 + s) * inner] = h[s];
    }
#pragma unroll(NG < 32 ? 2 : 1)
    for (int r = r0; r < end; ++r) {
      const Acc xt = to_acc<Acc>(xs[r * LANES + lane]);
      const Acc dtt = to_acc<Acc>(dts[r * LANES + lane]);
      Acc yt = step<Acc, NS, NG, true>(h, dec, g0, dtt, dtt * xt,
                                       bs + r * NS, cs + r * NS);
      // split states: the first pass keeps its part of y_t, the last adds
      if (g0 > 0) yt += ysum[r * LANES + lane];
      if (g0 + NG < NS) ysum[r * LANES + lane] = yt;
      else if (live)
        yb[(int64_t)r * inner] = from_acc<T, Acc>(yt + dskip * xt);
    }
    // the final state: this pass's states of the last chunk's last warp
    if (h_last != nullptr && c == chunks - 1 && warp == WARPS - 1 && live) {
      Acc* hl = h_last + (b * inner + i) * n;
#pragma unroll
      for (int s = 0; s < NG; ++s)
        if (g0 + s < n) hl[g0 + s] = h[s];
    }
  }
}

template <typename T, typename Acc, int NS>
int launch_kernel(const void* x, const void* dt, const void* bm,
                  const void* cm, const void* a, const void* d_skip, void* y,
                  void* h_last, void* h_seg, void* scratch, int64_t batch,
                  int64_t len, int64_t inner, int64_t n, void* stream) {
  const Shape sh = shape_of(batch, len, inner, n, sizeof(Acc));
  const int64_t smem = smem_bytes<T, Acc>(n);
  auto kernel = scan_kernel<T, Acc, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies when every 32-channel row segment starts on 16 bytes
  const bool vec = (inner * (int64_t)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0;
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)sh.flag_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)sh.blocks, (unsigned)(WARPS * LANES), (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(a), static_cast<const T*>(d_skip),
      static_cast<T*>(y), static_cast<Acc*>(h_last),
      static_cast<Acc*>(h_seg),
      reinterpret_cast<Acc*>(static_cast<char*>(scratch) + sh.records_at),
      static_cast<unsigned*>(scratch), len, (int)inner, (int)n, sh.chunks,
      (int)sh.tiles, batch, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* d_skip, void* y, void* h_last,
           void* h_seg, void* scratch, int64_t batch, int64_t len,
           int64_t inner, int64_t n, void* stream) {
  if (n < 1 || n > MAX_N || batch < 1 || len < 1 || inner < 1 ||
      inner > (int64_t)1 << 30 || smem_bytes<T, Acc>(n) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // block indices and the counter are 32-bit
  if (shape_of(batch, len, inner, n, sizeof(Acc)).blocks >=
      (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  // the state registers: the least instantiated size holding N
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, void*,
                         void*, int64_t, int64_t, int64_t, int64_t, void*);
  Launch fn;
  switch (state_size(n)) {
    case 1: fn = launch_kernel<T, Acc, 1>; break;
    case 4: fn = launch_kernel<T, Acc, 4>; break;
    case 16: fn = launch_kernel<T, Acc, 16>; break;
    default: fn = launch_kernel<T, Acc, 32>; break;
  }
  return fn(x, dt, bm, cm, a, d_skip, y, h_last, h_seg, scratch, batch, len,
            inner, n, stream);
}

}  // namespace

extern "C" {

int mamba_scan_f64(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* d_skip,
                   void* y, void* h_last, void* h_seg, void* scratch,
                   int64_t batch, int64_t len, int64_t inner, int64_t n,
                   void* stream) {
  return launch<double, double>(x, dt, bm, cm, a, d_skip, y, h_last, h_seg,
                                scratch, batch, len, inner, n, stream);
}

int mamba_scan_f32(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* d_skip,
                   void* y, void* h_last, void* h_seg, void* scratch,
                   int64_t batch, int64_t len, int64_t inner, int64_t n,
                   void* stream) {
  return launch<float, float>(x, dt, bm, cm, a, d_skip, y, h_last, h_seg,
                              scratch, batch, len, inner, n, stream);
}

int mamba_scan_bf16(const void* x, const void* dt, const void* bm,
                    const void* cm, const void* a, const void* d_skip,
                    void* y, void* h_last, void* h_seg, void* scratch,
                    int64_t batch, int64_t len, int64_t inner, int64_t n,
                    void* stream) {
  return launch<__nv_bfloat16, float>(x, dt, bm, cm, a, d_skip, y, h_last,
                                      h_seg, scratch, batch, len, inner, n,
                                      stream);
}

// bytes of scratch for one call; acc_bytes is the size of
// promote(dtype, float32)
int64_t mamba_scan_scratch_bytes(int64_t batch, int64_t len, int64_t inner,
                                 int64_t n, int64_t acc_bytes) {
  return shape_of(batch, len, inner, n, acc_bytes).scratch_bytes;
}

// segments (one warp's SUB steps each) of h_seg for a scan of len steps:
// whole chunks of WARPS
int64_t mamba_scan_segments(int64_t len) {
  return (len + LC - 1) / LC * WARPS;
}

int mamba_scan_abi() { return 3; }

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
