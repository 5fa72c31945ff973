#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero
exit:

1. Environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 off for float32 products.
2. Build: every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, started together; the flash attention's
   backward has a source of its own), into ``build/kernels/``;
   fails if ptxas reports spill bytes for a float64 (DMMA) matmul kernel,
   for any instantiation of the flash attention forward (its bf16
   tensor-core kernel, split-KV decode and combine among them), the
   selective scan or its backward (a source of its own too), or for the
   flash backward's bf16 tensor-core kernels (every head dim), or more
   than SPILL_MAX's for the flash backward's FMA kernels (float32 and
   float64).
3. Each kernel against its plain torch version on the card, in every
   dtype it takes, at its main path's chunk shape, at a language model's
   widths where the repo has one that runs it, and at a ragged shape;
   with the time of the kernel (and the host time of one call), of the
   plain version and, where one PyTorch call computes the same function,
   of that call (a yardstick the port never calls), beside the least
   time the card could take.
   The flash kernel also runs the served LM's shapes with query offsets
   (gemma2_2b's prefill of a 6144-token prompt over an 8192-key cache,
   and a decode step of 4 slots at positions 511, 2047, 4095 and 8190 on
   a window and a global layer). The flash inputs give scaled scores of
   standard deviation FLASH_Q_STD, some far past the softcap, and each
   flash case must also fail the same comparison with two negative
   controls in its place: the plain version with a uniform softmax over
   each row's mask and, where the case has a softcap, without it. A bf16
   case runs the grouped-query entry (K/V read in place, no regroup) or,
   on the (BH, S, D) layout, the bhsd entry; a ``torch.profiler`` trace
   of its calls must name exactly the kernels its shape asks for: the
   split-KV decode (and its combine, where the call takes more than one
   split) where Sq x G <= FWD_DEC_ROWS, else the tensor-core kernel;
   never the FMA kernel, and no copy kernel. A float32 or float64 GQA
   case also times the kernel alone on the regrouped tensors and the
   regroup alone. The training forward's shapes (stablelm_3b, seamless's
   encoder and Jamba's layer, S = 4096, on the layout the regroup hands
   the kernel) take ``scaled_dot_product_attention`` as their library
   call. The gemma2 attention layer (bf16 and float32) and these
   shapes in bf16 (softcap, causal, window, GQA) take ``flex_attention``,
   compiled, as their library call; the layer is also timed
   beside a yardstick: ``scaled_dot_product_attention`` with its causal
   and window mask and no softcap. The flash kernel also runs the
   shapes phase 10 serves Jamba-1.5-Large at (64 heads, GQA 8, D = 128,
   no softcap: the longest prompt's prefill over 8192 keys, a 4-slot
   decode step), with ``scaled_dot_product_attention(enable_gqa=True)``
   and a boolean mask as their library call. The scan also returns its
   final state h_L (which a prefill hands to decode) at the Jamba
   layer, at a ragged L, in float64 at N = 32 and at phase 10's shortest
   and longest Jamba prompts: h_L against the plain version's, and y the
   same bits as without it.
   The flash attention's backward: the forward kernel's logsumexp and
   output against the plain forward's, then the backward kernels (the
   preamble, dK/dV and dQ), from the forward kernel's output and
   logsumexp, against the plain ``flash_attention_bhsd_bwd_ref`` from
   the plain forward's: dq, dk and dv within TOL and, in norm, within
   BWD_NORM_TOL, at the attention path's chunk (float64, float32), a
   stablelm_3b layer (2 sequences x 32 heads, S = 4096, D = 80,
   causal), seamless's encoder and cross attention (2 x 16 heads, Sq =
   Skv = 4096, D = 64, not causal), gemma2_2b's local layer (8 heads, S
   = 8192, D = 288, window 4096, softcap 50) in bf16 and its layer as
   phase 11 trains it (a microbatch of 1 x 8 heads, S = 4096), a ragged
   case, and
   in float32 and bf16 a decode-like case with a query offset per slot
   and a case with rows that have no valid key. Each case must give the
   same bits on a second call, and fail that comparison with dK zeroed, with P uniform over each row's mask, with
   a softcap with dS missing its (1 - tanh^2), and with rows without a
   key with dV missing their dO / Skv. The library time is
   ``torch.autograd.grad`` through ``scaled_dot_product_attention`` with
   the same mask (with offsets or rows without a key: the mask added as
   0 and -1e30) or, where a case has a softcap, through compiled
   ``flex_attention``. A ``torch.profiler`` trace of each case (the call
   repeated over 50 ms; up to four traces, where one lost kernels) names
   the kernels that ran: a bf16 case fails unless it ran the tensor-core
   kernels and no FMA dK/dV or dQ kernel (every D up to BWD_MMA_MAX_D,
   gemma2_2b's 288).
   The selective scan's backward (SCAN_BWD_CASES: the Jamba layer as
   phase 11 trains it, at phase 10's served prompt lengths, ragged cases
   in float32 and float64, float64 at N = 32 and one seeded by the final
   state's gradient), from the forward kernel's segment states, against
   the plain backward in float64 on the same inputs, element by element
   and in norm; it must fail that comparison with dB zeroed and with the
   adjoint's carry between chunks dropped, and give the same bits on a
   second call; a ``torch.profiler`` trace of its calls must name the
   redesigned ``scan_bwd_kernel`` (float32, bf16) or the first design's
   ``scan_bwd_f64_kernel`` (float64) and the sums, and not the other;
   timed beside its bound (x, dt, dy, dx, ddt once in memory against one
   exp per (b, t, i, n)) and the plain backward.
   Each kernel redesigned for Hopper (the float64 matmul and flash
   attention on the tensor cores, the selective scan as a chunked scan
   parallel in L, the bf16 backward on the tensor cores (past D = 128
   too: gemma2's local layer), the bf16
   forward's prefill on the tensor cores and its decode split over the
   keys, the float32 scan backward's warps each over a whole chunk) is
   printed beside its time before the redesign; the
   float32 scan's bound includes its SFU roof (its exps at the SFU's
   rate), printed beside it.
4. The main paths at full size, each compiled by
   ``repro_torch.core.compiler.compile_kernel`` and run twice (cold, then
   with everything cached on the workers) on one
   ``ClusterRuntime(workers=2, device="cuda")``, in float64:

   * matmul: ``gemm_rowscale`` at n=16384, k=m=2048;
   * attention: ``attn_kernel`` at n=16384 query rows, t=4096 keys,
     d=128;
   * scan: ``scan_kernel`` (c = 0.9) at 8192 rows x L=2048, a size at
     which the router prices the scan's chunks to ``cuda`` with a
     margin for a host with a fast copy (PERF.md, section 6).

   Each path's pfor must run every chunk on the ``cuda`` twin (the
   hand-written kernel in the workers) with no fallback and no plain
   call, launch its own kernel, count no fault (no respawn, no expired
   heartbeat), and match numpy within 1e-8 in both runs. Before each
   path every count is set to 0; the router's prices (``t_np``,
   ``t_torch`` and ``t_cuda`` per worker) are printed beside each
   worker's profile.
5. The STAP path on the same fleet: ``stap_adaptive``
   (``examples/torch_stap.py``, the reference's flagship kernel) at the
   example's widths (K = 64, DOF = 64, ITERS = 800, float64) over
   GATES = 8192 range gates (268 MB of training cube, ~58 GFLOP), cold
   and warm, then the worker-kill drill and one run on the replaced
   fleet. Every chunk must run the ``torch`` twin (batched with
   ``torch.func.vmap`` on the card) with no fallback, no eager-twin run
   (``batch_fallbacks``) and ``batch_hits`` on the warm run; the output
   must match, within 1e-8, an independent float64 batched recurrence on
   the card for every gate and the sequential numpy ``stap_seq`` on a
   strided sample of 256 gates. The replacement worker must run torch
   twins on the card.
6. The whole-kernel path: PolyBench ``gemm``
   (``benchmarks/polybench_kernels.py``) at n = 4096 in float64 through
   the dispatcher, which must pick the whole-kernel ``torch`` variant;
   the result must be within 1e-8·max(1, |ref|) of numpy's.
7. STAP served on the card: ``stap_adaptive`` compiled on the same
   fleet behind the serving plane (``repro_torch.serve``:
   admission → coalescing window → one stacked pfor). SERVE_REQUESTS
   requests from two tenants, each one dwell of SERVE_GATES range gates
   at the example's widths (16.8 MB of training cube a request), arrive
   open-loop (Poisson) at SERVE_LOAD of the naive capacity, measured
   first on SERVE_CALIBRATE fresh requests served back to back; they are
   served one by one (window 0), then coalesced (10 ms window, up to 16
   requests a batch: a full batch is 8192 gates). Per mode it prints requests/s, p50 and
   p95 of the end-to-end and queue milliseconds, the coalescing
   counters, bytes shipped, chunks per backend, the batch counters and
   the head's phase seconds and traced spans over the mode's run.
   In both modes every request's output must match the float64
   recurrence on the card within 1e-8 and ``stap_seq`` on a strided
   sample, every chunk must run the ``torch`` twin with no fallback and
   no eager-twin run, no request may be rejected or fail, and no fault
   may be counted; the coalesced mode must merge at least one batch.
8. raylite on the card: ``examples/torch_stap_pipeline.py`` (the STAP
   cube pipeline on ``TaskRuntime(workers=2)``, its elastic controller
   and lineage drill); it checks its output against numpy, and every
   pfor chunk must have run the torch twin (``pfor_chunks``), none the
   numpy body.
9. The LM served on the card: gemma2_2b at full width and depth in bf16
   (weights from the seed, drawn on the card) behind
   ``repro_torch.serve.ServeEngine`` (4 slots x 8192 positions): 8
   requests from two tenants, one per engine tick, prompts of 512-6144
   tokens from the seed, 32 new tokens each. It prints each request's
   TTFT, prefill time and TPOT, tokens/s and the flash launches, and
   fails unless the kernel launched exactly once per attention layer per
   prefill and decode step, no attention call took the plain version,
   and every generated token is within LM_LOGIT_TOL of the top logit of
   a replay of its request through the same model with attention patched
   to the plain version, at least LM_MIN_EXACT of them its argmax. The same
   replay must fail that gate with each decode query on key 0 alone (the
   fault of a decode kernel that drops the query offset) and with a
   uniform softmax; a third control's readings (every query one key
   further) are printed. Each request's prefill is timed on its own.
9b. The LM served from a cluster worker on the card: the same model and
   seed behind ``repro_torch.serve.ClusterLMEngine`` on a 2-worker CUDA
   fleet (spawn, no respawn), params and KV caches in a worker's object
   store (4 slots x 2048 positions, re-anchored every 24 ops): 6
   requests from two tenants, one per engine tick, prompts of 256-1536
   tokens, 16 new tokens each, after the same requests on the head's
   ``ServeEngine``. After the first anchor, mid-decode, the state's
   owner is killed and the run finishes by lineage replay on the
   survivor. It prints the boot's and each anchor's seconds and bytes,
   the drill's recovery seconds, TTFT/TPOT p50/p95 and tokens/s beside
   the head engine's, and each worker's counts and peak memory, and
   fails unless every token equals the head engine's, there was an
   anchor, a death and a replay, the head's chain never outgrew 24, and
   on each worker that served (read by a function shipped to it) the
   flash kernel launched 26 times per prefill and decode op it ran
   (replays included) with no plain call, the two workers' ops adding up
   to the engine's and the replayed ones.
10. The MoE and recurrent families served on the card (FAMILIES), bf16,
   weights from the seed: Jamba-1.5-Large at full width cut to one
   period (8 of 72 layers) whose four MoE layers share one expert set,
   and olmoe_1b_7b at full width and depth, each behind ``ServeEngine``
   (4 slots): 6 requests from two tenants, one per tick, 16 new tokens
   each. It prints the cuts, each request's TTFT, prefill time and TPOT,
   tokens/s and peak memory, and fails unless every attention layer's
   call launched the flash kernel and every Mamba prefill the scan
   kernel (flash launches = attention layers x (prefills + decode
   steps), scan launches = Mamba layers x prefills, no plain call of
   either), and every served token is within the model's gate of a
   replay of the engine's own calls (the same batches, so the same MoE
   capacity) on the plain attention and the plain scan. A replay that
   leaves each Jamba prefill's Mamba states at zero must fail that gate.
11. Training on the card (TRAIN_RUNS), each run after the earlier
   phases' garbage is collected (what stays allocated is printed, and
   must stay within SETTLED_MAX_GIB), bf16, weights from the seed,
   batches from the reference's pipeline (``SyntheticTokens``, seed
   1234): stablelm_3b, seamless_m4t_medium and gemma2_2b (D = 288) at
   full width and depth, and Jamba-1.5-Large at full width cut to one
   period with 2 shared experts (its cuts in TRAIN_RUNS), each through
   ``repro_torch.train``'s
   step (the run's microbatches, remat full, AdamW lr 3e-4, the config's
   moments, written in place) for TRAIN_STEPS steps. Step 1's gradient
   (``accumulate_grads``) is replayed with every attention's backward
   through the plain ``flash_attention_bhsd_bwd_ref`` and every scan's
   through the plain ``mamba_scan_bwd_ref`` (the forward kernels kept)
   and must agree within TRAIN_GATE (per leaf: cosine, relative norm
   error); the run's controls must fail that gate (stablelm, seamless
   and gemma2: the attention output detached, the backward kernel with dK
   zeroed; Jamba: the scan backward with dB zeroed, and without the
   adjoint's carry between chunks). It prints step seconds, tokens/s,
   forward/backward/optimizer ms (CUDA events), peak memory and the
   launches, and fails unless the trained parameters' loss on step 1's
   batch is below step 1's (each step draws a new batch, whose loss
   differs from the last by more than 4 steps at lr 3e-4 move
   seamless's; both are printed), in the ``resume`` run (seamless's) a
   save (``AsyncCheckpointer``) after step 2 restored into fresh tensors
   gives steps 3-4 the same loss bits,
   every attention call and every Mamba layer launched the backward
   kernels once and the forward twice (remat), and no call took a plain
   version. Then ``launch/train.py --arch jamba_1_5_large_398b --smoke``
   trains on the card, through the scan's backward kernel.
12. The planner on the card, after the earlier phases' garbage is
   collected (at most SETTLED_MAX_GIB left): (a) ``launch/train.py
   --arch stablelm_3b --steps 2 --batch 2 --seq 4096`` at full width
   (no ``--smoke``): its planner call must plan on the card's 1-device
   mesh (``make_host_mesh``, a 1-rank ``nccl`` group), every leaf
   ``Replicate``, the estimate legal; its losses finite; the flash
   forward launched twice (remat) and the backward once per layer and
   step, with no plain call. It prints the estimate's HBM bytes,
   compute and memory seconds beside the peak memory and the measured
   step seconds (the estimate is a model: not gated), and the model
   FLOP utilisation of step 2 at the bf16 datasheet peak. (b) The dry
   run's train cell (``launch/dryrun.py``) for the same model and batch
   on that mesh with real weights (the seed's) as DTensors, one step
   under ``launch/op_analysis.py``: its loss and gradient norm against
   a plain-tensor step of the same config on the same weights and batch
   (the same bits expected: each local tensor is the whole; else within
   TRAIN_GATE["norm_rel"], the difference printed), every attention
   call through ``local_map`` (``local_calls``) launching the kernels
   (forward twice, backward once a layer and microbatch), no plain call.
   (c) The dry run's shape-only count of that cell (meta tensors on a
   1x1 fake mesh): its FLOPs within PLANNER_FLOP_TOL of (b)'s real
   count. (d) The dry run's decode cell for the same model: a
   DECODE_PROMPT-token prefill of DECODE_BATCH rows on plain tensors
   fills the caches; then the weights, the next tokens and the caches
   are placed as DTensors by ``build_decode_cell`` on the card's 1x1
   mesh and one decode step runs (``count_cell``): the weights' and
   rows' gathers as no-ops, each layer's attention through
   ``local_map`` into the split-KV decode kernel. Against the same
   step on plain tensors: every row's argmax equal and the largest
   logit difference at most LM_LOGIT_TOL; one flash launch and one
   ``local_calls`` a layer, no plain call; every cache leaf after the
   step on its ``cache_sharding`` placements. (e) olmoe_1b_7b's
   prefill cell likewise (MOE_ARCH): the MoE layers' routing, dispatch
   and combine on each rank's shard, the plain prefill's drops. (f)
   Jamba's train cell at phase 11's cuts (JAMBA_CELL_RUN), one row of
   TRAIN_SEQ tokens, FSDP forced and the experts wired to no mesh axis
   (as (32, 8)'s plan gives them; the 1x1 mesh's size-1 axes would give
   them one): its loss and gradient only (``count_cell(grad_only=
   True)``), each MoE layer's expert products on the weights' shards
   (``moe.shard_calls``); against the plain loss and gradient: the loss
   and gradient norm within TRAIN_GATE["norm_rel"], each MoE leaf's
   gradient within TRAIN_GATE, every attention and scan forward (twice:
   remat) and backward on its kernel with no plain call, and the
   shape-only count's FLOPs within PLANNER_FLOP_TOL of the real one.
13. Summary: one JSON line with every kernel's numbers, the card's line,
   and as the last line ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the checkout's ``src/``; without either it
exits non-zero before printing any result. It imports nothing of JAX
and nothing of the JAX package ``repro``.
"""

import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
WORKERS = 2
# the cluster splits each worker's share in two (pipeline depth 2)
CHUNKS = 2 * WORKERS

# main-path sizes (float64)
N_ROWS, K_DIM, M_DIM = 16384, 2048, 2048       # matmul: ~0.55 GB, 137 GFLOP
ATTN_N, ATTN_T, ATTN_D = 16384, 4096, 128      # attention: ~48 MB, 34 GFLOP
SCAN_N, SCAN_L = 8192, 2048                    # scan: 2 x 134 MB
SCAN_C = 0.9                                   # scan_kernel's coefficient
# the STAP path: examples/torch_stap.py's widths (K = 64, DOF = 64,
# ITERS = 800) over this many range gates (268 MB of training cube,
# ~58 GFLOP); the gate count is the only cut. The output is checked for
# every gate against a float64 recurrence on the card and for a strided
# sample against the sequential numpy kernel
STAP_GATES = 8192
STAP_SAMPLE = 256
# the whole-kernel path: PolyBench gemm at n = 4096 (float64)
GEMM_N = 4096
# the served STAP phase: requests from two tenants, each one dwell of
# this many range gates at the example's widths (16.8 MB of training
# cube), served one by one and then coalesced (window, batch cap): six
# full coalesced batches a mode (cut from ten, 160 requests, when the
# training phase was added: a mode takes SERVE_REQUESTS / (SERVE_LOAD x
# capacity) seconds, 82 s at 160 on a host of 2.4 requests/s). They
# arrive at SERVE_LOAD times the naive capacity, measured first on
# SERVE_CALIBRATE fresh requests served back to back
SERVE_REQUESTS = 96
SERVE_GATES = 512
SERVE_WINDOW_S = 0.01
SERVE_MAX_BATCH = 16
SERVE_CALIBRATE = 6
SERVE_LOAD = 0.8
# the served LM (phase 9): gemma2_2b at full width and depth in bf16,
# weights from the seed on the card, behind ServeEngine with LM_SLOTS
# slots of LM_MAX_SEQ positions; LM_REQUESTS requests from two tenants,
# one per engine tick, prompts of LM_PROMPT tokens drawn from the seed
# (some longer than the local layers' 4096-key window), LM_NEW_TOKENS
# generated each. Every generated token is replayed through the same
# model with attention on its plain version: it must lie within
# LM_LOGIT_TOL of the replay's largest logit, and at least LM_MIN_EXACT
# of all must be its argmax (logits after gemma2's final softcap of 30,
# largest about 5 at these random weights, where a bf16 ulp is 1/32: two
# ulps; the top few logits of a 256k vocabulary lie about 0.2 apart)
LM_ARCH = "gemma2_2b"
LM_SLOTS, LM_MAX_SEQ = 4, 8192
LM_REQUESTS, LM_NEW_TOKENS = 8, 32
LM_PROMPT = (512, 6144)
LM_LOGIT_TOL = 0.0625
LM_MIN_EXACT = 250
# the LM served from a cluster worker (phase 9b): the same model and
# seed behind ClusterLMEngine on a CLUSTER_WORKERS-worker CUDA fleet
# (params and KV caches in a worker's object store, CLUSTER_SLOTS slots
# of CLUSTER_MAX_SEQ positions, the chain re-anchored every CLUSTER_TRIM
# ops); CLUSTER_REQUESTS requests from two tenants, one per engine tick,
# prompts of CLUSTER_PROMPT tokens, CLUSTER_NEW_TOKENS generated each:
# 6 prefills and 32 decode ticks, so one anchor (~6.3 GB pulled to the
# head and pushed back). After it, mid-decode, the state's owner is
# killed and the run finishes by lineage replay on the survivor. Every
# token must equal the head ServeEngine's on the same requests
CLUSTER_WORKERS = 2
CLUSTER_SLOTS, CLUSTER_MAX_SEQ, CLUSTER_TRIM = 4, 2048, 24
CLUSTER_REQUESTS, CLUSTER_NEW_TOKENS = 6, 16
CLUSTER_PROMPT = (256, 1536)
# the prompts' lengths, drawn from the seed (phase 3 holds the flash
# kernel to its plain version at the shapes they give)
CLUSTER_LENS = [int(n) for n in np.random.default_rng(SEED + 9).integers(
    CLUSTER_PROMPT[0], CLUSTER_PROMPT[1] + 1, CLUSTER_REQUESTS)]
# the MoE and recurrent families served (phase 10), bf16, weights from
# the seed on the card, each behind ServeEngine with FAM_SLOTS slots:
# FAM_REQUESTS requests from two tenants, one per engine tick, prompts
# of ``prompt`` tokens drawn from the family's seed, FAM_NEW_TOKENS
# generated each. Jamba-1.5-Large at full width, cut to one period (8 of
# its 72 layers; ArchConfig.n_periods needs layers % 8 == 0) whose four
# MoE layers share one expert set (one period at full width holds ~90
# GB of bf16 weights, ~32 GB so); olmoe_1b_7b at full width and depth.
# Every served token is replayed through the same engine calls (the
# same batches, so the same MoE capacity) with attention and the scan on
# their plain versions and each MoE layer's routing (its top-k weights
# and buffer rows) pinned to the served call's: it must lie within
# ``logit_tol`` of the replay's largest logit, and at least
# ``min_exact`` of the FAM_REQUESTS x FAM_NEW_TOKENS must be its argmax.
# Free routing would let a rounding difference flip an assignment, which
# at these weights (the reference's init: each expert's output ~100)
# moves x by up to ~90 in olmoe's first layer and cascades through 16
# layers; that reading is printed where ``free_replay`` asks for it.
# Jamba's control replay leaves each prefill's Mamba states at zero (the
# reference's prefill, ROADMAP Queue 3 entry 7, hands decode no prompt
# state) and must fail the gate. The gate (a gap of 0.125: 4 bf16 ulps
# of a logit in [2, 4), 2 in [4, 8); 86 of 96 exact) lies between the
# sound replays on an H100 (Jamba 95 exact, largest gap 0.0312; olmoe 90,
# 0.0625: its inexact tokens are near-ties within 2 ulps of the top
# logit) and the zero-state control (gap 0.4219).
FAM_SLOTS, FAM_REQUESTS, FAM_NEW_TOKENS = 4, 6, 16
FAMILIES = {
    "jamba": {"arch": "jamba_1_5_large_398b", "layers": 8,
              "share_experts": True, "max_seq": 8192,
              "prompt": (1024, 6144), "seed": SEED + 7,
              "logit_tol": 0.125, "min_exact": 86,
              "zero_state_control": True, "free_replay": False},
    "olmoe": {"arch": "olmoe_1b_7b", "layers": None,
              "share_experts": False, "max_seq": 4096,
              "prompt": (512, 3072), "seed": SEED + 8,
              "logit_tol": 0.125, "min_exact": 86,
              "zero_state_control": False, "free_replay": True}}
# a replay's plain attention runs in chunks of this many query rows (at
# once, the plain version of a 6144-token Jamba prefill over its 8192
# keys would hold ~40 GB of scores)
REPLAY_Q_CHUNK = 1024


def _family_lens(spec) -> list:
    """The prompt lengths of a served family, drawn from its seed."""
    lo, hi = spec["prompt"]
    return [int(n) for n in np.random.default_rng(spec["seed"]).integers(
        lo, hi + 1, FAM_REQUESTS)]


def _family_prompts(spec, vocab: int) -> list:
    """The prompts of a served family: its lengths, then the tokens, from
    the same generator."""
    rng = np.random.default_rng(spec["seed"])
    lo, hi = spec["prompt"]
    lens = rng.integers(lo, hi + 1, FAM_REQUESTS)
    return [rng.integers(0, vocab, int(n)) for n in lens]


# Jamba's served prompt lengths: phase 3 runs its flash and scan cases
# at the shapes phase 10 serves
JAMBA_LENS = _family_lens(FAMILIES["jamba"])

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): float64 on the tensor cores (DMMA) 67 TFLOP/s, float32 outside
# the tensor cores 67 TFLOP/s, bf16 989 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
# the selective scan runs no product on the tensor cores: its float64
# operations count at the FP64 units' 34 TFLOP/s; its float32 exps run on
# the SFU, 16 a clock on each of 132 SMs at 1.98 GHz
PEAK_FP64_FMA = 34e12
SFU_EXP_S = 16 * 132 * 1.98e9
# operations of one selective-scan step per (b, t, i, n) on the FMA
# pipes: the dt*decay product, the state FMA (2) and the output FMA (2),
# and in float64 the exp, a software routine (range reduction and a
# polynomial) of about 20 double operations. float32 (and bf16, computed
# in float32) takes its exp on the SFU, one per (b, t, i, n), counted at
# SFU_EXP_S
SCAN_OPS = {"float64": 20 + 5, "float32": 5, "bfloat16": 5}

# the training runs' sequence length (phase 11; phase 3's training shapes)
TRAIN_SEQ = 4096
# phase 3 cases of the flash-attention kernel: (label, (B, Sq, H, KVH,
# Skv, D), causal, window, softcap, dtype, query offsets: None, or one
# per batch row); H == 1 runs the kernel's own (BH, S, D) layout, H > 1
# the GQA dispatch
FLASH_CASES = [
    ("chunk", (1, ATTN_N // CHUNKS, 1, 1, ATTN_T, ATTN_D), False, 0, 0.0,
     "float64", None),
    ("gemma2", (1, 8192, 8, 4, 8192, 288), True, 4096, 50.0, "bfloat16",
     None),
    ("gemma2", (1, 8192, 8, 4, 8192, 288), True, 4096, 50.0, "float32",
     None),
    # the widest float64 tile (D = 288) at a shorter sequence
    ("gemma2", (1, 2048, 8, 4, 2048, 288), True, 4096, 50.0, "float64",
     None),
    # the served LM's shapes (phase 9): a 6144-token prompt's prefill
    # over the slot's 8192-key cache, and a decode step of 4 slots at
    # their own positions, on a window (local) and a global layer
    ("gemma2_prefill", (1, 6144, 8, 4, 8192, 288), True, 4096, 50.0,
     "bfloat16", [0]),
    ("gemma2_decode_local", (4, 1, 8, 4, 8192, 288), True, 4096, 50.0,
     "bfloat16", [511, 2047, 4095, 8190]),
    ("gemma2_decode_global", (4, 1, 8, 4, 8192, 288), True, 0, 50.0,
     "bfloat16", [511, 2047, 4095, 8190]),
    # the cluster-served LM's (phase 9b, in a worker): its longest
    # prompt's prefill over the slot's 2048-key cache, and a decode step
    # of its 4 slots halfway through the first four requests' tokens
    ("cluster_prefill", (1, max(CLUSTER_LENS), 8, 4, CLUSTER_MAX_SEQ, 288),
     True, 4096, 50.0, "bfloat16", [0]),
    ("cluster_decode_local", (CLUSTER_SLOTS, 1, 8, 4, CLUSTER_MAX_SEQ, 288),
     True, 4096, 50.0, "bfloat16",
     [n + CLUSTER_NEW_TOKENS // 2 for n in CLUSTER_LENS[:CLUSTER_SLOTS]]),
    ("cluster_decode_global", (CLUSTER_SLOTS, 1, 8, 4, CLUSTER_MAX_SEQ,
                               288), True, 0, 50.0, "bfloat16",
     [n + CLUSTER_NEW_TOKENS // 2 for n in CLUSTER_LENS[:CLUSTER_SLOTS]]),
    ("ragged", (1, 1000, 1, 1, 777, 72), False, 40, 30.0, "float32", None),
    ("ragged", (1, 1000, 1, 1, 777, 72), False, 40, 30.0, "float64", None),
    # Jamba-1.5-Large's attention layer as phase 10 serves it (64 heads,
    # GQA 8, D = 128, no window, no softcap): the longest prompt's
    # prefill over the slot's 8192-key cache, and a decode step of 4
    # slots halfway through the first four requests' tokens
    ("jamba_prefill", (1, max(JAMBA_LENS), 64, 8, 8192, 128), True, 0,
     0.0, "bfloat16", [0]),
    ("jamba_decode", (4, 1, 64, 8, 8192, 128), True, 0, 0.0, "bfloat16",
     [n + FAM_NEW_TOKENS // 2 for n in JAMBA_LENS[:4]]),
    # the training forward as phase 11 runs it, on the (BH, S, D) layout
    # the regroup hands the kernel: a stablelm_3b layer (a microbatch of
    # 1 x 32 heads, S = 4096, D = 80, causal), seamless's encoder (16
    # heads, D = 64, not causal) and Jamba's attention layer (64 heads,
    # its GQA 8 regrouped, D = 128, causal)
    ("stablelm_train", (32, TRAIN_SEQ, 1, 1, TRAIN_SEQ, 80), True, 0, 0.0,
     "bfloat16", None),
    ("seamless_train", (16, TRAIN_SEQ, 1, 1, TRAIN_SEQ, 64), False, 0, 0.0,
     "bfloat16", None),
    ("jamba_train", (64, TRAIN_SEQ, 1, 1, TRAIN_SEQ, 128), True, 0, 0.0,
     "bfloat16", None)]
# the bf16 forward's kernels (csrc/flash_attention.cu): the split-KV
# decode where a KV head's query rows (Sq x G) are at most FWD_DEC_ROWS
# (DEC_ROWS there), the tensor-core kernel past them; phase 3 checks by
# name which ran, and that nothing else did (no regroup copy)
FWD_DEC_ROWS = 16
# phase 3's flash inputs: keys and values N(0, 1), queries N(0,
# FLASH_Q_STD^2), so the scaled scores q.k / sqrt(D) have that standard
# deviation and each row's softmax weighs a few keys (a wrong mask or a
# skipped tile then moves the output by O(1)); the query of every
# FLASH_PUSH-th (row + head) is drawn at FLASH_Q_PUSHED instead, so its
# scores reach far past the softcap (50, or 30), which then sets its
# weights
FLASH_Q_STD = 3.0
FLASH_Q_PUSHED = 40.0
FLASH_PUSH = 4
# compiled flex_attention is the library call of the bf16 GQA cases,
# tried with these kernel options in turn (None: its own tiles). At D =
# 288 (padded to 512 in its Triton template) its own tiles need 262,144
# B of shared memory in the full layer (PERF.md, PR 16), and the
# prefill's tiles are the same, so the prefill takes small ones at once
FLEX_SMALL_TILES = {"BLOCK_M": 64, "BLOCK_N": 64, "num_stages": 1}
FLEX_TRIES = {"gemma2": (None, FLEX_SMALL_TILES),
              "gemma2_prefill": (FLEX_SMALL_TILES,),
              "gemma2_decode_local": (None, FLEX_SMALL_TILES),
              "gemma2_decode_global": (None, FLEX_SMALL_TILES),
              "cluster_prefill": (FLEX_SMALL_TILES,),
              "cluster_decode_local": (None, FLEX_SMALL_TILES),
              "cluster_decode_global": (None, FLEX_SMALL_TILES)}
# and of the backward cases with a softcap: the gradient through it, its
# forward at the small tiles at D = 288 and its backward's own tiles (or
# these small ones, should those need more shared memory than an SM has)
FLEX_BWD_SMALL_TILES = {**FLEX_SMALL_TILES, "BLOCK_M1": 16, "BLOCK_N1": 32,
                        "BLOCK_M2": 32, "BLOCK_N2": 16}
FLEX_BWD_TRIES = {"gemma2_local": (FLEX_SMALL_TILES, FLEX_BWD_SMALL_TILES),
                  "gemma2_train": (FLEX_SMALL_TILES, FLEX_BWD_SMALL_TILES),
                  "ragged": (None,)}
# the Jamba cases (no softcap) take scaled_dot_product_attention with
# enable_gqa and a boolean mask at the query offsets as their library call
SDPA_GQA = ("jamba_prefill", "jamba_decode")
# phase 3 cases of the flash attention's backward, on the kernel's (BH,
# S, D) layout: (label, (BH, Sq, Skv, D), causal, window, softcap,
# dtype, query offsets: None, or one per batch-head). The chunk is the
# attention path's (float64, and float32); stablelm_3b's layer as phase
# 11 trains it (a microbatch of 1 x 32 heads; here 2 sequences),
# seamless's encoder and cross attention (16 heads, Sq = Skv = 4096, not
# causal; 2 sequences), gemma2_2b's local layer at S = 8192 (at S = 4096
# a window of 4096 masks nothing) and its layer as phase 11 trains it (a
# microbatch of 1 x 8 heads, S = 4096; the window masks nothing there)
# and a ragged case (Sq > Skv, causal, softcapped). Then, in float32
# (the FMA kernels) and bf16 (the tensor-core kernels): a decode-like
# ragged case with a query
# offset per slot (8 batch-heads of 37 new rows over a 1000-key cache,
# offsets up to 963) and a case with rows that have no valid key (a
# window of 256 past 600 keys: rows 855..999 see none)
BWD_OFFSETS = [0, 120, 377, 500, 611, 800, 902, 963]
FLASH_BWD_CASES = [
    ("chunk", (1, ATTN_N // CHUNKS, ATTN_T, ATTN_D), False, 0, 0.0,
     "float64", None),
    ("chunk", (1, ATTN_N // CHUNKS, ATTN_T, ATTN_D), False, 0, 0.0,
     "float32", None),
    ("stablelm", (64, 4096, 4096, 80), True, 0, 0.0, "bfloat16", None),
    ("seamless_enc_cross", (32, 4096, 4096, 64), False, 0, 0.0,
     "bfloat16", None),
    ("gemma2_local", (8, 8192, 8192, 288), True, 4096, 50.0, "bfloat16",
     None),
    ("gemma2_train", (8, TRAIN_SEQ, TRAIN_SEQ, 288), True, 4096, 50.0,
     "bfloat16", None),
    ("ragged", (2, 1000, 777, 72), True, 0, 30.0, "float32", None),
    ("offset", (8, 37, 1000, 72), True, 0, 0.0, "float32", BWD_OFFSETS),
    ("offset", (8, 37, 1000, 64), True, 0, 0.0, "bfloat16", BWD_OFFSETS),
    ("empty_rows", (4, 1000, 600, 64), True, 256, 0.0, "float32", None),
    ("empty_rows", (4, 1000, 600, 64), True, 256, 0.0, "bfloat16", None)]
# the training runs (phase 11): bf16, full width, weights from the seed
# on the card, batches of the reference's pipeline at TRAIN_SEQ
# (train_4k's length; seamless's source frames too), each run's global
# batch (train_4k's 256 cut to fit one card), each config's own remat
# and moments (float32, or int8 where the config says opt_8bit), AdamW
# at TRAIN_LR. stablelm_3b, seamless_m4t_medium and gemma2_2b (D = 288:
# the bf16 backward's widest tensor-core tiles; 2.660 B parameters,
# 5.3 GB of bf16 weights, 10.6 GB of float32 gradient sums, 21.3 GB of
# moments) at full depth with their config's microbatch count.
# Jamba-1.5-Large cut to fit one card, no width cut: one period (8 of 72 layers: 7 Mamba, 1 attention, 4 MoE
# and 4 dense FFNs), 2 routed experts (of 16; top-2 kept), not padded to
# the production mesh's 16 (padding adds experts no token reaches), one
# set shared by the period's 4 MoE layers (each its own router; tied, so
# their gradient sums over the layers), global batch 1 in 1 microbatch
# (of 16): 7.673 B parameters, 15.3 GB of bf16 weights, as much of bf16
# gradient and of int8 moments, ~36 GB of one sequence's activations
# under remat. Its moments are the config's int8 ones at AdamW's eps of
# 1e-8, the reference's codec (one absmax scale a tensor): a second
# moment below 1/254 of its tensor's largest is stored as 0, and from
# step 2 on an element whose first moment survived and whose gradient
# falls to 0 steps by about m / 1e-8 (the reference's fault, ROADMAP
# Queue 3 entry 10; tests/test_torch_train.py shows the reference's
# optimizer doing so at this learning rate). Step 1's update reads no
# stored moment, so Jamba's loss check is on step 1's batch after step 1
# (``loss_steps``; at 4 steps on an H100 that loss rose 11.604 ->
# 11.799, the gradient norm 9.0 -> 40.3: PERF.md, section 6); the loss
# after all the steps is printed beside it. ``controls``: the faults
# each run's gradient gate must catch (attention's, or the scan
# backward's). ``resume``: the run whose step-2 checkpoint is saved,
# restored and resumed (seamless's, 12 s; stablelm's and Jamba's took
# 46 and 61 s of the smoke's 1200: PERF.md, section 6)
TRAIN_RUNS = {
    "train_stablelm": {"arch": "stablelm_3b", "batch": 2,
                       "controls": ("detached", "dk_zero")},
    "train_seamless": {"arch": "seamless_m4t_medium", "batch": 2,
                       "controls": ("detached", "dk_zero"), "resume": True},
    "train_jamba": {"arch": "jamba_1_5_large_398b", "batch": 1,
                    "layers": 8, "n_experts": 2, "microbatch": 1,
                    "share_experts": True, "expert_multiple": 1,
                    "loss_steps": 1,
                    "controls": ("scan_db_zero", "scan_carry_zero")},
    "train_gemma2": {"arch": "gemma2_2b", "batch": 2,
                     "controls": ("detached", "dk_zero")}}
TRAIN_STEPS, TRAIN_LR = 4, 3e-4
TRAIN_DATA_SEED = 1234
# step 1's gradient against its replay on the plain backward: every leaf
# within these (cosine at least, relative norm error at most), and the
# gradient norm and the loss within TRAIN_GATE["norm_rel"]. Set from the
# probe readings on an H100 (PERF.md, section 6): stablelm's worst leaf
# (layer 0's wq, bf16 dq rounded apart) at cosine 0.99997 and 0.0073 of
# its norm, seamless's at 1.0 and 0; both controls at cosine 0 and 1.0
TRAIN_GATE = {"cosine": 0.999, "norm_rel": 2e-2}
# what may stay allocated on the card when a training run starts, after
# the garbage of the earlier phases is collected (GiB; an H100 read
# 0.126, and 15.0 before the collection: PERF.md, section 6)
SETTLED_MAX_GIB = 1.0
# the planner on the card (phase 12): stablelm_3b at full width and
# depth, bf16, weights from the seed, batch 2 x 4096 tokens (train_4k's
# length); the shape-only and real op counts of one step must agree within
# PLANNER_FLOP_TOL (relative); PLANNER_STEPS steps of launch/train.py
PLANNER_ARCH, PLANNER_BATCH, PLANNER_SEQ = "stablelm_3b", 2, 4096
PLANNER_STEPS = 2
PLANNER_FLOP_TOL = 0.01
# phase 12 (d): the decode cell of PLANNER_ARCH after a prefill of
# DECODE_PROMPT tokens, DECODE_BATCH rows, caches DECODE_MAX_SEQ long
DECODE_BATCH, DECODE_PROMPT, DECODE_MAX_SEQ = 2, 4096, 4224
# phase 12 (e): the dry run's prefill cell of MOE_ARCH at full width and
# depth, MOE_BATCH rows of MOE_PROMPT tokens (each expert's capacity 640
# of the 65,536 assignments: some are dropped)
MOE_ARCH, MOE_BATCH, MOE_PROMPT = "olmoe_1b_7b", 2, 2048
# phase 12 (f): the dry run's train cell of JAMBA_CELL_RUN's model (its
# TRAIN_RUNS cuts: full width, one period, 2 experts not padded, one
# shared expert set), one row of TRAIN_SEQ tokens, under FSDP with no
# mesh axis for the experts (as (32, 8)'s plan gives them): loss and
# gradient only, against the plain step's
JAMBA_CELL_RUN = "train_jamba"
# phase 3 cases of the selective-scan kernel: (label, (B, L, I, N), dtype,
# whether the final state h_L is asked for)
SCAN_CASES = [
    ("chunk", (1, SCAN_L, SCAN_N // CHUNKS, 1), "float64", False),
    ("jamba", (1, 2048, 16384, 16), "float32", False),
    ("ragged", (2, 1000, 77, 4), "float64", False),
    ("ragged", (2, 1000, 77, 4), "float32", False),
    # the Jamba-1.5-Large layer at a 16k prompt: ~3.2 GB, many chunks
    ("jamba_long", (1, 16384, 16384, 16), "float32", False),
    # the final state (a prefill's, which decode takes): at the Jamba
    # layer, at a ragged L, in float64 at N = 32 (two passes of 16
    # states), and at the shortest and longest prompts phase 10 serves
    ("jamba_state", (1, 2048, 16384, 16), "float32", True),
    ("ragged_state", (2, 1000, 77, 4), "float32", True),
    ("split_state", (2, 1000, 77, 32), "float64", True),
    ("jamba_served", (1, min(JAMBA_LENS), 16384, 16), "float32", True),
    ("jamba_served", (1, max(JAMBA_LENS), 16384, 16), "float32", True)]
# phase 3 cases of the selective scan's backward: (label, (B, L, I, N),
# dtype, whether the final state's gradient dh_L seeds the adjoint). The
# Jamba-1.5-Large layer as phase 11 trains it (L = 4096), at phase 10's
# shortest and longest served prompts, ragged cases in float32 and
# float64, float64 at N = 32 (eight passes of 4 states) and dh_L
SCAN_BWD_CASES = [
    ("jamba_train", (1, TRAIN_SEQ, 16384, 16), "float32", False),
    ("jamba_served", (1, min(JAMBA_LENS), 16384, 16), "float32", False),
    ("jamba_served", (1, max(JAMBA_LENS), 16384, 16), "float32", False),
    ("ragged", (2, 1000, 77, 4), "float32", False),
    ("ragged", (2, 1000, 77, 4), "float64", False),
    ("split_state", (2, 1000, 77, 32), "float64", False),
    ("ragged_state", (2, 1000, 77, 4), "float64", True)]
# the scan backward's exps on the SFU (float32) or operations on the FP64
# units (float64) per (b, t, i, n) in its bound: h's step to t and the
# adjoint's step to t - 1 use the same dA_t = exp(dt_t A), so the
# function needs one exp; beside it ~12 operations (the state, the
# adjoint and the five products that feed the gradients)
SCAN_BWD_OPS = {"float64": 20 + 12, "float32": 12, "bfloat16": 12}

# the most spill bytes (stores, loads) ptxas may report for a function,
# by patterns of the mangled names checked (each must match a function):
# none for the float64 (DMMA) kernels of matmul (namespace f64), every
# instantiation of flash attention (the FMA and DMMA kernels, and bf16's
# tensor-core kernel, split-KV decode and its combine), of the scan and
# of its backward, and the flash
# attention backward's bf16 tensor-core kernels (mma_dkdv_kernel,
# mma_dq_kernel, every head dim); for the backward's FMA kernels (float64,
# float32), the most they spill (8/8 bytes; 8/32 while bf16 past D = 128
# ran them too, PERF.md section 6)
SPILL_MAX = {"matmul": [(r"3f64\d+\w*_kernel", (0, 0))],
             "flash_attention": [(r"flash_kernel", (0, 0)),
                                 (r"mma_fwd_kernel", (0, 0)),
                                 (r"decode_kernel", (0, 0)),
                                 (r"combine_kernel", (0, 0))],
             "mamba_scan": [(r"scan_kernel", (0, 0))],
             "mamba_scan_bwd": [(r"scan_bwd_(?:f64_)?kernel|sum_kernel",
                                 (0, 0))],
             "flash_attention_bwd": [(r"mma_d\w+_kernel", (0, 0)),
                                     (r"\d(?:dkdv|dq|delta)_kernel",
                                      (8, 8))]}
# the backward runs bf16 up to this head dim (every D it takes) on the
# tensor-core kernels (csrc/flash_attention_bwd.cu's MMA_MAX_D); phase 3
# checks by name that they ran and the FMA kernels did not
BWD_MMA_MAX_D = 288
# times before each kernel's Hopper redesign (PERF.md section 6), printed
# beside this run's: (kernel, case, dtype, ms, the commit and run of
# chip_smoke.py they come from). The bf16 forward's are the FMA kernel's
# with the regroup (PR 21's final run)
_PR21 = "commit 8cd25e6's final run, H100 80GB HBM3, 700 W"
EARLIER_MS = [
    ("matmul", "chunk", "float64", 2.271,
     "commit a5ae05a run 4, H100 80GB HBM3, 700 W"),
    ("flash_attention", "chunk", "float64", 1.347,
     "commit a5ae05a run 4, H100 80GB HBM3, 700 W"),
    ("flash_attention", "gemma2", "bfloat16", 20.931, _PR21),
    ("flash_attention", "gemma2_prefill", "bfloat16", 14.606, _PR21),
    ("flash_attention", "gemma2_decode_local", "bfloat16", 3.332, _PR21),
    ("flash_attention", "gemma2_decode_global", "bfloat16", 6.165, _PR21),
    ("flash_attention", "jamba_prefill", "bfloat16", 54.153, _PR21),
    ("flash_attention", "jamba_decode", "bfloat16", 4.106, _PR21),
    ("flash_attention_bwd", "stablelm", "bfloat16", 48.073,
     "commit 58c7205 run 5, H100 80GB HBM3, 700 W"),
    # the FMA kernels past D = 128
    ("flash_attention_bwd", "gemma2_local", "bfloat16", 77.263,
     "commit 702dffe's final run, H100 80GB HBM3, 700 W"),
    ("mamba_scan", "chunk", "float64", 1.588,
     "commit d9c8578 run 6, H100 80GB HBM3, 700 W"),
    ("mamba_scan_bwd", "jamba_train", "float32", 2.997,
     "commit 702dffe's final run, H100 80GB HBM3, 700 W")]

# max |kernel - plain| allowed, scaled like tests/test_kernels.py: the
# f32/bf16 tolerance applies both absolutely and relative to |plain|
TOL = {"float64": 1e-8, "float32": 2e-4, "bfloat16": 2e-2}
# the backward's gradients must also hold ||kernel - plain|| / ||plain||
# within these, each: set between an H100's readings of the kernel path
# against a wholly plain gradient (at most 2.5e-15, 2.1e-6 and 2.2e-3)
# and of the controls (at least 0.44; PERF.md, section 6)
BWD_NORM_TOL = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 1e-2}


def gemm_rowscale(A: "ndarray[f64,2]", B: "ndarray[f64,2]",
                  C: "ndarray[f64,2]", n: int, k: int, m: int):
    """The repo's matmul-shaped pfor (benchmarks/stap.py): the scaled row
    keeps the dot inside a pfor body, and the pattern matcher fuses the
    scale into the ``__cuk.matmul`` operand."""
    for i in range(0, n):
        r = 2.0 * A[i, 0:k]
        C[i, 0:m] = np.dot(r, B[0:k, 0:m])


def attn_kernel(Q: "ndarray[f64,2]", K: "ndarray[f64,2]",
                V: "ndarray[f64,2]", O: "ndarray[f64,2]",
                n: int, t: int, d: int):
    """The repo's attention-shaped pfor (tests/test_pallas_backend.py)."""
    for i in range(0, n):
        s = np.dot(K[0:t, 0:d], Q[i, 0:d])
        p = np.exp(s)
        o = np.dot(p, V[0:t, 0:d])
        O[i, 0:d] = o / np.sum(p)


def scan_kernel(X: "ndarray[f64,2]", Y: "ndarray[f64,2]",
                n: int, L: int):
    """The repo's scan-shaped pfor (tests/test_pallas_backend.py)."""
    for i in range(0, n):
        h = 0.0
        for t in range(0, L):
            h = 0.9 * h + X[i, t]
            Y[i, t] = h


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 20, host=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after a warm-up of at least 3 calls and 20 ms, each call waited for
    (a loop that only queued launches for 20 ms of host time queued
    hundreds of a 56 ms kernel's). A call whose host side (checks,
    allocations, the launch) takes longer than its kernel is timed at
    its host rate: with a list ``host``, the mean host milliseconds a
    call are appended to it."""
    t0 = time.perf_counter()
    calls = 0
    while calls < min(3, reps) or time.perf_counter() - t0 < 0.02:
        fn()
        torch.cuda.synchronize()
        calls += 1
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    if host is not None:
        host.append((time.perf_counter() - t0) * 1e3 / reps)
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(ops: float, nbytes: float, dtype: str, peak=None, exps=0.0):
    """(least ms, what bounds it): the larger of ``ops`` at ``peak`` (the
    dtype's peak by default) and ``exps`` on the SFU (both operations)
    against ``nbytes`` (each input read once, each output written once)
    at the memory's."""
    ops_s = max(ops / (peak or PEAK_FLOPS[dtype]), exps / SFU_EXP_S)
    bytes_s = nbytes / PEAK_BYTES_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def spills(log: str, pattern: str) -> dict:
    """{function: (spill store bytes, spill load bytes)} from ``ptxas -v``
    for every function whose mangled name matches ``pattern``."""
    found, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and fn is not None \
                and re.search(pattern, fn):
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            found[fn] = (nums[1], nums[2])    # stack, stores, loads
    return found


def _launch_once(kernel, fn):
    """Run ``fn`` once; it must launch ``kernel`` exactly once."""
    before = kernel.launches
    out = fn()
    if kernel.launches != before + 1:
        raise AssertionError(f"{kernel.__name__} did not count its launch")
    return out


def _within(torch, got, ref, dname):
    """(max |got - ref|, whether ``got`` is finite and within the
    tolerance of ``ref`` everywhere)."""
    torch.cuda.synchronize()
    diff = (got.double() - ref.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = TOL[dname]
    allowed = tol if dname == "float64" else tol + tol * ref.double().abs()
    return err, bool(torch.isfinite(got.double()).all()) \
        and not bool((diff > allowed).any())


def _compare(torch, name, label, got, ref, dname):
    """Max |got - ref|; raises past the tolerance."""
    err, ok = _within(torch, got, ref, dname)
    if not ok:
        raise AssertionError(f"{name} {label} {dname}: max err {err:.3e} "
                             f"over tolerance {TOL[dname]:g}")
    return err


def _row(torch, name, label, shape, dname, err, kernel_fn, plain_fn,
         library_fn, ops, nbytes, reps=20, peak=None, exps=0.0,
         yardstick=None, plain_reps=None, **extra):
    """One case's numbers. ``yardstick`` is (what, fn): a PyTorch call
    close to the case that does not compute the same function, timed as
    ``yardstick_ms`` beside ``library_ms`` (which stays None).
    ``plain_reps``: the plain version's launches timed (default a
    quarter of ``reps``, at least 2)."""
    host = []
    ms = _time_ms(torch, kernel_fn, reps, host)
    plain_ms = _time_ms(torch, plain_fn, plain_reps or max(2, reps // 4))
    lib_ms = _time_ms(torch, library_fn, reps) if library_fn else None
    if yardstick is not None:
        extra["yardstick"] = yardstick[0]
        extra["yardstick_ms"] = _time_ms(torch, yardstick[1], reps)
    bound_ms, bound_by = _bound(ops, nbytes, dname, peak, exps)
    row = {"case": label, "shape": shape, "dtype": dname,
           "max_abs_err": err, "tol": TOL[dname], "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "host_ms": host[0],
           "gops": ops / (ms * 1e-3) / 1e9, **extra}
    lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
    if yardstick is not None:
        lib += f" (yardstick: {yardstick[0]} {extra['yardstick_ms']:.3f} ms)"
    sfu = f"  (SFU roof {exps / SFU_EXP_S * 1e3:.4f} ms)" if exps else ""
    print(f"{name} {label:9s} {dname:8s} {shape}: err {err:.3e} "
          f"(tol {TOL[dname]:g})  kernel {ms:.3f} ms "
          f"({row['gops']:.1f} GOP/s, host {host[0]:.3f} ms a call)  "
          f"plain {plain_ms:.3f} ms  "
          f"library {lib}  bound {bound_ms:.4f} ms ({bound_by}){sfu}",
          flush=True)
    return row


def _dtypes(torch):
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}


def check_matmul(torch, mm_kernel, matmul_ref):
    """Phase 3: the matmul kernel against its plain version."""
    chunk = (N_ROWS // CHUNKS, K_DIM, M_DIM)   # main-path chunk
    cases = [("chunk", chunk, "float64"),
             ("square", (2048, 2048, 2048), "float64"),
             ("square", (2048, 2048, 2048), "float32"),
             ("square", (2048, 2048, 2048), "bfloat16"),
             ("ragged", (1000, 777, 1001), "float64"),
             ("ragged", (1000, 777, 1001), "float32"),
             ("ragged", (1000, 777, 1001), "bfloat16")]
    rng = np.random.default_rng(SEED)
    out = []
    for label, (m, k, n), dname in cases:
        dt = _dtypes(torch)[dname]
        x = torch.from_numpy(rng.normal(size=(m, k))).to("cuda", dt)
        y = torch.from_numpy(rng.normal(size=(k, n))).to("cuda", dt)
        got = _launch_once(mm_kernel, lambda: mm_kernel.matmul(x, y))
        err = _compare(torch, "matmul", label, got, matmul_ref(x, y), dname)
        out.append(_row(
            torch, "matmul", label, [m, k, n], dname, err,
            lambda: mm_kernel.matmul(x, y), lambda: matmul_ref(x, y),
            lambda: torch.matmul(x, y), 2.0 * m * k * n,
            (m * k + k * n + m * n) * x.element_size()))
    return out


def attention_work(sq: int, skv: int, causal: bool, window: int,
                   offset: int = 0):
    """(pairs, keys) of one head whose query row i sits at position
    offset + i: the (query, key) pairs its attention computes (the
    valid keys of each row, or every key for a row with none: it
    averages all of v, as the kernel and the reference do) and the keys
    it must read (the span of the rows' valid keys)."""
    q = offset + np.arange(sq)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros_like(q)
    hi = np.minimum(skv - 1, q) if causal else np.full_like(q, skv - 1)
    n = np.maximum(0, hi - lo + 1)
    keys = int(hi.max() - lo.min() + 1) if (n > 0).all() else skv
    return int(np.where(n > 0, n, skv).sum()), keys


def _sdpa_yardstick(torch, sdpa, q, k, v, causal, window):
    """(what, fn): ``scaled_dot_product_attention`` on a GQA layer's
    inputs (B, S, H, D), its keys and values repeated to every query
    head and its causal and sliding-window mask as a boolean matrix, all
    made before the timing. It computes no softcap, so it is a yardstick
    for the layer, not the same function."""
    rep = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (j <= i)
    if window > 0:
        mask = mask & (j > i - window)
    return ("scaled_dot_product_attention, causal+window mask, no "
            "softcap", lambda: sdpa(qh, kh, vh, attn_mask=mask))


def _flex_library(torch, q, k, v, causal, window, cap, options=None,
                  q_offset=None):
    """fn: ``flex_attention``, compiled, on a GQA layer's inputs (B, S,
    H, D) as (B, H, S, D): the softcap as its score_mod, the causal and
    sliding-window mask at each batch row's query offset (``q_offset``,
    (B,), or None) as its block mask, the key/value heads shared by
    ``enable_gqa``, its tiles set by ``options`` (None: its own
    choice): one PyTorch call that computes the layer's function,
    returning (B, H, S, D)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    off = None if q_offset is None else q_offset.to(torch.int64)

    def mask_mod(b, h, i, j):
        p = i if off is None else i + off[b]
        keep = j <= p if causal else j >= 0
        return keep & (j > p - window) if window > 0 else keep

    def score_mod(s, b, h, i, j):
        return torch.tanh(s / cap) * cap

    mask = create_block_mask(mask_mod, None if off is None else q.shape[0],
                             None, qh.shape[2], kh.shape[2],
                             device=q.device)
    # each case's mask and score functions are new closures, so each
    # compiles anew; past 8 compiles of one function dynamo runs the
    # unfused eager flex_attention instead (its recompile limit; phase 3
    # makes more than 8), so every case starts from an empty cache
    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(qh, kh, vh, score_mod=score_mod if cap else None,
                        block_mask=mask, enable_gqa=True,
                        kernel_options=options)


def _sdpa_gqa_library(torch, sdpa, q, k, v, causal, window, q_offset):
    """fn: ``scaled_dot_product_attention`` with ``enable_gqa`` on a GQA
    layer's inputs (B, S, H, D) as (B, H, S, D), the causal and
    sliding-window mask at each batch row's query offset (``q_offset``,
    (B,)) as a boolean (B, 1, Sq, Skv) mask, all made before the timing:
    one PyTorch call that computes a layer without softcap, returning
    (B, H, S, D)."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = torch.arange(q.shape[1], device=q.device)[None, :, None] \
        + q_offset.to(torch.int64)[:, None, None]            # (B, Sq, 1)
    j = torch.arange(k.shape[1], device=q.device)[None, None, :]
    mask = torch.ones((q.shape[0], q.shape[1], k.shape[1]),
                      dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= pos)
    if window > 0:
        mask = mask & (j > pos - window)
    mask = mask[:, None]
    return lambda: sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)


def _flash_inputs(rng, b, sq, h, kvh, skv, d):
    """q (B, Sq, H, D), k and v (B, Skv, KVH, D) in float64 on the host,
    drawn as FLASH_Q_STD says."""
    pushed = (np.arange(sq)[:, None] + np.arange(h)) % FLASH_PUSH == 0
    std = np.where(pushed, FLASH_Q_PUSHED, FLASH_Q_STD)[None, :, :, None]
    q = std * rng.normal(size=(b, sq, h, d))
    k = rng.normal(size=(b, skv, kvh, d))
    v = rng.normal(size=(b, skv, kvh, d))
    return q, k, v


def _flash_controls(torch, label, dname, plain, q, k, v, opts, want):
    """Negative controls of one flash case: ``plain`` on the same inputs
    with each row's softmax uniform over its mask (q = 0) and, where the
    case has a softcap, without the softcap. Each must fail the
    comparison the kernel passed (else that comparison could not tell
    such a kernel from a sound one); returns {control: max err}."""
    controls = {"uniform": (torch.zeros_like(q), opts)}
    if opts["softcap"]:
        controls["no_softcap"] = (q, {**opts, "softcap": 0.0})
    errs = {}
    for what, (cq, copts) in controls.items():
        errs[what], ok = _within(torch, plain(cq, k, v, **copts), want,
                                 dname)
        if ok:
            raise AssertionError(f"flash_attention {label} {dname}: the "
                                 f"{what} control passes the comparison "
                                 f"(max err {errs[what]:.3e})")
    return errs


def check_flash(torch, fa_kernel, fa_ops, fa_ref):
    """Phase 3: the flash-attention kernel against its plain version:
    (a) the attention path's chunk, (b) one gemma2_2b attention layer
    (B=1, S=8192, H=8, KVH=4, D=288, causal, window 4096, softcap 50;
    src/repro/configs/gemma2_2b.py) through the GQA dispatch, (c) the
    served LMs' prefill and per-slot decode shapes with query offsets
    (phase 9's, and phase 9b's in a worker),
    (d) a ragged case."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(SEED + 2)
    out = []
    for label, (b, sq, h, kvh, skv, d), causal, window, cap, dname, offs \
            in FLASH_CASES:
        t_case = time.perf_counter()
        dt = _dtypes(torch)[dname]
        q, k, v = (torch.from_numpy(t) for t in
                   _flash_inputs(rng, b, sq, h, kvh, skv, d))
        off = None if offs is None else torch.tensor(
            offs, dtype=torch.int32, device="cuda")
        opts = dict(causal=causal, window=window, softcap=cap)
        if off is not None:
            opts["q_offset"] = off
        yardstick = None
        if h == 1:                # one head: the kernel's own layout
            q, k, v = (t[:, :, 0].to("cuda", dt).contiguous()
                       for t in (q, k, v))
            kernel_fn = lambda: fa_kernel.flash_attention_bhsd(  # noqa: E731
                q, k, v, **opts)
            plain = fa_ref.flash_attention_bhsd_ref
            # one head per batch row, as (1, BH, S, D): on 3-d operands
            # SDPA took its math path (13.7 ms at stablelm's shape, 0.26
            # on 4-d)
            library_fn = None if (window or cap or off is not None) else \
                (lambda: sdpa(q[None], k[None], v[None], is_causal=causal))
        else:                     # a GQA layer through the dispatch
            q, k, v = (t.to("cuda", dt) for t in (q, k, v))
            kernel_fn = lambda: fa_ops.flash_attention(q, k, v,  # noqa: E731
                                                       **opts)
            plain = fa_ref.attention_ref
            library_fn = None
            if dname != "float64" and off is None:
                yardstick = _sdpa_yardstick(torch, sdpa, q, k, v, causal,
                                            window)
        plain_fn = lambda: plain(q, k, v, **opts)  # noqa: E731
        got = _launch_once(fa_kernel, kernel_fn)
        want = plain_fn()
        err = _compare(torch, "flash_attention", label, got, want, dname)
        # the error against the output's scale, and the controls
        scale = float(want.double().abs().max())
        if not err <= TOL[dname] * scale:
            raise AssertionError(f"flash_attention {label} {dname}: max err "
                                 f"{err:.3e} over {TOL[dname]:g} of the "
                                 f"output's largest value {scale:.3e}")
        controls = _flash_controls(torch, label, dname, plain, q, k, v,
                                   opts, want)
        print(f"flash_attention {label} {dname}: output's largest value "
              f"{scale:.3f}, max err {err:.3e}; controls' max err "
              f"{json.dumps(controls)} (each fails the comparison)",
              flush=True)
        extra = {"out_scale": scale, "controls_max_abs_err": controls}
        if off is not None:
            extra["q_offset"] = offs
        if dname == "bfloat16":
            extra["kernels_run"], extra["device_ms"] = _fwd_route(
                torch, fa_kernel, label, b, sq, h, kvh, skv, d, kernel_fn)
        regrouped_call = h > 1 and dname != "bfloat16"
        if regrouped_call:
            # the dispatch's two parts: the kernel alone on the regrouped
            # tensors, and the regroup (transposes, K/V repeated over the
            # query-head groups) alone
            regrouped = fa_ops.regroup(q, k, v, 0 if off is None else off)
            bare = dict(causal=causal, window=window, softcap=cap,
                        q_offset=regrouped[3])
            extra["kernel_alone_ms"] = _time_ms(
                torch, lambda: fa_kernel.flash_attention_bhsd(
                    *regrouped[:3], **bare), 10)
            extra["regroup_ms"] = _time_ms(
                torch, lambda: fa_ops.regroup(q, k, v,
                                              0 if off is None else off), 10)
            del regrouped, bare
        if label in FLEX_TRIES and dname != "float64":
            # flex_attention as the library call, with the tiles of
            # FLEX_TRIES in turn; its build (Triton, at D = 288) or its
            # answer may fail: then library_ms stays None and the reasons
            # are kept. It is no part of the port.
            extra["library"] = "flex_attention (compiled)"
            extra["library_errors"] = []
            for options in FLEX_TRIES[label]:
                try:
                    library_fn = _flex_library(torch, q, k, v, causal,
                                               window, cap, options, off)
                    lib_err = float((library_fn().transpose(1, 2).double()
                                     - want.double()).abs().max())
                    if not lib_err <= TOL[dname] * (
                            1 + float(want.double().abs().max())):
                        raise AssertionError(f"max err {lib_err:.3e}")
                    extra["library_max_abs_err"] = lib_err
                    extra["library_options"] = options
                    break
                except Exception as exc:  # noqa: BLE001 - a yardstick
                    library_fn = None
                    why = f"{type(exc).__name__}: {exc}"[:400]
                    extra["library_errors"].append(
                        {"options": options, "error": why})
                    print(f"flash_attention {label} {dname}: "
                          f"flex_attention with tiles {options} not "
                          f"timed: {why}", flush=True)
            if library_fn is not None:
                print(f"flash_attention {label} {dname}: flex_attention "
                      f"with tiles {options}, max err {lib_err:.3e}",
                      flush=True)
        if label in SDPA_GQA:
            # one PyTorch call for a layer without softcap; it is no part
            # of the port, and a failure leaves library_ms None
            extra["library"] = ("scaled_dot_product_attention("
                                "enable_gqa=True), boolean mask")
            try:
                library_fn = _sdpa_gqa_library(torch, sdpa, q, k, v,
                                               causal, window, off)
                lib_err = float((library_fn().transpose(1, 2).double()
                                 - want.double()).abs().max())
                if not lib_err <= TOL[dname] * (1 + scale):
                    raise AssertionError(f"max err {lib_err:.3e}")
                extra["library_max_abs_err"] = lib_err
                print(f"flash_attention {label} {dname}: "
                      f"{extra['library']}, max err {lib_err:.3e}",
                      flush=True)
            except Exception as exc:  # noqa: BLE001 - a yardstick
                library_fn = None
                why = f"{type(exc).__name__}: {exc}"[:400]
                extra["library_errors"] = [{"error": why}]
                print(f"flash_attention {label} {dname}: "
                      f"{extra['library']} not timed: {why}", flush=True)
        # per batch row: its pairs and the keys it must read
        work = [attention_work(sq, skv, causal, window,
                               0 if offs is None else offs[i])
                for i in range(b)]
        pairs = h * sum(p for p, _ in work)
        nbytes = (2 * b * sq * h * d + 2 * sum(n for _, n in work) * kvh
                  * d) * q.element_size()
        out.append(_row(
            torch, "flash_attention", label, [b, sq, h, kvh, skv, d], dname,
            err, kernel_fn, plain_fn, library_fn, 4.0 * pairs * d, nbytes,
            reps=10, causal=causal, window=window, softcap=cap,
            yardstick=yardstick, **extra))
        if regrouped_call:
            print(f"flash_attention {label} {dname}: dispatch "
                  f"{out[-1]['ms']:.3f} ms = kernel alone "
                  f"{extra['kernel_alone_ms']:.3f} ms on the regrouped "
                  f"tensors + regroup {extra['regroup_ms']:.3f} ms",
                  flush=True)
        out[-1]["case_s"] = time.perf_counter() - t_case
        print(f"flash_attention {label} {dname}: case took "
              f"{out[-1]['case_s']:.1f} s", flush=True)
        del q, k, v, got, want, yardstick, library_fn
        torch.cuda.empty_cache()
    return out


def _profiled_kernels(torch, fn, want) -> tuple:
    """({kernel: launches} of calls of ``fn`` by name from
    ``torch.profiler``, {kernel: mean device ms a launch}, traced calls,
    traces). A trace of one short call came back without some of its
    kernels, or none (a 0.1 ms case: none in 4 traces), and a trace's
    last kernel went missing in every one of 4 traces (the 77 ms gemma2
    backward's dQ, after phase 3's forward traces), so each trace waits
    50 ms once the profiler has started, repeats the call for at least
    50 ms and ends with a sentinel kernel (``torch.cuda._sleep``'s
    ``spin_kernel``, not counted) and 50 ms more; while a kernel of
    ``want`` is missing the trace is taken again, up to 4 times, their
    kernels counted together."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    ran, device_ms = {}, {}
    calls = 0
    for attempt in range(4):
        with torch.profiler.profile(activities=[cuda]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.05 or not calls:
                fn()
                torch.cuda.synchronize()
                calls += 1
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                found = re.search(r"(\w+_kernel)\b", e.name)
                name = found.group(1) if found else e.name
                if name != "spin_kernel":
                    ran[name] = ran.get(name, 0) + 1
                    device_ms[name] = device_ms.get(name, 0.0) \
                        + e.device_time_total / 1e3
        if want <= set(ran):
            break
    return ran, {n: device_ms[n] / ran[n] for n in ran}, calls, attempt + 1


def _fwd_route(torch, fa_kernel, label, b, sq, h, kvh, skv, d,
               kernel_fn) -> tuple:
    """({kernel: launches}, device ms a call: the kernels' mean launches
    summed) of a bf16 forward case's calls (torch.profiler; a short call's
    CUDA-event time is its host's). The case must have run exactly the
    kernels its shape asks for: the
    split-KV decode (decode_kernel, and combine_kernel where the call
    takes more than one split) where Sq x G <= FWD_DEC_ROWS, else the
    tensor-core kernel (mma_fwd_kernel); never the FMA flash_kernel, and
    nothing else (no regroup or copy kernel); fails otherwise."""
    if sq * (h // kvh) <= FWD_DEC_ROWS:
        split = h > 1 and fa_kernel._library().flash_attention_gqa_workspace(
            b, sq, skv, h, kvh, d) > 0
        want = {"decode_kernel"} | ({"combine_kernel"} if split else set())
    else:
        want = {"mma_fwd_kernel"}
    ran, mean_ms, calls, traces = _profiled_kernels(torch, kernel_fn, want)
    device_ms = sum(mean_ms.values())
    print(f"flash_attention {label} bfloat16: kernels run {ran} in {calls} "
          f"traced calls ({traces} traces); expected {sorted(want)} alone; "
          f"device time a call {device_ms:.4f} ms", flush=True)
    if set(ran) != want:
        raise AssertionError(f"flash_attention {label} bfloat16: ran "
                             f"{sorted(ran)}, not {sorted(want)} alone")
    return ran, device_ms


def _sdpa_bwd_library(torch, sdpa, q, k, v, do, causal):
    """fn: the backward of ``scaled_dot_product_attention`` (one head
    per batch row of the kernel's (BH, S, D) layout, the causal mask as
    ``is_causal``) through ``torch.autograd.grad`` on a graph built
    before the timing: one PyTorch call for the gradient of a case
    without window or softcap. Returns (dq, dk, dv)."""
    qg, kg, vg = (t.detach()[None].requires_grad_(True) for t in (q, k, v))
    out = sdpa(qg, kg, vg, is_causal=causal)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do[None],
                                       retain_graph=True)


def _flex_bwd_library(torch, q, k, v, do, causal, window, cap, options):
    """fn: the backward of compiled ``flex_attention`` (``_flex_library``
    on the kernel's (BH, S, D) layout as one batch row of BH heads: the
    softcap as its score_mod, the causal and sliding-window mask as its
    block mask, tiles ``options``) through ``torch.autograd.grad`` on a
    graph built before the timing: one PyTorch call for the gradient of
    a case with a softcap. Returns (dq, dk, dv), each (1, BH, S, D)."""
    qg, kg, vg = (t.detach()[None].requires_grad_(True) for t in (q, k, v))
    out = _flex_library(torch, *(t.transpose(1, 2) for t in (qg, kg, vg)),
                        causal, window, cap, options)()
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do[None],
                                       retain_graph=True)


def _sdpa_mask_bwd_library(torch, sdpa, q, k, v, do, mask):
    """fn: the backward of ``scaled_dot_product_attention`` with the
    kernel's mask (at the case's query offsets) as an additive mask of
    0 and -1e30, one head per batch row, through ``torch.autograd.grad``
    on a graph built before the timing: as in the kernel, a row with no
    valid key is uniform over the keys. Returns (dq, dk, dv)."""
    qg, kg, vg = (t.detach()[None].requires_grad_(True) for t in (q, k, v))
    add = torch.zeros(mask.shape, dtype=q.dtype, device=q.device) \
        .masked_fill(~mask, -1e30)
    out = sdpa(qg, kg, vg, attn_mask=add if add.dim() == 3 else add[None])
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do[None],
                                       retain_graph=True)


def _bwd_faulty(torch, fa_ref, q, k, v, o, do, lse, *, causal, window,
                softcap, fault, q_offset=None):
    """The plain backward's steps (``flash_attention_bhsd_bwd_ref``) with
    one fault, a negative control: ``"p_uniform"``, each row's P uniform
    over its mask; ``"no_cap_factor"``, dS without the softcap's
    (1 - tanh^2); ``"no_empty_rows"``, dV without the dO / Skv of the
    rows that have no valid key. Returns (dq, dk, dv) in q's dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    qa, ka, va, oa, da = (t.to(acc) for t in (q, k, v, o, do))
    x = (qa @ ka.transpose(-1, -2)) * scale
    if softcap:
        t = torch.tanh(x / softcap)
        x = t * softcap
    mask = fa_ref._mask(q.shape[1], k.shape[1], causal, window, q.device,
                        q_offset)
    if fault == "p_uniform":
        p = (mask / mask.sum(dim=-1, keepdim=True).clamp(min=1)).to(acc)
    else:
        p = torch.where(mask, torch.exp(x - lse.to(acc)[..., None]),
                        torch.zeros((), dtype=acc, device=q.device))
    delta = (da * oa).sum(dim=-1)
    dv = p.transpose(-1, -2) @ da
    if fault != "no_empty_rows":
        empty = ~mask.any(dim=-1, keepdim=True)
        dv = dv + (empty.to(acc) * da).sum(dim=-2, keepdim=True) \
            / k.shape[1]
    ds = p * (da @ va.transpose(-1, -2) - delta[..., None])
    if softcap and fault != "no_cap_factor":
        ds = ds * (1 - t * t)
    dq = (ds @ ka) * scale
    dk = (ds.transpose(-1, -2) @ qa) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_within(torch, got, want, dname):
    """({gradient: [max |got - want|, ||got - want|| / ||want||]},
    whether each of dq, dk and dv is finite and within TOL element by
    element and BWD_NORM_TOL in norm)."""
    errs, ok = {}, True
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        err, within = _within(torch, g, w, dname)
        rel = _norm_err(g, w)
        errs[n] = [err, rel]
        ok = ok and within and rel <= BWD_NORM_TOL[dname]
    return errs, ok


def _norm_err(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    nw = float(want.double().norm())
    return float((got.double() - want.double()).norm()) / nw if nw \
        else float("inf")


def check_flash_bwd(torch, fa_kernel, fa_ref):
    """Phase 3: the flash attention's backward on FLASH_BWD_CASES. The
    forward kernel's logsumexp and output against the plain forward's;
    the backward kernels against the plain backward, both from the
    forward kernel's output and logsumexp (element by element and in
    norm), and three negative controls that must fail that comparison:
    dK zeroed, P uniform over each row's mask and, with a softcap, dS
    without its factor; and the kernel path as a whole (the forward
    kernel, then the backward kernels) against a wholly plain gradient
    (the plain backward from the plain forward's output and logsumexp),
    in norm: in bf16 the two forwards' outputs round apart by an ulp,
    which dS = P (dO V^T - rowsum(dO o)) magnifies in single elements.
    A second call must give the same bits (no atomics). Cases with query
    offsets or rows without a valid key take as their library call
    ``scaled_dot_product_attention`` with the kernel's mask added as 0
    and -1e30, which gives a row without a key the kernel's uniform
    weights."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(SEED + 5)
    out = []
    for label, (bh, sq, skv, d), causal, window, cap, dname, offsets in \
            FLASH_BWD_CASES:
        t_case = time.perf_counter()
        dt = _dtypes(torch)[dname]
        q, k, v = _bwd_inputs(torch, rng, bh, sq, skv, d, dt)
        do = torch.from_numpy(rng.normal(size=(bh, sq, d))).to("cuda", dt)
        off = None if offsets is None else torch.tensor(
            offsets, dtype=torch.int32, device="cuda")
        opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        mask = fa_ref._mask(sq, skv, causal, window, "cuda", off)
        empty = int((~mask.any(dim=-1)).sum()) * (1 if off is not None
                                                  else bh)
        o, lse = fa_kernel.flash_attention_bhsd(q, k, v, return_lse=True,
                                                **opts)
        o_ref, lse_ref = fa_ref.flash_attention_bhsd_ref(
            q, k, v, return_lse=True, **opts)
        # lse is float32 (float64 for float64 operands)
        acc = "float64" if dname == "float64" else "float32"
        lse_err = _compare(torch, "flash_attention", f"{label} lse", lse,
                           lse_ref, acc)
        o_err = _compare(torch, "flash_attention", f"{label} o", o, o_ref,
                         dname)
        before = fa_kernel.bwd_launches
        got = fa_kernel.flash_attention_bhsd_bwd(q, k, v, o, do, lse, **opts)
        if fa_kernel.bwd_launches != before + 1:
            raise AssertionError("the backward did not count its launch")
        kernel_fn = lambda: fa_kernel.flash_attention_bhsd_bwd(  # noqa: E731
            q, k, v, o, do, lse, **opts)
        plain_fn = lambda: fa_ref.flash_attention_bhsd_bwd_ref(  # noqa: E731
            q, k, v, o, do, lse, **opts)
        ran = _bwd_route(torch, label, dname, d, kernel_fn)
        again = kernel_fn()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label} {dname}: a "
                                 f"second call gave other bits")
        del again
        want = plain_fn()
        errs, ok = _bwd_within(torch, got, want, dname)
        scales = {n: float(w.double().abs().max())
                  for n, w in zip(("dq", "dk", "dv"), want)}
        whole = {n: _norm_err(g, w) for n, g, w in zip(
            ("dq", "dk", "dv"), got, fa_ref.flash_attention_bhsd_bwd_ref(
                q, k, v, o_ref, do, lse_ref, **opts))}
        print(f"flash_attention_bwd {label} {dname}: lse max err "
              f"{lse_err:.3e}, o max err {o_err:.3e}; [max err, norm err] "
              f"{errs} against the gradients' largest values {scales} "
              f"(tol {TOL[dname]:g}, norm {BWD_NORM_TOL[dname]:g}); the "
              f"kernel path's norm err against the wholly plain gradient "
              f"{whole}; a second call the same bits", flush=True)
        if not ok or not max(whole.values()) <= BWD_NORM_TOL[dname]:
            raise AssertionError(f"flash_attention_bwd {label} {dname}: "
                                 f"{errs}, whole path {whole}: over the "
                                 f"tolerance")
        # the controls, each against the same comparison
        faulty = {"dk_zero": lambda: (got[0], torch.zeros_like(got[1]),
                                      got[2]),
                  "p_uniform": lambda: _bwd_faulty(
                      torch, fa_ref, q, k, v, o, do, lse, **opts,
                      fault="p_uniform")}
        if cap:
            faulty["no_cap_factor"] = lambda: _bwd_faulty(
                torch, fa_ref, q, k, v, o, do, lse, **opts,
                fault="no_cap_factor")
        if empty:
            # the empty rows' uniform P left out of dV
            faulty["no_empty_rows"] = lambda: _bwd_faulty(
                torch, fa_ref, q, k, v, o, do, lse, **opts,
                fault="no_empty_rows")
        controls = {}
        for what, fn in faulty.items():
            controls[what], passes = _bwd_within(torch, fn(), want, dname)
            if passes:
                raise AssertionError(f"flash_attention_bwd {label} {dname}: "
                                     f"the {what} control passes the "
                                     f"comparison {controls[what]}")
        print(f"flash_attention_bwd {label} {dname}: controls' [max err, "
              f"norm err] {json.dumps(controls)} (each fails the "
              f"comparison)", flush=True)
        library_fn = None
        extra = {"errs": errs, "scales": scales, "lse_max_abs_err": lse_err,
                 "o_max_abs_err": o_err, "whole_path_norm_err": whole,
                 "controls": controls, "kernels_run": ran,
                 "q_offsets": offsets, "rows_without_a_key": empty}
        masked = off is not None or empty > 0
        flex = bool(window or cap) and not masked
        extra["library"] = "torch.autograd.grad through " + (
            "flex_attention (compiled)" if flex
            else "scaled_dot_product_attention" + (
                " with the mask added (0, -1e30)" if masked else ""))
        extra["library_errors"] = []
        for options in FLEX_BWD_TRIES.get(label, ()) if flex else (None,):
            # one PyTorch call for the same gradient; it is no part of the
            # port, and a failure (to build, or to agree) leaves
            # library_ms None with the reason printed
            try:
                library_fn = _flex_bwd_library(
                    torch, q, k, v, do, causal, window, cap, options) \
                    if flex else _sdpa_mask_bwd_library(
                        torch, sdpa, q, k, v, do, mask) if masked \
                    else _sdpa_bwd_library(torch, sdpa, q, k, v, do, causal)
                lib = library_fn()
                lib_err = max(float((a[0].double() - b.double()).abs().max())
                              for a, b in zip(lib, want))
                del lib
                if not lib_err <= TOL[dname] * (1 + max(scales.values())):
                    raise AssertionError(f"max err {lib_err:.3e}")
                extra["library_max_abs_err"] = lib_err
                if flex:
                    extra["library_options"] = options
                print(f"flash_attention_bwd {label} {dname}: "
                      f"{extra['library']} (tiles {options}), max err "
                      f"{lib_err:.3e}", flush=True)
                break
            except Exception as exc:  # noqa: BLE001 - a yardstick
                library_fn = None
                why = f"{type(exc).__name__}: {exc}"[:400]
                extra["library_errors"].append({"options": options,
                                                "error": why})
                print(f"flash_attention_bwd {label} {dname}: "
                      f"{extra['library']} (tiles {options}) not timed: "
                      f"{why}", flush=True)
        # five products of 2 D operations a valid pair (S, dO V^T, dV,
        # dK, dQ); q, k, v, o, dO and lse read once, dq, dk, dv written
        pairs = int(mask.sum()) if off is not None \
            else bh * attention_work(sq, skv, causal, window)[0]
        nbytes = bh * ((4 * sq + 4 * skv) * d * q.element_size()
                       + sq * lse.element_size())
        out.append(_row(
            torch, "flash_attention_bwd", label, [bh, sq, skv, d], dname,
            max(e for e, _ in errs.values()), kernel_fn, plain_fn,
            library_fn, 10.0 * pairs * d, nbytes, reps=5, causal=causal,
            window=window, softcap=cap, **extra))
        out[-1]["case_s"] = time.perf_counter() - t_case
        print(f"flash_attention_bwd {label} {dname}: case took "
              f"{out[-1]['case_s']:.1f} s", flush=True)
        del q, k, v, do, o, lse, o_ref, lse_ref, got, want, library_fn, \
            faulty, mask
        torch.cuda.empty_cache()
    return out


def _bwd_route(torch, label, dname, d, kernel_fn) -> dict:
    """{kernel: launches} of backward calls, by name from
    ``torch.profiler`` (``_profiled_kernels``). A bf16 case must have run
    the tensor-core kernels (mma_dkdv_kernel, mma_dq_kernel) and no FMA
    dK/dV or dQ kernel up to BWD_MMA_MAX_D (every D the kernels take),
    and the FMA kernels past it; fails otherwise."""
    mma = {"mma_dkdv_kernel", "mma_dq_kernel"}
    fma = {"dkdv_kernel", "dq_kernel"}
    want, not_want = (mma, fma) if d <= BWD_MMA_MAX_D else (fma, mma)
    if dname != "bfloat16":
        want = set()
    ran, _, calls, traces = _profiled_kernels(torch, kernel_fn, want)
    print(f"flash_attention_bwd {label} {dname}: kernels run {ran} in "
          f"{calls} traced calls ({traces} traces)", flush=True)
    if dname == "bfloat16":
        if not want <= set(ran) or not_want & set(ran):
            raise AssertionError(f"flash_attention_bwd {label} {dname} (D = "
                                 f"{d}): ran {sorted(ran)}, not {sorted(want)}"
                                 f" alone")
    return ran


def _bwd_inputs(torch, rng, bh, sq, skv, d, dt):
    """q (BH, Sq, D) at FLASH_Q_STD (every FLASH_PUSH-th row at
    FLASH_Q_PUSHED, past the softcap), k and v (BH, Skv, D) N(0, 1), on
    the card in ``dt``."""
    q, k, v = _flash_inputs(rng, bh, sq, 1, 1, skv, d)
    return tuple(torch.from_numpy(t[:, :, 0]).to("cuda", dt).contiguous()
                 for t in (q, k, v))


def check_scan(torch, sc_kernel, plain):
    """Phase 3: the selective-scan kernel against its plain version:
    (a) the scan path's chunk through api.scan_rows's mapping (B=1,
    I=rows, N=1, dt=1, B=C=1, a=log(-log c)), (b) one Jamba-1.5-Large
    Mamba layer (d_model 8192, ssm_expand 2 -> I=16384, ssm_state 16;
    src/repro/configs/jamba_1_5_large_398b.py) at L=2048 in float32, as
    the reference's models/ssm.py scans, (c) ragged cases, (d) the same
    layer at L=16384, (e) the final state h_L at the Jamba layer, a
    ragged L, float64 at N = 32 and phase 10's served prompt lengths
    (its y must be the bits of the call without it). float64
    operations count at the FP64 units' peak; float32 and bf16 exps at
    the SFU's rate."""
    rng = np.random.default_rng(SEED + 3)
    out = []
    for label, (b, length, inner, n), dname, state in SCAN_CASES:
        dt_ = _dtypes(torch)[dname]
        x = torch.from_numpy(rng.normal(size=(b, length, inner)))
        if label == "chunk":
            dt = torch.ones((b, length, inner), dtype=torch.float64)
            bm = cm = torch.ones((b, length, 1), dtype=torch.float64)
            a = torch.full((inner, 1), float(np.log(-np.log(SCAN_C))),
                           dtype=torch.float64)
            d_skip = torch.zeros((inner,), dtype=torch.float64)
        else:
            dt = torch.from_numpy(
                0.1 * np.abs(rng.normal(size=(b, length, inner))))
            bm = torch.from_numpy(rng.normal(size=(b, length, n)))
            cm = torch.from_numpy(rng.normal(size=(b, length, n)))
            a = torch.from_numpy(
                np.log(np.abs(rng.normal(size=(inner, n))) + 0.5))
            d_skip = torch.from_numpy(rng.normal(size=(inner,)))
        args = [t.to("cuda", dt_).contiguous()
                for t in (x, dt, bm, cm, a, d_skip)]
        kernel_fn = lambda: sc_kernel.mamba_scan(  # noqa: E731
            *args, return_state=state)
        plain_fn = lambda: plain(*args, return_state=state)  # noqa: E731
        got = _launch_once(sc_kernel, kernel_fn)
        want = plain_fn()
        extra = {}
        if state:
            (got, h), (want, want_h) = got, want
            # the state is float32 (bf16 and float32 inputs) or float64
            acc = "float64" if dname == "float64" else "float32"
            extra["state_max_abs_err"] = _compare(
                torch, "mamba_scan", f"{label} h_L", h, want_h, acc)
            if not torch.equal(got, sc_kernel.mamba_scan(*args)):
                raise AssertionError(f"mamba_scan {label}: y differs with "
                                     f"and without the final state")
        err = _compare(torch, "mamba_scan", label, got, want, dname)
        nbytes = sum(t.numel() for t in args) * args[0].element_size() \
            + got.numel() * got.element_size()
        if state:
            nbytes += h.numel() * h.element_size()
            print(f"mamba_scan {label} {dname}: h_L max err "
                  f"{extra['state_max_abs_err']:.3e}; y the same bits "
                  f"as without it", flush=True)
        steps = float(b * length * inner * n)
        out.append(_row(
            torch, "mamba_scan", label, [b, length, inner, n], dname, err,
            kernel_fn, plain_fn, None, steps * SCAN_OPS[dname], nbytes,
            reps=10, peak=PEAK_FP64_FMA if dname == "float64" else None,
            exps=0.0 if dname == "float64" else steps, final_state=state,
            **extra))
        del args, got, want
        torch.cuda.empty_cache()
    return out


def _scan_bwd_route(torch, label, dname, kernel_fn) -> dict:
    """{kernel: launches} of a scan-backward case's calls, by name from
    ``torch.profiler`` (``_profiled_kernels``): float32 and bf16 must run
    the redesigned ``scan_bwd_kernel``, float64 the first design's
    ``scan_bwd_f64_kernel``, each with its sums and not the other."""
    f64 = dname == "float64"
    want = {"scan_bwd_f64_kernel" if f64 else "scan_bwd_kernel",
            "sum_kernel"}
    other = "scan_bwd_kernel" if f64 else "scan_bwd_f64_kernel"
    ran, _, calls, traces = _profiled_kernels(torch, kernel_fn, want)
    print(f"mamba_scan_bwd {label} {dname}: kernels run {ran} in {calls} "
          f"traced calls ({traces} traces)", flush=True)
    if not want <= set(ran) or other in ran:
        raise AssertionError(f"mamba_scan_bwd {label} {dname}: ran "
                             f"{sorted(ran)}, not {sorted(want)} alone")
    return ran


def _scan_bwd_within(torch, got, want, dname):
    """({gradient: [max |got - want|, ||got - want|| / ||want||]},
    whether each of the six gradients is finite, within TOL of ``want``
    element by element (TOL times its largest value: dB, dC, da and
    dd_skip sum over thousands of channels or steps) and within
    BWD_NORM_TOL in norm)."""
    errs, ok = {}, True
    for n, g, w in zip(SCAN_GRADS, got, want):
        torch.cuda.synchronize()
        diff = (g.double() - w.double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        scale = float(w.double().abs().max()) if w.numel() else 0.0
        rel = _norm_err(g, w)
        errs[n] = [err, rel]
        ok = ok and bool(torch.isfinite(g.double()).all()) \
            and err <= TOL[dname] * (1.0 + scale) \
            and rel <= BWD_NORM_TOL[dname]
    return errs, ok


SCAN_GRADS = ("dx", "ddt", "dB", "dC", "da", "dd_skip")


def check_scan_bwd(torch, sc_kernel, sc_ref):
    """Phase 3: the selective scan's backward on SCAN_BWD_CASES. The
    forward kernel keeps its segments' entry states (its y the same bits
    as without them); the backward kernel from them, against the plain
    backward ``mamba_scan_bwd_ref`` in float64 on the same inputs (the
    float32 plain backward's own error is printed beside it), element by
    element and in norm; two negative controls must fail that
    comparison: dB zeroed, and the kernel's decomposition without the
    adjoint's carry between chunks (``mamba_scan_bwd_chunked_ref(...,
    carry=False)``); and a second call gives the same bits. The bound:
    x, dt, dy read and dx, ddt written once (B, C, a, d_skip and their
    gradients beside them) against one exp per (b, t, i, n) on the SFU
    (float32) or SCAN_BWD_OPS operations on the FP64 units (float64). No
    PyTorch call computes this gradient (autograd through the plain
    scan is the plain version's time)."""
    rng = np.random.default_rng(SEED + 9)
    out = []
    for label, (b, length, inner, n), dname, state in SCAN_BWD_CASES:
        t_case = time.perf_counter()
        dt_ = _dtypes(torch)[dname]
        acc = torch.promote_types(dt_, torch.float32)
        host = [rng.normal(size=(b, length, inner)),
                0.1 * np.abs(rng.normal(size=(b, length, inner))),
                rng.normal(size=(b, length, n)),
                rng.normal(size=(b, length, n)),
                np.log(np.abs(rng.normal(size=(inner, n))) + 0.5),
                rng.normal(size=(inner,)),
                rng.normal(size=(b, length, inner))]
        args = [torch.from_numpy(a).to("cuda", dt_).contiguous()
                for a in host]
        dh = torch.from_numpy(rng.normal(size=(b, inner, n))).to(
            "cuda", acc) if state else None
        del host
        y, _, states = sc_kernel.mamba_scan(*args[:6], save_states=True)
        if not torch.equal(y, sc_kernel.mamba_scan(*args[:6])):
            raise AssertionError(f"mamba_scan_bwd {label}: y differs with "
                                 f"and without the states")
        before = sc_kernel.bwd_launches
        got = sc_kernel.mamba_scan_bwd(*args, states, dh_last=dh)
        if sc_kernel.bwd_launches != before + 1:
            raise AssertionError("the scan backward did not count its "
                                 "launch")
        kernel_fn = lambda: sc_kernel.mamba_scan_bwd(  # noqa: E731
            *args, states, dh_last=dh)
        plain_fn = lambda: sc_ref.mamba_scan_bwd_ref(  # noqa: E731
            *args, dh_last=dh)
        want = sc_ref.mamba_scan_bwd_ref(
            *(t.double() for t in args),
            dh_last=None if dh is None else dh.double())
        errs, ok = _scan_bwd_within(torch, got, want, dname)
        plain_errs, _ = _scan_bwd_within(torch, plain_fn(), want, dname)
        print(f"mamba_scan_bwd {label} {dname}: [max err, norm err] "
              f"against the float64 plain backward {json.dumps(errs)} "
              f"(tol {TOL[dname]:g} x (1 + largest value), norm "
              f"{BWD_NORM_TOL[dname]:g}); the {dname} plain backward's "
              f"{json.dumps(plain_errs)}", flush=True)
        if not ok:
            raise AssertionError(f"mamba_scan_bwd {label} {dname}: {errs} "
                                 f"over the tolerance")
        again = kernel_fn()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"mamba_scan_bwd {label} {dname}: a "
                                 f"second call gave other bits")
        del again
        ran = _scan_bwd_route(torch, label, dname, kernel_fn)
        faulty = {"db_zero": lambda: (*got[:2], torch.zeros_like(got[2]),
                                      *got[3:]),
                  "carry_zero": lambda: sc_ref.mamba_scan_bwd_chunked_ref(
                      *args, dh_last=dh, carry=False)}
        controls = {}
        for what, fn in faulty.items():
            controls[what], passes = _scan_bwd_within(torch, fn(), want,
                                                      dname)
            if passes:
                raise AssertionError(f"mamba_scan_bwd {label} {dname}: the "
                                     f"{what} control passes the "
                                     f"comparison {controls[what]}")
        print(f"mamba_scan_bwd {label} {dname}: controls' [max err, norm "
              f"err] {json.dumps(controls)} (each fails the comparison); "
              f"the same bits on a second call", flush=True)
        del want
        steps = float(b * length * inner * n)
        nbytes = (5 * b * length * inner + 4 * b * length * n
                  + 2 * inner * n + 2 * inner) * args[0].element_size() \
            + (dh.numel() * dh.element_size() if state else 0)
        f64 = dname == "float64"
        out.append(_row(
            torch, "mamba_scan_bwd", label, [b, length, inner, n], dname,
            max(e for e, _ in errs.values()), kernel_fn, plain_fn, None,
            steps * SCAN_BWD_OPS[dname], nbytes, reps=10,
            peak=PEAK_FP64_FMA if f64 else None,
            exps=0.0 if f64 else steps, plain_reps=1,
            final_state_grad=state, errs=errs, plain_errs=plain_errs,
            controls=controls, kernels_run=ran))
        out[-1]["case_s"] = time.perf_counter() - t_case
        print(f"mamba_scan_bwd {label} {dname}: case took "
              f"{out[-1]['case_s']:.1f} s", flush=True)
        del args, got, states, y, faulty
        torch.cuda.empty_cache()
    return out


def _record_pricing(cost):
    """Wrap the router's pricing table so each pfor round's per-worker
    prices (t_np, t_torch, t_cuda and the pick) can be printed."""
    seen = []
    table = cost.unit_backend_table

    def recording(flops, nbytes, profiles, candidates=()):
        profiles = list(profiles)
        picks = table(flops, nbytes, profiles, candidates)
        seen.append([{
            "wid": p.wid, "flops": flops, "bytes": nbytes,
            "t_np": cost.chunk_backend_seconds(flops, nbytes, p, "np"),
            "t_torch": cost.chunk_backend_seconds(flops, nbytes, p,
                                                  "torch"),
            "t_cuda": cost.chunk_backend_seconds(flops, nbytes, p, "cuda"),
            "pick": pick} for p, pick in zip(profiles, picks)])
        return picks

    cost.unit_backend_table = recording
    return seen


def _timeline(rt, obs, before):
    """The head's phase seconds since ``before`` (a phase breakdown) and
    the seconds per traced span name recorded since the recorder was
    last cleared, head and worker tracks together (the worker spans:
    deserialize, restore, run = the chunk body, diff)."""
    phases = {k: round(v - before.get(k, 0.0), 4)
              for k, v in sorted(rt.phase_breakdown().items())}
    spans = {}
    for ev in obs.recorder().events():
        spans[ev.name] = round(spans.get(ev.name, 0.0) + ev.dur, 4)
    return phases, dict(sorted(spans.items()))


def timed_run(rt, obs, ck, pricing, *, name, label, inputs, out_index,
              rows, during=None):
    """One run of a path's compiled kernel on the fleet: its wall, the
    bytes shipped, the router's prices, the head's phase seconds and the
    traced spans, printed on one line. It fails on any fault counted in
    the run unless ``during`` (started just before the run, e.g. a
    worker kill) caused it."""
    before = rt.phase_breakdown()
    st0 = rt.stats()
    obs.recorder().clear()
    args = list(inputs)
    args[out_index] = np.zeros_like(inputs[out_index])
    del pricing[:]
    if during is not None:
        during.start()
    t0 = time.perf_counter()
    ck.call_variant("np", *args)
    wall = time.perf_counter() - t0
    phases, spans = _timeline(rt, obs, before)
    st1 = rt.stats()
    faults = {k: v - st0["faults"].get(k, 0)
              for k, v in st1["faults"].items()
              if v != st0["faults"].get(k, 0)}
    print(f"{name} path {label}: {wall:.3f} s ({rows / wall:.1f} "
          f"rows/s); bytes shipped "
          f"{st1['bytes_shipped'] - st0['bytes_shipped']}; faults "
          f"{json.dumps(faults)}; router {json.dumps(pricing)}; "
          f"phases (s) {json.dumps(phases)}; spans (s) "
          f"{json.dumps(spans)}", flush=True)
    if faults and during is None:
        raise AssertionError(f"{name} path {label} counted faults: "
                             f"{json.dumps(faults)}")
    return args[out_index], wall


def run_path(rt, compile_kernel, obs, kernel, pricing, *, name, fn, twin,
             inputs, out_index, want, rows):
    """Phase 4, one path: compile ``fn``, zero every count, run it cold
    and warm on the fleet, check the counts and the results."""
    ck = compile_kernel(fn, runtime=rt, workers=WORKERS)
    if twin not in ck.source("np"):
        raise AssertionError(f"{name}: compiler emitted no {twin} twin")
    ck.pfor_config.distribute_threshold = 0
    key = f"{name}_launches"

    def run(label):
        return timed_run(rt, obs, ck, pricing, name=name, label=label,
                         inputs=inputs, out_index=out_index, rows=rows)

    # every count to 0 just before the path's runs
    kernel.launches = 0
    for k in (key, "cuda_calls", "cuda_plain_calls", "cuda_chunks",
              "cuda_fallbacks"):
        setattr(rt, k, 0)
    rt.chunks_executed.clear()
    out, wall = run("cold")
    out2, warm = run("warm")
    st = rt.stats()
    launches = int(st[key]) + kernel.launches
    err = float(np.abs(out - want).max())
    err2 = float(np.abs(out2 - want).max())
    executed = dict(st["chunks_executed"])
    print(f"{name} path: cold + warm: chunks executed {executed}, "
          f"cuda_fallbacks {st['cuda_fallbacks']}, cuda_calls "
          f"{st['cuda_calls']}, plain calls {st['cuda_plain_calls']}, "
          f"{key} {launches}; max err {err:.3e} / {err2:.3e}", flush=True)
    if set(executed) != {"cuda"}:
        raise AssertionError(f"{name}: not every chunk ran on cuda: "
                             f"{executed}")
    if st["cuda_fallbacks"] != 0:
        raise AssertionError(f"{name}: {st['cuda_fallbacks']} cuda "
                             f"fallbacks")
    if not st["cuda_calls"] > 0 or st["cuda_plain_calls"] != 0:
        raise AssertionError(f"{name}: cuda_calls {st['cuda_calls']}, "
                             f"plain {st['cuda_plain_calls']}")
    if launches <= 0:
        raise AssertionError(f"the {name} path launched no {name} kernel")
    if not (np.isfinite(out).all() and err <= 1e-8 and err2 <= 1e-8):
        raise AssertionError(f"{name} path max err {err:.3e} / {err2:.3e}")
    return {"launches": launches, "wall_s": wall, "warm_s": warm,
            "max_abs_err": max(err, err2), "chunks_executed": executed}


def _attention_reference(Q, K, V):
    O = np.empty_like(Q)
    for i in range(0, len(Q), 2048):
        p = np.exp(Q[i:i + 2048] @ K.T)
        O[i:i + 2048] = (p @ V) / p.sum(axis=1, keepdims=True)
    return O


def _scan_reference(X):
    Y = np.empty_like(X)
    h = np.zeros(len(X))
    for t in range(X.shape[1]):
        h = SCAN_C * h + X[:, t]
        Y[:, t] = h
    return Y


def main_paths(rt, compile_kernel, obs, cost, kernels):
    """Phase 4: the three paths on one fleet."""
    for p in rt.profiles():
        print(f"worker {p.wid}: gpu {p.gpu_kind} f64 GEMM probe "
              f"{p.gpu_gflops:.1f} GFLOP/s, h2d {p.h2d_gbs:.2f} GB/s, "
              f"d2h {p.d2h_gbs:.2f} GB/s, host {p.gflops:.1f} GFLOP/s, "
              f"host copy {p.membw_gbs:.2f} GB/s", flush=True)
    pricing = _record_pricing(cost)
    rng = np.random.default_rng(SEED + 1)
    out = {}

    A = rng.normal(size=(N_ROWS, K_DIM))
    B = rng.normal(size=(K_DIM, M_DIM))
    out["matmul"] = run_path(
        rt, compile_kernel, obs, kernels["matmul"], pricing, name="matmul",
        fn=gemm_rowscale, twin="__cuk.matmul(",
        inputs=(A, B, np.zeros((N_ROWS, M_DIM)), N_ROWS, K_DIM, M_DIM),
        out_index=2, want=(2.0 * A) @ B, rows=N_ROWS)
    del A, B

    std = ATTN_D ** -0.25
    Q = std * rng.normal(size=(ATTN_N, ATTN_D))
    K = std * rng.normal(size=(ATTN_T, ATTN_D))
    V = rng.normal(size=(ATTN_T, ATTN_D))
    out["flash_attention"] = run_path(
        rt, compile_kernel, obs, kernels["flash_attention"], pricing,
        name="flash_attention", fn=attn_kernel,
        twin="__cuk.attention_rows(",
        inputs=(Q, K, V, np.zeros((ATTN_N, ATTN_D)), ATTN_N, ATTN_T,
                ATTN_D),
        out_index=3, want=_attention_reference(Q, K, V), rows=ATTN_N)
    del Q, K, V

    X = rng.normal(size=(SCAN_N, SCAN_L))
    out["mamba_scan"] = run_path(
        rt, compile_kernel, obs, kernels["mamba_scan"], pricing,
        name="mamba_scan", fn=scan_kernel, twin="__cuk.scan_rows(",
        inputs=(X, np.zeros((SCAN_N, SCAN_L)), SCAN_N, SCAN_L),
        out_index=1, want=_scan_reference(X), rows=SCAN_N)
    return out


def _stap_recurrence(torch, snap, train, steer, k, iters, alpha, loading):
    """Every gate's STAP output on the card, in float64, computed apart
    from the port: the Richardson solve batched over gates with
    ``torch.bmm``, 1024 gates at a time."""
    out = np.empty(len(snap))
    s = torch.from_numpy(steer).cuda()
    for lo in range(0, len(snap), 1024):
        T = torch.from_numpy(train[lo:lo + 1024]).cuda()
        R = torch.bmm(T.transpose(1, 2), T) / k
        w = (alpha * s).expand(len(T), -1).clone()
        for _ in range(iters):
            Rw = torch.bmm(R, w[:, :, None])[:, :, 0]
            w = w + alpha * (s - Rw - loading * w)
        x = torch.from_numpy(snap[lo:lo + 1024]).cuda()
        out[lo:lo + len(T)] = (w * x).sum(1).cpu().numpy()
    return out


def stap_path(rt, compile_kernel, obs, pricing, torch):
    """Phase 5: the STAP flagship on the fleet through its torch twin."""
    sys.path.insert(0, str(ROOT))
    from examples.torch_stap import (ALPHA, DOF, ITERS, K_TRAIN, LOADING,
                                     make_stap_data, stap_adaptive,
                                     stap_seq)
    snap, train, steer, out = make_stap_data(gates=STAP_GATES)
    scalars = (STAP_GATES, K_TRAIN, DOF, ITERS, ALPHA, LOADING)
    t0 = time.perf_counter()
    want = _stap_recurrence(torch, snap, train, steer, K_TRAIN, ITERS,
                            ALPHA, LOADING)
    t1 = time.perf_counter()
    sample = np.arange(0, STAP_GATES, STAP_GATES // STAP_SAMPLE)
    seq = np.zeros(len(sample))
    stap_seq(snap[sample], train[sample], steer, seq, len(sample),
             *scalars[1:])
    ref_gap = float(np.abs(want[sample] - seq).max())
    print(f"stap references: card recurrence for {STAP_GATES} gates in "
          f"{t1 - t0:.3f} s, numpy stap_seq for {len(sample)} gates in "
          f"{time.perf_counter() - t1:.3f} s; they differ by "
          f"{ref_gap:.3e}", flush=True)
    if not ref_gap <= 1e-8:
        raise AssertionError(f"stap references disagree: {ref_gap:.3e}")

    ck = compile_kernel(stap_adaptive, runtime=rt, workers=WORKERS)
    src = ck.source("np")
    if "__pfor_body_0__torch" not in src or "__pfor_batch(" not in src:
        raise AssertionError("stap: no torch twin with a batched path")
    ck.pfor_config.distribute_threshold = 0
    inputs = (snap, train, steer, out) + scalars
    keys = ("torch_chunks", "torch_fallbacks", "cuda_fallbacks",
            "batch_hits", "batch_builds", "batch_fallbacks",
            "worker_deaths", "resubmits")

    def run(label, during=None):
        st0 = rt.stats()
        got, wall = timed_run(rt, obs, ck, pricing, name="stap", label=label,
                              inputs=inputs, out_index=3, rows=STAP_GATES,
                              during=during)
        st1 = rt.stats()
        d = {k: st1[k] - st0[k] for k in keys}
        ran = {b: n - st0["chunks_executed"].get(b, 0)
               for b, n in st1["chunks_executed"].items()
               if n != st0["chunks_executed"].get(b, 0)}
        by_worker = {w: n - st0["chunks_executed_by_worker"].get(w, 0)
                     for w, n in st1["chunks_executed_by_worker"].items()
                     if n != st0["chunks_executed_by_worker"].get(w, 0)}
        err = float(np.abs(got - want).max())
        err_seq = float(np.abs(got[sample] - seq).max())
        print(f"stap path {label}: chunks executed {ran} (by worker "
              f"{by_worker}); {json.dumps(d)}; max err {err:.3e} (card "
              f"recurrence), {err_seq:.3e} (stap_seq sample)", flush=True)
        if set(ran) != {"torch"}:
            raise AssertionError(f"stap {label}: not every chunk ran the "
                                 f"torch twin: {ran}")
        if d["torch_fallbacks"] or d["cuda_fallbacks"] \
                or d["batch_fallbacks"]:
            raise AssertionError(f"stap {label}: fallbacks {json.dumps(d)}")
        if not (np.isfinite(got).all() and err <= 1e-8
                and err_seq <= 1e-8):
            raise AssertionError(f"stap {label}: max err {err:.3e} / "
                                 f"{err_seq:.3e}")
        return {"wall_s": wall, "max_abs_err": max(err, err_seq),
                "chunks_executed": ran, "by_worker": by_worker, **d}

    out_runs = {"cold": run("cold"), "warm": run("warm")}
    if out_runs["warm"]["batch_hits"] <= 0:
        raise AssertionError("stap warm: no batched-path hit")
    # the kill drill: a worker dies a third of the way into a run
    before = {p.wid for p in rt.profiles()}
    killer = threading.Timer(max(0.05, out_runs["warm"]["wall_s"] / 3),
                             rt.kill_worker)
    out_runs["kill"] = run("kill drill", during=killer)
    killer.cancel()
    if out_runs["kill"]["worker_deaths"] != 1:
        raise AssertionError("stap kill drill: no worker died")
    t0 = time.perf_counter()
    # the replacement takes chunks once its device profile is in (a pfor
    # routes over rt.profiles()), which can come after it is alive
    while len(rt.profiles()) < WORKERS:
        if time.perf_counter() - t0 > 180:
            raise AssertionError("stap kill drill: no replacement worker")
        time.sleep(0.5)
    print(f"stap kill drill: replacement up {time.perf_counter() - t0:.1f}"
          f" s after the drill's run", flush=True)
    out_runs["after"] = run("after the drill")
    new = {w: n for w, n in out_runs["after"]["by_worker"].items()
           if w not in before}
    if not new:
        raise AssertionError("stap: the replacement worker ran no chunk")
    out_runs["chunk"] = stap_chunk_profile(torch, ck, inputs,
                                           STAP_GATES // CHUNKS)
    return out_runs


def stap_ops_per_gate(k, dof, iters):
    """Operations one gate of stap_adaptive needs: R = TᵀT and its
    scaling, each Richardson step's product R·w (2·dof²) and five vector
    operations, and the beamforming dot."""
    return 2 * k * dof * dof + dof * dof + iters * (2 * dof * dof
                                                   + 5 * dof) + 2 * dof


def stap_chunk_profile(torch, ck, inputs, rows):
    """The torch twin of the STAP gate loop on one main-path chunk
    (``rows`` gates) in this process, on the card, as a warm worker runs
    it (its rows and cells already resident on the card): its wall (host
    clock around a synchronised call), the device time and the number of
    kernels in it (``torch.profiler``), against the least time the card
    could take for the chunk's operations (float64 on the tensor cores)
    and bytes (its training rows, snapshots and outputs)."""
    from repro_torch.core import backends, txp
    from repro_torch.distrib import accel

    txp.set_device("cuda")
    gen = ck.variants["np"].generated
    ns = {"xp": np}
    for b in gen.meta.pfor_twin_units:
        ns.update(backends.get(b).namespace(gen.meta))
    ns["__pfor_run"] = lambda body, lo, hi, tile: body.__torch__(0, rows)
    exec(compile(gen.source, "<stap chunk>", "exec"), ns)
    # the chunk's rows, kept resident as a worker keeps its row cache
    # and broadcast cells
    args = [inputs[0][:rows], inputs[1][:rows], inputs[2],
            np.zeros(rows)] + list(inputs[4:])
    args[4] = rows
    accel.reset()
    for a in args[:3]:
        accel.remember(a)

    def call():
        ns[gen.fn_name](*args)
        torch.cuda.synchronize()

    call()                     # builds the batched entry, stages rows
    t0 = time.perf_counter()
    call()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        call()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # None: the profiler saw no kernel (not measured)
    device_ms = (sum(e.device_time_total for e in kernels) / 1e3
                 if kernels else None)
    st = accel.take_stats()
    snap, train = inputs[0], inputs[1]
    _, k, dof, iters = inputs[4:8]
    ops = rows * stap_ops_per_gate(k, dof, iters)
    nbytes = (train[:rows].nbytes + snap[:rows].nbytes + 8 * rows)
    bound_ms, bound_by = _bound(ops, nbytes, "float64")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    device = ("not measured (the profiler saw no kernel)"
              if device_ms is None else
              f"{device_ms:.3f} ms in {len(kernels)} kernels (device busy "
              f"{100 * device_ms / wall_ms:.1f} % of the wall; the most "
              f"time: " + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                                    for name, (t, n) in top) + ")")
    print(f"stap chunk ({rows} gates, torch twin in this process): wall "
          f"{wall_ms:.3f} ms, device {device}, bound {bound_ms:.4f} ms "
          f"({bound_by}; "
          f"{ops:.3e} operations); batched hits {st.get('batch_hits', 0)}"
          f", fallbacks {st.get('batch_fallbacks', 0)}", flush=True)
    if st.get("batch_fallbacks") or not st.get("batch_hits"):
        raise AssertionError("stap chunk: the batched path did not run")
    return {"rows": rows, "wall_ms": wall_ms, "device_ms": device_ms,
            "kernels": len(kernels), "bound_ms": bound_ms,
            "bound_by": bound_by, "ops": ops}


def whole_kernel_path(torch):
    """Phase 6: a pfor-free kernel through the dispatcher's whole-kernel
    torch variant on the card."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.polybench_kernels import KERNELS
    from repro_torch.core.compiler import compile_kernel

    gemm = KERNELS["gemm"]
    args, meta = gemm["make_args"](GEMM_N, np.random.default_rng(SEED + 4))
    (out,) = meta["out"]
    ck = compile_kernel(gemm["np"])
    if "torch" not in ck.variants:
        raise AssertionError("gemm: no whole-kernel torch variant")
    want = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
    t0 = time.perf_counter()
    gemm["ref"](*want)
    t_np = time.perf_counter() - t0
    walls = []
    for _ in range(2):
        got = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck(*got)
        walls.append(time.perf_counter() - t0)
    picked = ck.history[-1].variant
    ref = want[out]
    err = np.abs(got[out] - ref)
    bad = bool((err > 1e-8 * np.maximum(1.0, np.abs(ref))).any())
    print(f"whole-kernel path: gemm n={GEMM_N} float64: dispatcher picked "
          f"{picked!r} ({ck.history[-1].flops:.3e} FLOP); wall "
          f"{walls[0]:.3f} s cold, {walls[1]:.3f} s warm (copies to and "
          f"from the card included); numpy {t_np:.3f} s; max err "
          f"{float(err.max()):.3e}", flush=True)
    if picked != "torch":
        raise AssertionError(f"gemm: the dispatcher picked {picked!r}")
    if bad or not np.isfinite(got[out]).all():
        raise AssertionError(f"gemm: max err {float(err.max()):.3e}")
    return {"variant": picked, "wall_s": walls, "numpy_s": t_np,
            "max_abs_err": float(err.max())}


def _deltas(st0, st1):
    """What a served run moved in the fleet's counts: bytes shipped,
    chunks per backend, the twin and batch counters, faults."""
    keys = ("torch_chunks", "torch_fallbacks", "cuda_fallbacks",
            "batch_hits", "batch_builds", "batch_fallbacks")
    return {
        "bytes_shipped": st1["bytes_shipped"] - st0["bytes_shipped"],
        "chunks_executed": {
            b: n - st0["chunks_executed"].get(b, 0)
            for b, n in st1["chunks_executed"].items()
            if n != st0["chunks_executed"].get(b, 0)},
        **{k: st1[k] - st0[k] for k in keys},
        "faults": {k: v - st0["faults"].get(k, 0)
                   for k, v in st1["faults"].items()
                   if v != st0["faults"].get(k, 0)}}


def _check_served(label, d):
    """Every chunk of a served run on the torch twin, no fallback, no
    eager-twin run, no fault."""
    if set(d["chunks_executed"]) != {"torch"}:
        raise AssertionError(f"served stap {label}: not every chunk ran "
                             f"the torch twin: {d['chunks_executed']}")
    if d["torch_fallbacks"] or d["cuda_fallbacks"] \
            or d["batch_fallbacks"]:
        raise AssertionError(f"served stap {label}: fallbacks "
                             f"{json.dumps(d)}")
    if d["faults"]:
        raise AssertionError(f"served stap {label}: faults "
                             f"{json.dumps(d['faults'])}")


def served_stap(rt, compile_kernel, obs, torch, card):
    """Phase 7: STAP behind the serving plane on the fleet, naive and
    coalesced (the logic of ``benchmarks/serve_bench.py::run_stap``)."""
    sys.path.insert(0, str(ROOT))
    from examples.torch_stap import (ALPHA, DOF, ITERS, K_TRAIN, LOADING,
                                     stap_adaptive, stap_seq)
    from repro_torch.serve import (AdmissionController, BatchSpec,
                                   ClusterServeEngine, TenantQuota,
                                   open_loop)

    rng = np.random.default_rng(SEED + 5)
    steer = rng.normal(size=DOF)
    trains = [rng.normal(size=(SERVE_GATES, K_TRAIN, DOF))
              for _ in range(SERVE_REQUESTS)]
    snaps = [rng.normal(size=(SERVE_GATES, DOF))
             for _ in range(SERVE_REQUESTS)]
    scalars = (SERVE_GATES, K_TRAIN, DOF, ITERS, ALPHA, LOADING)
    t0 = time.perf_counter()
    want = _stap_recurrence(
        torch, np.concatenate(snaps), np.concatenate(trains), steer,
        K_TRAIN, ITERS, ALPHA, LOADING).reshape(SERVE_REQUESTS, SERVE_GATES)
    t1 = time.perf_counter()
    # a strided sample of every request's gates (STAP_SAMPLE in all)
    sample = np.arange(0, SERVE_GATES,
                       SERVE_GATES * SERVE_REQUESTS // STAP_SAMPLE)
    seq = np.zeros((SERVE_REQUESTS, len(sample)))
    for r in range(SERVE_REQUESTS):
        stap_seq(snaps[r][sample], trains[r][sample], steer, seq[r],
                 len(sample), *scalars[1:])
    ref_gap = float(np.abs(want[:, sample] - seq).max())
    print(f"served stap references: card recurrence for "
          f"{SERVE_REQUESTS} x {SERVE_GATES} gates in {t1 - t0:.3f} s, "
          f"stap_seq for {seq.size} gates in "
          f"{time.perf_counter() - t1:.3f} s; they differ by "
          f"{ref_gap:.3e}", flush=True)
    if not ref_gap <= 1e-8:
        raise AssertionError(f"served stap references disagree: "
                             f"{ref_gap:.3e}")

    def errors(outs):
        got = np.stack(outs)
        if not np.isfinite(got).all():
            raise AssertionError("served stap: a non-finite output")
        return (float(np.abs(got - want).max()),
                float(np.abs(got[:, sample] - seq).max()))

    ck = compile_kernel(stap_adaptive, runtime=rt, workers=WORKERS)
    ck.pfor_config.distribute_threshold = 0
    batch = BatchSpec(stacked=("snap", "train"), count="numGates",
                      out=("outY",),
                      shared=("steer", "K", "dof", "iters", "alpha",
                              "loading"))
    # warm single calls: ship and persist the body on the workers; then
    # fresh requests back to back (their rows shipped, as a served
    # request's are): the naive capacity, and the open-loop rate a
    # fraction of it. The reference's rule, min(1500, max(30, 3 /
    # t_call)), would offer several times the capacity, and the run
    # would time only the backlog draining
    st0 = rt.stats()
    warm, t_call = np.zeros(SERVE_GATES), float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ck.call_variant("np", snaps[0], trains[0], steer, warm, *scalars)
        t_call = min(t_call, time.perf_counter() - t0)
    warm_err = float(np.abs(warm - want[0]).max())
    t0 = time.perf_counter()
    for i in range(1, 1 + SERVE_CALIBRATE):
        ck.call_variant("np", snaps[i], trains[i], steer, warm, *scalars)
        warm_err = max(warm_err, float(np.abs(warm - want[i]).max()))
    t_fresh = (time.perf_counter() - t0) / SERVE_CALIBRATE
    d = _deltas(st0, rt.stats())
    rate = SERVE_LOAD / t_fresh
    rule = min(1500.0, max(30.0, 3.0 / t_call))
    print(f"served stap warm calls: fastest {t_call * 1e3:.3f} ms a "
          f"request (rows cached); {SERVE_CALIBRATE} fresh requests "
          f"{t_fresh * 1e3:.3f} ms each, a naive capacity of "
          f"{1 / t_fresh:.3f} requests/s; offered rate {rate:.3f} "
          f"requests/s ({SERVE_LOAD} of it; the reference's rule would "
          f"offer {rule:.3f}); {json.dumps(d)}; max err {warm_err:.3e}",
          flush=True)
    _check_served("warm calls", d)
    if not warm_err <= 1e-8:
        raise AssertionError(f"served stap warm call: max err "
                             f"{warm_err:.3e}")

    rows = {"t_call_ms": t_call * 1e3, "t_fresh_ms": t_fresh * 1e3,
            "capacity_rps": 1 / t_fresh, "rate_rps": rate,
            "rule_rps": rule, "card": card}
    for mode, window in (("naive", 0.0), ("coalesced", SERVE_WINDOW_S)):
        eng = ClusterServeEngine(
            rt, coalesce_window_s=window, max_batch=SERVE_MAX_BATCH,
            admission=AdmissionController(
                default=TenantQuota(max_inflight=256), max_queue=1024))
        eng.register("stap", ck, batch=batch)
        outs = [np.zeros(SERVE_GATES) for _ in range(SERVE_REQUESTS)]

        def submit(i, tenant):
            return eng.submit(tenant, "stap",
                              (snaps[i], trains[i], steer, outs[i])
                              + scalars)

        st0 = rt.stats()
        before = rt.phase_breakdown()
        obs.recorder().clear()
        res = open_loop(submit, requests=SERVE_REQUESTS, rate_rps=rate,
                        seed=11, tenants=("tenant-a", "tenant-b"),
                        wait_timeout_s=600.0)
        eng.close()
        d = _deltas(st0, rt.stats())
        phases, spans = _timeline(rt, obs, before)
        tel = eng.telemetry()
        err, err_seq = errors(outs)
        row = {"mode": mode, "window_s": window,
               "requests_per_s": res.throughput_rps,
               "offered_rps": rate,
               "duration_s": res.duration_s,
               "completed": res.completed, "rejected": res.rejected,
               "failed": res.failed, "e2e_ms": res.e2e_ms,
               "queue_ms": res.queue_ms,
               "coalesced_batches": tel["coalesced_batches"],
               "coalesced_requests": tel["coalesced_requests"],
               "fallthrough_dispatches": tel["fallthrough_dispatches"],
               "max_abs_err": err, "max_abs_err_seq": err_seq,
               "phases_s": phases, "spans_s": spans, **d}
        rows[mode] = row
        print(f"served stap {mode} ({SERVE_REQUESTS} requests x "
              f"{SERVE_GATES} gates, 2 tenants, offered "
              f"{rate:.3f} requests/s; {card}): "
              f"{res.throughput_rps:.3f} requests/s "
              f"({res.completed} completed, {res.rejected} rejected, "
              f"{res.failed} failed in {res.duration_s:.3f} s); e2e_ms "
              f"p50 {res.e2e_ms.get('p50')} p95 {res.e2e_ms.get('p95')}; "
              f"queue_ms p50 {res.queue_ms.get('p50')} p95 "
              f"{res.queue_ms.get('p95')}; coalesced_batches "
              f"{tel['coalesced_batches']}, coalesced_requests "
              f"{tel['coalesced_requests']}, fallthrough_dispatches "
              f"{tel['fallthrough_dispatches']}; bytes shipped "
              f"{d['bytes_shipped']}; chunks {d['chunks_executed']}; "
              f"batch_hits {d['batch_hits']}, batch_builds "
              f"{d['batch_builds']}, batch_fallbacks "
              f"{d['batch_fallbacks']}, torch_fallbacks "
              f"{d['torch_fallbacks']}; max err {err:.3e} (card "
              f"recurrence), {err_seq:.3e} (stap_seq sample); phases (s) "
              f"{json.dumps(phases)}; spans (s) {json.dumps(spans)}",
              flush=True)
        _check_served(mode, d)
        if res.completed != SERVE_REQUESTS or res.rejected or res.failed:
            raise AssertionError(f"served stap {mode}: {res.completed} of "
                                 f"{SERVE_REQUESTS} completed, "
                                 f"{res.rejected} rejected, {res.failed} "
                                 f"failed")
        if not (err <= 1e-8 and err_seq <= 1e-8):
            raise AssertionError(f"served stap {mode}: max err {err:.3e} "
                                 f"/ {err_seq:.3e}")
    if rows["coalesced"]["coalesced_batches"] <= 0:
        raise AssertionError("served stap coalesced: no batch merged")
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _replay(torch, cfg, params, done, fa_kernel, fa_ops, attn,
            device="cuda"):
    """(exact, largest gap to the top logit) of every generated token of
    ``done`` against a replay of its request's prompt and generated
    tokens through the same model in one pass, without caches, with the
    flash op patched to ``attn(q, k, v, prompt, **opts)`` (``prompt``:
    the request's prompt length, so rows from there on are the decode
    steps' queries)."""
    from unittest import mock

    from repro_torch.models import transformer as T
    from repro_torch.models.common import (mask_padded_vocab, rmsnorm,
                                           softcap)

    exact, worst = 0, 0.0
    launches = fa_kernel.launches
    for r in done:
        n = len(r.prompt)
        op = lambda q, k, v, n=n, **o: attn(q, k, v, n, **o)  # noqa: E731
        with mock.patch.object(fa_ops, "flash_attention", op), \
                torch.inference_mode():
            toks = np.concatenate([np.asarray(r.prompt),
                                   np.asarray(r.generated[:-1])])
            x = T.embed_tokens(
                params, torch.as_tensor(toks, device=device)[None], cfg)
            x, _ = T.forward(params, x, cfg,
                             positions=torch.arange(len(toks), device=device))
            h = rmsnorm(x[:, n - 1:], params["final_ln"], cfg.norm_eps)
            logits = mask_padded_vocab(softcap(
                torch.einsum("btd,vd->btv", h, params["embed"]),
                cfg.logit_softcap), cfg.vocab)[0].float()
            gen = torch.as_tensor(r.generated, device=device)
            gap = logits.max(-1).values - logits.gather(-1, gen[:, None])[:, 0]
            exact += int((logits.argmax(-1) == gen).sum())
            worst = max(worst, float(gap.max()))
            del x, h, logits
    if fa_kernel.launches != launches:
        raise AssertionError("the plain replay launched the flash kernel")
    return exact, worst


def _replay_attentions(torch, fa_ref):
    """{name: attn} for :func:`_replay`: the plain version, then the
    controls: each decode query on key 0 alone (a decode kernel that
    drops the query offset: the query then sits at position 0), a
    uniform softmax over each row's mask, and every query one key
    further (it also sees the next token)."""
    plain = fa_ref.attention_ref

    def key0(q, k, v, n, **o):
        out = plain(q, k, v, **o)
        out[:, n:] = v[:, :1].repeat_interleave(q.shape[2] // k.shape[2], 2)
        return out

    return {
        "plain": lambda q, k, v, n, **o: plain(q, k, v, **o),
        "key0": key0,
        "uniform": lambda q, k, v, n, **o: plain(torch.zeros_like(q), k, v,
                                                 **o),
        "next_key": lambda q, k, v, n, **o: plain(
            q, k, v, **{**o, "q_offset": o["q_offset"] + 1})}


def served_lm(torch, card, fa_kernel, fa_ops, fa_ref, device="cuda"):
    """Phase 9: gemma2_2b served on the card by ServeEngine (the logic of
    ``repro_torch.launch.serve`` at full size), every attention layer
    on the flash kernel; each generated token checked against a plain
    replay. (``device`` is for a rehearsal on the CPU, with a counting
    plain version standing in for the kernel.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params, _ = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))) for _ in range(LM_REQUESTS)]
    lens = [len(p) for p in prompts]
    if max(lens) <= cfg.sliding_window:
        raise AssertionError(f"lm: no prompt outgrows the window: {lens}")
    eng = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                      device=device)
    decodes = [0]
    decode = eng._decode

    def counted(*args):
        decodes[0] += 1
        return decode(*args)

    eng._decode = counted
    prefill_ms = []
    prefill = eng._prefill

    def timed(*args):
        # the engine waits for each step's argmax anyway: these
        # synchronisations cost it nothing
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = prefill(*args)
        torch.cuda.synchronize(device)
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._prefill = timed
    # the earlier phases' garbage is collected here, not inside the run
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    # every count to 0 just before the path's run
    fa_kernel.launches = 0
    fa_ops.plain_calls = 0
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.add_request(Request(f"req-{i}", p, max_tokens=LM_NEW_TOKENS),
                        tenant=("tenant-a", "tenant-b")[i % 2])
        eng.step()          # staggered arrivals, as launch/serve.py
    done = eng.run_until_done()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches, plain = fa_kernel.launches, fa_ops.plain_calls
    tel = eng.telemetry()
    tokens = sum(len(r.generated) for r in done)
    want_launches = cfg.layers * (eng.prefills + decodes[0])
    per_request = [{
        "id": r.request_id, "prompt": len(r.prompt),
        "generated": len(r.generated),
        "ttft_ms": (r.first_token_s - r.submitted_s) * 1e3,
        "prefill_ms": prefill_ms[i],
        "tpot_ms": (r.finished_s - r.first_token_s) * 1e3
        / max(1, len(r.generated) - 1)}
        for i, r in enumerate(sorted(done, key=lambda r: r.first_token_s))]
    for row in per_request:
        print(f"lm {row['id']}: prompt {row['prompt']} tokens, "
              f"{row['generated']} generated, TTFT {row['ttft_ms']:.3f} "
              f"ms (its prefill {row['prefill_ms']:.3f} ms), TPOT "
              f"{row['tpot_ms']:.3f} ms", flush=True)
    print(f"lm served ({cfg.name}, {n_params / 1e9:.3f} B params bf16 "
          f"from seed {SEED} in {t_init:.3f} s; {LM_SLOTS} slots x "
          f"{LM_MAX_SEQ}; {len(done)} requests, 2 tenants; {card}): "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.3f} "
          f"tokens/s; prefills {eng.prefills}, decode steps {decodes[0]}, "
          f"ticks {eng.ticks}; flash launches {launches} ({cfg.layers} x "
          f"(prefills + decode steps) = {want_launches}); plain calls "
          f"{plain}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; latency "
          f"{json.dumps(tel['latency'])}", flush=True)
    if len(done) != LM_REQUESTS or any(
            len(r.generated) != LM_NEW_TOKENS for r in done):
        raise AssertionError(f"lm: {len(done)} of {LM_REQUESTS} requests "
                             f"done, generated "
                             f"{[len(r.generated) for r in done]}")
    if launches != want_launches:
        raise AssertionError(f"lm: {launches} flash launches, not "
                             f"{want_launches}")
    if plain != 0:
        raise AssertionError(f"lm: {plain} plain attention calls on the card")
    t0 = time.perf_counter()
    checked = sum(len(r.generated) for r in done)
    replays = {name: _replay(torch, cfg, params, done, fa_kernel, fa_ops,
                             attn, device)
               for name, attn in _replay_attentions(torch, fa_ref).items()}
    for name, (exact, worst) in replays.items():
        print(f"lm replay, attention {name}: {exact} of {checked} "
              f"generated tokens are the replay's argmax; the largest gap "
              f"to its top logit {worst:.4f} (gate: at least "
              f"{LM_MIN_EXACT} exact, gap at most {LM_LOGIT_TOL})",
              flush=True)
    print(f"lm replays: {time.perf_counter() - t0:.3f} s", flush=True)

    def passes(name):
        exact, worst = replays[name]
        return exact >= LM_MIN_EXACT and worst <= LM_LOGIT_TOL

    if checked != LM_REQUESTS * LM_NEW_TOKENS or not passes("plain"):
        raise AssertionError(f"lm replay: {checked} tokens checked, "
                             f"(exact, largest gap) {replays['plain']}")
    for name in ("key0", "uniform"):
        if passes(name):
            raise AssertionError(f"lm replay: the gate passes the {name} "
                                 f"control {replays[name]}")
    exact, worst = replays["plain"]
    del eng, params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": n_params, "init_s": t_init,
            "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ, "requests": len(done),
            "prompt_lens": lens, "new_tokens": LM_NEW_TOKENS,
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefills": tel["prefills"], "decode_steps": decodes[0],
            "ticks": tel["ticks"], "launches": launches,
            "plain_calls": plain, "latency": tel["latency"],
            "per_request": per_request, "replay_exact": exact,
            "replay_checked": checked, "replay_max_gap": worst,
            "replay_controls": {k: {"exact": e, "max_gap": g}
                                for k, (e, g) in replays.items()
                                if k != "plain"},
            "card": card}


def _worker_counts(state):
    """Shipped to the worker that holds ``state`` (by value: this module
    is the head's ``__main__``): that process's flash launches, plain
    attention calls, served ops (replays included) and peak memory."""
    import os

    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve import remote_lm

    return {"pid": os.getpid(), "launches": fa.launches,
            "plain_calls": fa_ops.plain_calls, "ops": dict(remote_lm.ops),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30
            if torch.cuda.is_available() else None}


class _TimedRuntime:
    """The fleet as ClusterLMEngine sees it, timing each anchor: its
    pull (``get`` of the state) and its push (``submit`` of
    ``lm_anchor`` until the worker holds the new root)."""

    def __init__(self, rt, remote_lm):
        self.rt = rt
        self.remote_lm = remote_lm
        self.anchors = []

    def __getattr__(self, name):
        return getattr(self.rt, name)

    def get(self, ref, timeout=60.0):
        t = time.perf_counter()
        value = self.rt.get(ref, timeout)
        if isinstance(value, self.remote_lm.Resident):
            self.anchors.append({"bytes": value.nbytes,
                                 "pull_s": time.perf_counter() - t})
        return value

    def submit(self, fn, *args, **kw):
        t = time.perf_counter()
        ref = self.rt.submit(fn, *args, **kw)
        if fn is self.remote_lm.lm_anchor:
            ready, _ = self.rt.wait([ref], timeout=600.0)
            if not ready:
                raise AssertionError("cluster lm: an anchor's push took "
                                     "over 600 s")
            self.anchors[-1]["push_s"] = time.perf_counter() - t
        return ref


def _latency_row(lat) -> dict:
    return {name: {q: lat[name][q] for q in ("p50", "p95")}
            for name in ("ttft_ms", "tpot_ms")}


def served_lm_cluster(torch, card, device="cuda"):
    """Phase 9b: gemma2_2b served from a worker of a CUDA fleet by
    ClusterLMEngine, with a worker-kill drill after the first anchor;
    every token against the head ServeEngine's on the same requests,
    and every served attention call on the flash kernel in the workers.
    (``device`` is for a rehearsal on the CPU.)"""
    from repro_torch.configs import get_config
    from repro_torch.distrib import ClusterRuntime
    from repro_torch.models import transformer as T
    from repro_torch.serve import (ClusterLMEngine, Request, ServeEngine,
                                   remote_lm)

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params, _ = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t0
    param_bytes = sum(t.nbytes for t in _leaves(params))
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, cfg.vocab, n) for n in CLUSTER_LENS]
    lens = [len(p) for p in prompts]

    def serve(eng, after_step=None):
        t = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.add_request(Request(f"req-{i}", p,
                                    max_tokens=CLUSTER_NEW_TOKENS),
                            tenant=("tenant-a", "tenant-b")[i % 2])
            eng.step()
            if after_step is not None:
                after_step()
        while eng.queue or eng.active:
            eng.step()
            if after_step is not None:
                after_step()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        done = {r.request_id: list(r.generated) for r in eng.finished}
        tokens = sum(len(g) for g in done.values())
        return done, {"wall_s": wall, "tokens": tokens,
                      "tokens_per_s": tokens / wall,
                      "latency": _latency_row(eng.telemetry()["latency"])}

    # the oracle: the head's ServeEngine on the same params and requests
    gc.collect()
    head = ServeEngine(params, cfg, n_slots=CLUSTER_SLOTS,
                       max_seq=CLUSTER_MAX_SEQ, device=device)
    want, head_run = serve(head)
    del head
    torch.cuda.empty_cache()
    print(f"cluster lm: the head ServeEngine served {len(want)} requests "
          f"in {head_run['wall_s']:.3f} s", flush=True)

    t0 = time.perf_counter()
    fleet = ClusterRuntime(workers=CLUSTER_WORKERS, device=device,
                           start_method="spawn", respawn=False)
    t_fleet = time.perf_counter() - t0
    try:
        rt = _TimedRuntime(fleet, remote_lm)
        t0 = time.perf_counter()
        eng = ClusterLMEngine(rt, params, cfg, n_slots=CLUSTER_SLOTS,
                              max_seq=CLUSTER_MAX_SEQ,
                              trim_every=CLUSTER_TRIM)
        ready, _ = fleet.wait([eng._state], timeout=600.0)
        t_boot = time.perf_counter() - t0
        if not ready:
            raise AssertionError("cluster lm: the boot took over 600 s")
        print(f"cluster lm: fleet up in {t_fleet:.3f} s, boot of "
              f"{param_bytes} bytes in {t_boot:.3f} s", flush=True)
        del params
        torch.cuda.empty_cache()
        drill = {}
        longest = [0]
        rolls = {"prefill": 0, "decode": 0}
        roll = eng._roll

        def counted(fn, *args):
            rolls["prefill" if fn is remote_lm.lm_prefill
                  else "decode"] += 1
            return roll(fn, *args)

        def counts():
            ref = fleet.submit(_worker_counts, eng._state)
            try:
                return fleet.get(ref, timeout=60.0)
            finally:
                fleet.release(ref)

        def after_step():
            longest[0] = max(longest[0], len(eng._chain))
            if drill or not eng.anchors or len(eng._chain) < 2 \
                    or not eng.active:
                return
            # after the first anchor, mid-decode: kill the state's owner
            meta = fleet.plane.meta(eng._state.oid)
            if meta.state != "remote":
                raise AssertionError(f"cluster lm: the state is "
                                     f"{meta.state}, not on a worker")
            owner = meta.owner
            drill.update(victim=counts(), owner=owner,
                         replayed_ops=len(eng._chain))
            fleet.kill_worker(owner)
            t = time.perf_counter()
            while fleet.stats()["worker_deaths"] < 1:
                if time.perf_counter() - t > 30.0:
                    raise AssertionError("cluster lm: the killed worker "
                                         "was not declared dead in 30 s")
                time.sleep(0.01)
            t = time.perf_counter()
            eng.step()
            drill["recovery_s"] = time.perf_counter() - t
            longest[0] = max(longest[0], len(eng._chain))
            print(f"cluster lm: worker {owner} killed after anchor "
                  f"{eng.anchors}; recovered in {drill['recovery_s']:.3f} s",
                  flush=True)

        eng._roll = counted
        got, run = serve(eng, after_step)
        survivor = counts()
        stats = fleet.stats()
        tel = eng.telemetry()
        eng.close()
    finally:
        fleet.shutdown()
    head_peak = torch.cuda.max_memory_allocated() / 2**30
    for a in rt.anchors:
        print(f"cluster lm anchor: {a['bytes']} bytes pulled in "
              f"{a['pull_s']:.3f} s ({a['bytes'] / a['pull_s'] / 1e6:.1f} "
              f"MB/s), pushed back in {a['push_s']:.3f} s "
              f"({a['bytes'] / a['push_s'] / 1e6:.1f} MB/s)", flush=True)
    print(f"cluster lm served ({cfg.name}, {param_bytes} bytes of bf16 "
          f"params from seed {SEED} in {t_init:.3f} s; {CLUSTER_SLOTS} "
          f"slots x {CLUSTER_MAX_SEQ}; {len(got)} requests, 2 tenants, "
          f"prompts {lens}; {card}): fleet of {CLUSTER_WORKERS} up in "
          f"{t_fleet:.3f} s, boot {param_bytes} bytes in {t_boot:.3f} s "
          f"({param_bytes / t_boot / 1e6:.1f} MB/s); {run['tokens']} "
          f"tokens in {run['wall_s']:.3f} s = {run['tokens_per_s']:.3f} "
          f"tokens/s (head ServeEngine {head_run['tokens_per_s']:.3f} "
          f"in {head_run['wall_s']:.3f} s); latency "
          f"{json.dumps(run['latency'])}, head "
          f"{json.dumps(head_run['latency'])}; ops {rolls}, anchors "
          f"{tel['anchors']}, longest chain {longest[0]}; drill: worker "
          f"{drill.get('owner')} killed with {drill.get('replayed_ops')} "
          f"ops after its anchor, recovered in "
          f"{drill.get('recovery_s', float('nan')):.3f} s, deaths "
          f"{stats['worker_deaths']}, lineage replays "
          f"{stats['lineage_replays']}; the victim "
          f"{json.dumps(drill.get('victim'))}, the survivor "
          f"{json.dumps(survivor)}; head peak memory {head_peak:.2f} GiB",
          flush=True)
    if got != want:
        bad = sorted(k for k in want if got.get(k) != want[k])
        raise AssertionError(f"cluster lm: tokens differ from the head "
                             f"ServeEngine's in {bad}")
    if len(got) != CLUSTER_REQUESTS or any(
            len(g) != CLUSTER_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"cluster lm: generated "
                             f"{[len(g) for g in got.values()]}")
    if not (tel["anchors"] >= 1 and stats["worker_deaths"] >= 1
            and stats["lineage_replays"] >= 1 and drill
            and longest[0] <= CLUSTER_TRIM):
        raise AssertionError(f"cluster lm: anchors {tel['anchors']}, "
                             f"deaths {stats['worker_deaths']}, replays "
                             f"{stats['lineage_replays']}, longest chain "
                             f"{longest[0]}, drill {drill}")
    victim = drill["victim"]
    if survivor["pid"] == victim["pid"]:
        raise AssertionError("cluster lm: the survivor is the victim")
    served_ops = {w["pid"]: sum(w["ops"].values())
                  for w in (victim, survivor)}
    if sum(served_ops.values()) != sum(rolls.values()) \
            + drill["replayed_ops"]:
        raise AssertionError(f"cluster lm: the workers ran {served_ops} "
                             f"ops, not the engine's {rolls} and "
                             f"{drill['replayed_ops']} replayed")
    for w in (victim, survivor):
        ops = served_ops[w["pid"]]
        if not ops or w["launches"] != cfg.layers * ops \
                or w["plain_calls"]:
            raise AssertionError(f"cluster lm: worker {w['pid']} ran "
                                 f"{ops} ops with {w['launches']} flash "
                                 f"launches (not {cfg.layers} x {ops}) "
                                 f"and {w['plain_calls']} plain calls")
    return {"arch": cfg.name, "param_bytes": param_bytes, "init_s": t_init,
            "workers": CLUSTER_WORKERS, "slots": CLUSTER_SLOTS,
            "max_seq": CLUSTER_MAX_SEQ, "trim_every": CLUSTER_TRIM,
            "requests": len(got), "prompt_lens": lens,
            "new_tokens": CLUSTER_NEW_TOKENS, "fleet_s": t_fleet,
            "boot_s": t_boot, "boot_bytes": param_bytes,
            "anchors": rt.anchors, "drill": drill, "survivor": survivor,
            "prefills": rolls["prefill"], "decode_steps": rolls["decode"],
            "launches": victim["launches"] + survivor["launches"],
            "plain_calls": victim["plain_calls"] + survivor["plain_calls"],
            "worker_deaths": stats["worker_deaths"],
            "lineage_replays": stats["lineage_replays"],
            "longest_chain": longest[0], "run": run, "head_run": head_run,
            "head_peak_gib": head_peak, "tokens_equal_head": True,
            "card": card}


def _unique_numel(tree) -> int:
    """Elements of the distinct tensors of ``tree`` (a shared expert set
    counts once)."""
    seen = {}
    for t in _leaves(tree):
        seen[t.data_ptr()] = t.numel()
    return sum(seen.values())


def _replay_family(torch, cfg, params, events, spec, fa_ops, fa_ref,
                   sc_ops, sc_ref, device="cuda", mode="pinned"):
    """{replay: (exact, largest gap to the top logit, tokens checked)}:
    the engine's own calls (``events``: each prefill with its slot, each
    decode step with its batch of tokens and active slots, each with its
    MoE layers' routing in call order) made again in order on fresh
    caches, every served token scored against the logits it came from.
    ``mode`` "pinned": attention and the scan on their plain versions,
    each MoE layer's routing the served call's; "plain" is the sound
    replay, "zero_state" (where the spec asks for it) leaves each
    prefill's Mamba states at zero in its caches. "free": the plain
    versions, each MoE layer routing itself. "kernel": the kernels
    themselves, routing free: it reproduces the served run only if the
    replay makes the same calls and every kernel gives the same bits
    each time. The plain attention is the kernel's own
    (``flash_attention_bhsd_ref`` on the dispatch's regrouped tensors,
    REPLAY_Q_CHUNK query rows at a time)."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    def plain_attention(q, k, v, *, q_offset=0, **opts):
        b, sq, h, d = q.shape
        qf, kf, vf, off = fa_ops.regroup(q, k, v, q_offset)
        out = torch.cat([
            fa_ref.flash_attention_bhsd_ref(
                qf[:, r:r + REPLAY_Q_CHUNK], kf, vf,
                q_offset=r if off is None else off + r, **opts)
            for r in range(0, sq, REPLAY_Q_CHUNK)], dim=1)
        return out.reshape(b, h, sq, d).transpose(1, 2)

    pinned = []                      # the served routing of the call

    def served_route(p, ht, cfg_):
        weights, slot, cap = pinned.pop(0)
        if slot.numel() != ht.shape[0] * cfg_.experts_topk:
            raise AssertionError("replay: a MoE call's tokens differ from "
                                 "the served call's")
        return weights, slot, cap

    if mode == "pinned":
        names = ["plain"] + (["zero_state"] if spec["zero_state_control"]
                             else [])
    else:
        names = [mode]
    caches = {n: T.init_caches(cfg, FAM_SLOTS, spec["max_seq"],
                               device=device) for n in names}
    mamba = [i for i in range(cfg.period) if cfg.layer_kind(i) == "mamba"]
    stats = {n: [0, 0.0, 0] for n in names}

    def score(name, logits, served):
        logits = logits.float()
        served = torch.as_tensor(served, device=logits.device)
        gap = logits.max(-1).values - logits.gather(-1, served[:, None])[:, 0]
        st = stats[name]
        st[0] += int((logits.argmax(-1) == served).sum())
        st[1] = max(st[1], float(gap.max()))
        st[2] += len(served)

    with ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        if mode != "kernel":
            stack.enter_context(mock.patch.object(
                fa_ops, "flash_attention", plain_attention))
            stack.enter_context(mock.patch.object(
                sc_ops, "mamba_scan", sc_ref.mamba_scan_promoted_ref))
        if mode == "pinned":
            stack.enter_context(mock.patch.object(moe_mod, "route",
                                                  served_route))
        for kind, tokens, served, where, routes in events:
            if kind == "prefill":
                pinned[:] = routes
                one, logits = T.prefill(params, {"tokens": tokens}, cfg,
                                        spec["max_seq"])
                for n in names:
                    score(n, logits, [served])
                    ServeEngine._insert(caches[n], one, where)
                    if n == "zero_state":
                        for i in mamba:
                            caches[n][i]["ssm"]["h"][:, where] = 0
                del one, logits
                continue
            for n in names:
                pinned[:] = routes
                logits, caches[n] = T.decode_step(params, tokens, caches[n],
                                                  cfg)
                score(n, logits[where], served[where].to(logits.device))
    return {n: tuple(v) for n, v in stats.items()}


def served_family(torch, card, name, kernels, device="cuda"):
    """Phase 10, one model of FAMILIES: served on the card by ServeEngine
    (``repro_torch.launch.serve``'s logic at full width), every
    attention layer on the flash kernel and every Mamba prefill on the
    scan kernel, no plain call; each served token checked against a
    replay of the engine's calls on the plain versions (and Jamba's
    zero-state control against the same gate, which it must fail).
    ``kernels``: the flash kernel, its ops and plain module, the scan
    kernel, its ops and plain module."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    fa, fa_ops, fa_ref, sc, sc_ops, sc_ref = kernels
    spec = FAMILIES[name]
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, layers=spec["layers"] or full.layers)
    kinds = [cfg.layer_kind(i) for i in range(cfg.period)]
    n_attn = cfg.n_periods * kinds.count("attn")
    n_mamba = cfg.n_periods * kinds.count("mamba")
    n_moe = cfg.n_periods * sum(map(cfg.layer_is_moe, range(cfg.period)))
    reduced = {}
    if cfg.layers != full.layers:
        reduced["layers"] = (f"{full.layers} -> {cfg.layers}: one period "
                             f"of {cfg.period} (layers % period == 0)")
    if spec["share_experts"]:
        reduced["experts"] = (
            f"the {n_moe} MoE layers share one set of "
            f"{moe_mod.padded_experts(cfg)} experts (each its own router); "
            f"every layer computes at full width")
    print(f"{name} ({cfg.name}) reduced: {json.dumps(reduced)}",
          flush=True)
    t0 = time.perf_counter()
    params, _ = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED),
        share_experts=spec["share_experts"])
    torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t0
    n_params = _unique_numel(params)
    prompts = _family_prompts(spec, cfg.vocab)
    lens = [len(p) for p in prompts]
    eng = ServeEngine(params, cfg, n_slots=FAM_SLOTS,
                      max_seq=spec["max_seq"], device=device)
    # the engine's calls in order, each with its MoE layers' routing,
    # for the replay; each prefill timed (the engine waits for each
    # step's argmax anyway: these synchronisations cost it nothing)
    events, prefill_ms, routes = [], [], []
    prefill, decode, insert = eng._prefill, eng._decode, eng._insert
    route = moe_mod.route

    def recorded_route(p, ht, cfg_):
        out = route(p, ht, cfg_)
        routes.append(out)
        return out

    def recorded_prefill(p, tokens):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        one, logits = prefill(p, tokens)
        torch.cuda.synchronize(device)
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        events.append(["prefill", tokens, int(torch.argmax(logits[0])),
                       None, routes[:]])
        routes.clear()
        return one, logits

    def recorded_insert(caches, one, slot):
        events[-1][3] = slot
        return insert(caches, one, slot)

    def recorded_decode(p, tokens, caches):
        logits, caches = decode(p, tokens, caches)
        events.append(["decode", tokens.clone(),
                       torch.argmax(logits, dim=-1).cpu(),
                       sorted(eng.active), routes[:]])
        routes.clear()
        return logits, caches

    eng._prefill, eng._insert = recorded_prefill, recorded_insert
    eng._decode = recorded_decode
    moe_mod.route = recorded_route
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    # every count to 0 just before the path's run
    fa.launches = fa_ops.plain_calls = sc.launches = sc_ops.plain_calls = 0
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.add_request(Request(f"{name}-{i}", p,
                                max_tokens=FAM_NEW_TOKENS),
                        tenant=("tenant-a", "tenant-b")[i % 2])
        eng.step()          # staggered arrivals, as launch/serve.py
    try:
        done = eng.run_until_done()
        torch.cuda.synchronize(device)
    finally:
        moe_mod.route = route
    wall = time.perf_counter() - t0
    counts = {"flash_launches": fa.launches,
              "flash_plain_calls": fa_ops.plain_calls,
              "scan_launches": sc.launches,
              "scan_plain_calls": sc_ops.plain_calls}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tel = eng.telemetry()
    decodes = sum(e[0] == "decode" for e in events)
    tokens = sum(len(r.generated) for r in done)
    want = {"flash_launches": n_attn * (eng.prefills + decodes),
            "scan_launches": n_mamba * eng.prefills,
            "flash_plain_calls": 0, "scan_plain_calls": 0}
    per_request = [{
        "id": r.request_id, "prompt": len(r.prompt),
        "generated": len(r.generated),
        "ttft_ms": (r.first_token_s - r.submitted_s) * 1e3,
        "prefill_ms": prefill_ms[i],
        "tpot_ms": (r.finished_s - r.first_token_s) * 1e3
        / max(1, len(r.generated) - 1)}
        for i, r in enumerate(sorted(done, key=lambda r: r.first_token_s))]
    for row in per_request:
        print(f"{name} {row['id']}: prompt {row['prompt']} tokens, "
              f"{row['generated']} generated, TTFT {row['ttft_ms']:.3f} "
              f"ms (its prefill {row['prefill_ms']:.3f} ms), TPOT "
              f"{row['tpot_ms']:.3f} ms", flush=True)
    print(f"{name} served ({cfg.name}, {cfg.layers} layers, "
          f"{n_params / 1e9:.3f} B distinct params bf16 from seed {SEED} "
          f"in {t_init:.3f} s; {FAM_SLOTS} slots x {spec['max_seq']}; "
          f"{len(done)} requests, 2 tenants; {card}): {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.3f} tokens/s; prefills "
          f"{eng.prefills}, decode steps {decodes}, ticks {eng.ticks}; "
          f"counts {json.dumps(counts)} (want {json.dumps(want)}); peak "
          f"memory {peak_gib:.2f} GiB; latency "
          f"{json.dumps(tel['latency'])}", flush=True)
    if len(done) != FAM_REQUESTS or any(
            len(r.generated) != FAM_NEW_TOKENS for r in done):
        raise AssertionError(f"{name}: {len(done)} of {FAM_REQUESTS} "
                             f"requests done, generated "
                             f"{[len(r.generated) for r in done]}")
    if counts != want:
        raise AssertionError(f"{name}: counts {counts}, want {want}")
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    before = (fa.launches, sc.launches)
    replays = _replay_family(torch, cfg, params, events, spec, fa_ops,
                             fa_ref, sc_ops, sc_ref, device)
    if spec["free_replay"]:
        replays.update(_replay_family(torch, cfg, params, events, spec,
                                      fa_ops, fa_ref, sc_ops, sc_ref,
                                      device, "free"))
    if (fa.launches, sc.launches) != before:
        raise AssertionError(f"{name}: the plain replay launched a kernel")
    replays.update(_replay_family(torch, cfg, params, events, spec, fa_ops,
                                  fa_ref, sc_ops, sc_ref, device, "kernel"))
    t_replay = time.perf_counter() - t0
    notes = {"free": "; not gated: routing free",
             "kernel": "; it must reproduce every token"}
    for what, (exact, worst, checked) in replays.items():
        print(f"{name} replay {what}: {exact} of {checked} served tokens "
              f"are the replay's argmax; the largest gap to its top logit "
              f"{worst:.4f} (gate: at least {spec['min_exact']} exact, gap "
              f"at most {spec['logit_tol']}{notes.get(what, '')})",
              flush=True)
    print(f"{name} replays: {t_replay:.3f} s", flush=True)

    def passes(what):
        exact, worst, _ = replays[what]
        return exact >= spec["min_exact"] and worst <= spec["logit_tol"]

    if replays["plain"][2] != tokens or not passes("plain"):
        raise AssertionError(f"{name} replay: {tokens} tokens served, "
                             f"(exact, largest gap, checked) "
                             f"{replays['plain']}")
    if "zero_state" in replays and passes("zero_state"):
        raise AssertionError(f"{name} replay: the gate passes the "
                             f"zero-state control {replays['zero_state']}")
    if replays["kernel"] != (tokens, 0.0, tokens):
        raise AssertionError(f"{name}: the replay on the kernels does not "
                             f"reproduce the served tokens "
                             f"{replays['kernel']}")
    del params, events
    torch.cuda.empty_cache()
    exact, worst, checked = replays["plain"]
    return {"arch": cfg.name, "layers": cfg.layers, "reduced": reduced,
            "params": n_params, "init_s": t_init, "slots": FAM_SLOTS,
            "max_seq": spec["max_seq"], "requests": len(done),
            "prompt_lens": lens, "new_tokens": FAM_NEW_TOKENS,
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefills": tel["prefills"], "decode_steps": decodes,
            "ticks": tel["ticks"], **counts, "peak_gib": peak_gib,
            "latency": tel["latency"], "per_request": per_request,
            "replay_exact": exact, "replay_checked": checked,
            "replay_max_gap": worst, "replay_s": t_replay,
            "gate": {"logit_tol": spec["logit_tol"],
                     "min_exact": spec["min_exact"]},
            "replay_controls": {k: {"exact": e, "max_gap": g}
                                for k, (e, g, _) in replays.items()
                                if k == "zero_state"},
            "replay_free_routing": replays.get("free"),
            "replay_kernel": replays["kernel"], "card": card}


def _grad_gate(torch, got, want, names):
    """Each leaf of ``got`` against ``want`` (lists in leaf order; either
    may lie on the host, each leaf is compared on the card): the worst
    cosine and relative norm error with their leaves, the whole
    gradient's relative norm error, and whether all are within
    TRAIN_GATE."""
    worst = {"cosine": (2.0, None), "norm_rel": (-1.0, None)}
    sq_got = sq_want = 0.0
    for g, w, name in zip(got, want, names):
        dev = w.device if w.is_cuda else g.device
        g64 = g.to(dev, non_blocking=True).double()
        w64 = w.to(dev, non_blocking=True).double()
        ng, nw = float(g64.norm()), float(w64.norm())
        sq_got, sq_want = sq_got + ng * ng, sq_want + nw * nw
        if ng == 0.0 and nw == 0.0:
            continue                     # a leaf no loss reaches
        cos = float((g64 * w64).sum()) / (ng * nw) if ng and nw else 0.0
        rel = float((g64 - w64).norm()) / nw if nw else float("inf")
        if cos < worst["cosine"][0]:
            worst["cosine"] = (cos, name)
        if rel > worst["norm_rel"][0]:
            worst["norm_rel"] = (rel, name)
    norm_rel = abs(sq_got ** 0.5 - sq_want ** 0.5) / sq_want ** 0.5
    passes = worst["cosine"][0] >= TRAIN_GATE["cosine"] \
        and worst["norm_rel"][0] <= TRAIN_GATE["norm_rel"] \
        and norm_rel <= TRAIN_GATE["norm_rel"]
    return {"worst_cosine": worst["cosine"][0],
            "worst_cosine_leaf": worst["cosine"][1],
            "worst_norm_rel": worst["norm_rel"][0],
            "worst_norm_rel_leaf": worst["norm_rel"][1],
            "grad_norm": sq_got ** 0.5, "grad_norm_rel": norm_rel,
            "passes": passes}


def _to_host(torch, grads) -> list:
    """Copies of ``grads`` in pinned host memory (a pageable copy of a
    15 GB gradient crawls both ways)."""
    out = []
    for g in grads:
        h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
        h.copy_(g)
        out.append(h)
    return out


def _settle(torch, what) -> float:
    """Collect the garbage of the earlier phases, empty the allocator's
    cache, and print the GiB allocated on the card before and after,
    with the largest tensors still alive (by storage); returns the GiB
    after."""
    held = torch.cuda.memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    gib = torch.cuda.memory_allocated() / 2 ** 30
    alive = {}
    for obj in gc.get_objects():
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                st = obj.untyped_storage()
                alive[st.data_ptr()] = (st.nbytes(), tuple(obj.shape),
                                        str(obj.dtype))
        except Exception:  # noqa: BLE001 - an object torch cannot inspect
            continue
    largest = sorted(alive.values(), reverse=True)[:8]
    print(f"{what}: {held:.3f} GiB allocated on the card, {gib:.3f} GiB "
          f"after collecting garbage; largest live tensors (bytes, shape, "
          f"dtype) {largest}", flush=True)
    return gib


def _phase_ms(marks) -> dict:
    """{phase: ms} of one step from its (phase, CUDA event) marks, each
    phase running to the next mark."""
    out = {}
    for (what, a), (_, b) in zip(marks, marks[1:]):
        if what != "end":
            out[what] = out.get(what, 0.0) + a.elapsed_time(b)
    return out


def _train_config(torch, spec):
    """(config, {cut: why}) of a TRAIN_RUNS run: the arch's config at
    full width, with the run's depth, expert count and microbatch
    count."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(spec["arch"])
    cuts, reduced = {}, {}
    if spec.get("layers"):
        cuts["layers"] = spec["layers"]
        reduced["layers"] = (f"{full.layers} -> {spec['layers']}: one "
                             f"period of {full.period}")
    if spec.get("n_experts"):
        cuts["n_experts"] = spec["n_experts"]
        reduced["experts"] = (
            f"{full.n_experts} -> {spec['n_experts']} routed experts "
            f"(top-{full.experts_topk} kept)"
            + (", not padded to the production mesh's 16"
               if spec.get("expert_multiple") == 1 else "")
            + (", one set shared by the period's MoE layers (each its own "
               "router)" if spec.get("share_experts") else ""))
    if spec.get("microbatch"):
        cuts["microbatch"] = spec["microbatch"]
        reduced["microbatches"] = (f"{full.microbatch} -> "
                                   f"{spec['microbatch']}")
    reduced["global_batch"] = f"train_4k's 256 -> {spec['batch']}"
    return dataclasses.replace(full, **cuts), reduced


def trained(torch, card, name, kernels, device="cuda"):
    """Phase 11, one run of TRAIN_RUNS: the model at full width trained
    on the card through ``repro_torch.train``; step 1's gradient gated
    against its replay with every attention's and every scan's backward
    on its plain version (and the run's controls, which must fail the
    gate), the loss falling, a resume from the step-2 checkpoint giving
    the same loss bits, and every attention and scan call on the
    kernels. ``kernels``: the flash kernel, its ops and its plain
    module, the scan kernel, its ops and its plain module."""
    import shutil

    from repro_torch.checkpoint import ckpt as C
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.train import (AdamWConfig, accumulate_grads,
                                   init_opt_state, make_train_step)
    from repro_torch.train.tree import leaves_with_paths, tree_map

    fa, fa_ops, fa_ref, sc, sc_ops, sc_ref = kernels
    spec = TRAIN_RUNS[name]
    cfg, reduced = _train_config(torch, spec)
    batch_size = spec["batch"]
    n_micro = max(1, cfg.microbatch)
    kinds = [cfg.layer_kind(i) for i in range(cfg.period)]
    attn_layers = cfg.n_periods * kinds.count("attn")
    mamba_layers = cfg.n_periods * kinds.count("mamba")
    # attention calls of one microbatch: each decoder layer's (twice in
    # an enc-dec model: self and cross) and each encoder layer's
    calls = attn_layers * (2 if cfg.is_encdec else 1) \
        + (cfg.enc_layers if cfg.is_encdec else 0)
    remat = 2 if cfg.remat in ("full", "dots") else 1
    t0 = time.perf_counter()
    params, _ = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED),
        share_experts=spec.get("share_experts", False),
        **({"expert_multiple": spec["expert_multiple"]}
           if "expert_multiple" in spec else {}))
    torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t0
    names = ["/".join(p) for p, _ in leaves_with_paths(params)]
    n_params = sum(t.numel() for _, t in leaves_with_paths(params))
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=batch_size,
        seed=TRAIN_DATA_SEED,
        embeds_dim=cfg.d_model if cfg.embeds_input else 0,
        src_len=TRAIN_SEQ if cfg.is_encdec else 0, d_model=cfg.d_model))

    def batch(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    def zero():
        fa.launches = fa.bwd_launches = fa_ops.plain_calls = 0
        sc.launches = sc.bwd_launches = 0
        sc_ops.plain_calls = sc_ops.bwd_plain_calls = 0

    def counts():
        return {"forward_launches": fa.launches,
                "backward_launches": fa.bwd_launches,
                "plain_calls": fa_ops.plain_calls,
                "scan_forward_launches": sc.launches,
                "scan_backward_launches": sc.bwd_launches,
                "scan_plain_calls": sc_ops.plain_calls
                + sc_ops.bwd_plain_calls}

    def check_counts(what, got, steps):
        want = {"forward_launches": remat * calls * n_micro * steps,
                "backward_launches": calls * n_micro * steps,
                "plain_calls": 0,
                "scan_forward_launches": remat * mamba_layers * n_micro
                * steps,
                "scan_backward_launches": mamba_layers * n_micro * steps,
                "scan_plain_calls": 0}
        if got != want:
            raise AssertionError(f"{name} {what}: counts {got}, want "
                                 f"{want} ({calls} attention calls and "
                                 f"{mamba_layers} scans a microbatch, "
                                 f"{n_micro} microbatches)")

    enc = f" + {cfg.enc_layers} encoder" if cfg.is_encdec else ""
    print(f"{name} ({cfg.name}): {n_params / 1e9:.3f} B parameters, "
          f"{cfg.layers} layers{enc} ({mamba_layers} Mamba), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads (D = {cfg.head_dim}), vocab "
          f"{cfg.vocab}; seq {TRAIN_SEQ}, global batch {batch_size} in "
          f"{n_micro} microbatches, remat {cfg.remat}, int8 moments "
          f"{cfg.opt_8bit}; reduced {json.dumps(reduced)}; init "
          f"{t_init:.2f} s", flush=True)

    # 1. step 1's gradient on the kernels (kept on the host: a model at
    # full width leaves the card no room for two gradients and a
    # replay), its replay on the plain backwards, and the controls
    # against the replay
    b0 = batch(0)
    zero()
    t0 = time.perf_counter()
    loss_k, g_k = accumulate_grads(cfg, params, b0)
    torch.cuda.synchronize(device)
    grad_s = time.perf_counter() - t0
    check_counts("step-1 gradient", counts(), 1)
    g_k = _to_host(torch, g_k)
    bwd_kernel, fwd_op = fa_ops.flash_attention_bhsd_bwd, \
        fa_ops.flash_attention_bhsd
    scan_bwd = sc_ops.mamba_scan_bwd
    replayed = {"attention": 0, "scan": 0}

    def plain_bwd(q, *args, **opts):
        # the plain backward, a few batch-heads at a time (at once, 64
        # heads x 4096^2 float32 scores would hold ~20 GB)
        replayed["attention"] += 1
        off = opts.pop("q_offset", None)
        parts = [fa_ref.flash_attention_bhsd_bwd_ref(
            q[r:r + 8], *(t[r:r + 8] for t in args), **opts,
            q_offset=0 if off is None else off[r:r + 8])
            for r in range(0, q.shape[0], 8)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def plain_scan_bwd(x, dt, bm, cm, a, d_skip, dy, states=None,
                       dh_last=None):
        replayed["scan"] += 1
        return sc_ref.mamba_scan_bwd_ref(x, dt, bm, cm, a, d_skip, dy,
                                         dh_last)

    def dk_zero(*args, **opts):
        dq, dk, dv = bwd_kernel(*args, **opts)
        return dq, torch.zeros_like(dk), dv

    def detached(q, k, v, **opts):
        with torch.no_grad():
            return fwd_op(q, k, v, **opts)

    def scan_db_zero(*args, **opts):
        dx, ddt, dbm, dcm, da, dd = scan_bwd(*args, **opts)
        return dx, ddt, torch.zeros_like(dbm), dcm, da, dd

    def scan_carry_zero(x, dt, bm, cm, a, d_skip, dy, states=None,
                        dh_last=None):
        return sc_ref.mamba_scan_bwd_chunked_ref(
            x, dt, bm, cm, a, d_skip, dy, dh_last, carry=False)

    originals = {(fa_ops, "flash_attention_bhsd_bwd"): bwd_kernel,
                 (fa_ops, "flash_attention_bhsd"): fwd_op,
                 (sc_ops, "mamba_scan_bwd"): scan_bwd}

    def patched(swaps):
        for (mod, attr), fn in swaps.items():
            setattr(mod, attr, fn)
        try:
            return accumulate_grads(cfg, params, b0)
        finally:
            for mod, attr in swaps:
                setattr(mod, attr, originals[(mod, attr)])

    loss_p, g_p = patched({(fa_ops, "flash_attention_bhsd_bwd"): plain_bwd,
                           (sc_ops, "mamba_scan_bwd"): plain_scan_bwd})
    want_replays = {"attention": calls * n_micro,
                    "scan": mamba_layers * n_micro}
    if replayed != want_replays:
        raise AssertionError(f"{name}: the replay took the plain "
                             f"backwards {replayed} times, want "
                             f"{want_replays}")
    gate = _grad_gate(torch, g_k, g_p, names)
    gate["loss_rel"] = abs(float(loss_k) - float(loss_p)) / abs(
        float(loss_p))
    del g_k
    print(f"{name} step-1 gradient, backward kernels against the plain "
          f"backwards: {json.dumps(gate)}", flush=True)
    if not gate["passes"] or gate["loss_rel"] > TRAIN_GATE["norm_rel"]:
        raise AssertionError(f"{name}: the kernels' gradient fails the "
                             f"gate {TRAIN_GATE}: {gate}")
    g_p = _to_host(torch, g_p)
    swaps = {"detached": {(fa_ops, "flash_attention_bhsd"): detached},
             "dk_zero": {(fa_ops, "flash_attention_bhsd_bwd"): dk_zero},
             "scan_db_zero": {(sc_ops, "mamba_scan_bwd"): scan_db_zero},
             "scan_carry_zero": {(sc_ops, "mamba_scan_bwd"):
                                 scan_carry_zero}}
    controls = {}
    for ctl in spec["controls"]:
        _, g_c = patched(swaps[ctl])
        controls[ctl] = _grad_gate(torch, g_c, g_p, names)
        del g_c
        print(f"{name} control {ctl}: {json.dumps(controls[ctl])}",
              flush=True)
        if controls[ctl]["passes"]:
            raise AssertionError(f"{name}: the {ctl} control passes the "
                                 f"gate {TRAIN_GATE}")
    del g_p
    gc.collect()
    torch.cuda.empty_cache()

    # 2. TRAIN_STEPS steps, a checkpoint after step 2
    opt_cfg = AdamWConfig(lr=TRAIN_LR, quantize_moments=cfg.opt_8bit)
    loss_steps = spec.get("loss_steps", TRAIN_STEPS)
    kept_out = dict.fromkeys(counts(), 0)

    def loss_b0():
        # the loss on step 1's batch (no gradient); its launches are
        # kept out of the training counts
        before = counts()
        with torch.no_grad():
            value = float(T.loss_fn(params, b0, cfg))
        for k, v in counts().items():
            kept_out[k] += v - before[k]
        return value
    opt = init_opt_state(params, opt_cfg)
    marks = []

    def mark(what):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((what, ev))

    step = make_train_step(cfg, opt_cfg, mark=mark)
    resume = spec.get("resume", False)
    ckpt_dir = ROOT / "build" / "train_ckpt" / name
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck = C.AsyncCheckpointer(str(ckpt_dir), keep=1) if resume else None
    torch.cuda.reset_peak_memory_stats(device)
    zero()
    losses, step_s, phases, save_s = [], [], [], None
    for i in range(TRAIN_STEPS):
        b = batch(i)
        marks.clear()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        phases.append(_phase_ms(marks))
        print(f"{name} step {i + 1}: loss {losses[-1]!r}, grad norm "
              f"{float(m['grad_norm']):.4f}, {step_s[-1]:.3f} s, "
              f"{batch_size * TRAIN_SEQ / step_s[-1]:.1f} tokens/s, "
              f"{json.dumps(phases[-1])} ms", flush=True)
        if i + 1 == 2 and resume:
            t0 = time.perf_counter()
            ck.save_async(2, {"params": params, "opt": opt},
                          extra={"data_step": 2})
            save_s = time.perf_counter() - t0
        if i + 1 == loss_steps < TRAIN_STEPS:
            after = loss_b0()
    train_counts = {k: v - kept_out[k] for k, v in counts().items()}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    t0 = time.perf_counter()
    if resume:
        ck.wait()
    write_wait_s = time.perf_counter() - t0
    check_counts("training", train_counts, TRAIN_STEPS)
    # the loss on step 1's batch after loss_steps steps, and after all
    after_all = loss_b0()
    if loss_steps == TRAIN_STEPS:
        after = after_all
    print(f"{name}: loss on step 1's batch {losses[0]!r} before the "
          f"steps, {after!r} after {loss_steps} (checked), {after_all!r} "
          f"after {TRAIN_STEPS}; step {TRAIN_STEPS}'s own batch "
          f"{losses[-1]!r}", flush=True)
    if not after < losses[0]:
        raise AssertionError(f"{name}: the loss on step 1's batch did not "
                             f"fall in {loss_steps} steps: {losses[0]!r} "
                             f"-> {after!r}")

    # 3. resume from step 2 into fresh tensors: steps 3.. again
    restore_s, resumed = None, None
    if resume:
        like = tree_map(lambda t: torch.empty((), dtype=t.dtype,
                                              device=t.device),
                        {"params": params, "opt": opt})
        del params, opt, m
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, extra = C.restore(str(ckpt_dir), 2, like)
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        params, opt = state["params"], state["opt"]
        resumed = []
        for i in range(int(extra["data_step"]), TRAIN_STEPS):
            params, opt, m = step(params, opt, batch(i))
            resumed.append(float(m["loss"]))
        if resumed != losses[2:]:
            raise AssertionError(f"{name}: resumed losses {resumed!r} are "
                                 f"not the uninterrupted run's "
                                 f"{losses[2:]!r}")
        del state
    del params, opt, m
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    out = {
        "arch": cfg.name, "params": n_params, "layers": cfg.layers,
        "mamba_layers": mamba_layers, "n_experts": cfg.n_experts,
        "enc_layers": cfg.enc_layers, "seq": TRAIN_SEQ,
        "global_batch": batch_size, "microbatches": n_micro,
        "remat": cfg.remat, "int8_moments": cfg.opt_8bit,
        "adamw_eps": opt_cfg.eps, "card": card,
        "init_s": t_init, "step1_grad_s": grad_s, "losses": losses,
        "step1_loss_as_gate": losses[0] == float(loss_k),
        "loss_step1_batch_after": after, "loss_checked_after_steps":
        loss_steps, "loss_step1_batch_after_all": after_all,
        "step_s": step_s, "tokens_per_s": [batch_size * TRAIN_SEQ / t
                                           for t in step_s],
        "phase_ms": phases,
        "mean_phase_ms_steps_2_on": {
            k: mean([p[k] for p in phases[1:]]) for k in phases[-1]},
        "peak_gib": peak, "attention_calls_per_microbatch": calls,
        "counts": train_counts, "gate": gate, "controls": controls,
        "checkpoint": {"save_call_s": save_s, "write_wait_s": write_wait_s,
                       "restore_s": restore_s, "resumed_losses": resumed},
        "reduced": {**reduced, "steps": TRAIN_STEPS}}
    print(f"{name}: {json.dumps(out)}", flush=True)
    return out


def launcher_smoke(torch, sc, device="cuda") -> dict:
    """Phase 11: ``launch/train.py --arch jamba_1_5_large_398b --smoke``
    on the card, as the reference's launcher runs it: its losses must be
    finite, the scan's backward must have launched the kernel and no
    scan call may have taken the plain version."""
    from repro_torch.kernels.mamba_scan import ops as sc_ops
    from repro_torch.launch import train as launch_train

    sc.bwd_launches = sc_ops.plain_calls = sc_ops.bwd_plain_calls = 0
    t0 = time.perf_counter()
    out = launch_train.main(["--arch", "jamba_1_5_large_398b", "--smoke",
                             "--steps", "4", "--batch", "2", "--seq", "64",
                             "--log-every", "2", "--device", device])
    res = {"losses": [float(v) for v in out["losses"]],
           "scan_backward_launches": sc.bwd_launches,
           "scan_plain_calls": sc_ops.plain_calls + sc_ops.bwd_plain_calls,
           "s": time.perf_counter() - t0}
    print(f"launch/train.py --arch jamba_1_5_large_398b --smoke on the "
          f"card: {json.dumps(res)}", flush=True)
    if not res["scan_backward_launches"] or res["scan_plain_calls"] \
            or not np.isfinite(res["losses"]).all():
        raise AssertionError(f"the Jamba launcher smoke run: {res}")
    return res


def _full(t) -> float:
    """A scalar (a DTensor's whole value) as a float."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def planner_on_card(torch, card, kernels, device="cuda") -> dict:
    """Phase 12: the planner's path on the card (the launcher's planner
    call at full width; the dry run's train cell as DTensors with real
    weights; its shape-only and real op counts). ``kernels``: the flash
    kernel, its ops and its plain module, the scan kernel, its ops and
    its plain module."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, init_opt_state, \
        make_train_step

    fa, fa_ops = kernels[:2]
    t_phase = time.perf_counter()
    full = get_config(PLANNER_ARCH)
    n_attn = full.layers
    tokens = PLANNER_BATCH * PLANNER_SEQ
    model_flops = 6.0 * full.active_param_count() * tokens

    def zero():
        fa.launches = fa.bwd_launches = 0
        fa_ops.plain_calls = fa_ops.local_calls = 0

    # (a) the launcher at full width
    zero()
    torch.cuda.reset_peak_memory_stats()
    out = launch_train.main([
        "--arch", PLANNER_ARCH, "--steps", str(PLANNER_STEPS), "--batch",
        str(PLANNER_BATCH), "--seq", str(PLANNER_SEQ), "--log-every", "1",
        "--device", device])
    plan = out["plan"]
    placements = {type(p).__name__ for sh in _shardings(plan.param_shardings)
                  for p in sh.placements}
    # remat: the forward twice, the backward once, per layer and step
    want = {"forward": 2 * n_attn * PLANNER_STEPS,
            "backward": n_attn * PLANNER_STEPS}
    launcher = {
        "mesh": str(plan.mesh), "mesh_device": plan.mesh.device_type,
        "mesh_size": plan.mesh.size(), "strategy": plan.strategy.name,
        "placements": sorted(placements), "legal": plan.estimate.legal,
        "estimate": {"hbm_bytes_per_chip": plan.estimate.hbm_bytes_per_chip,
                     "compute_s": plan.estimate.compute_s,
                     "memory_s": plan.estimate.memory_s,
                     "collective_s": plan.estimate.collective_s},
        "losses": [float(v) for v in out["losses"]],
        "step_s": out["step_s"],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "forward_launches": fa.launches, "backward_launches":
        fa.bwd_launches, "plain_calls": fa_ops.plain_calls,
        "expected_launches": want,
        "mfu_step2_bf16_datasheet": model_flops
        / (out["step_s"][-1] * PEAK_FLOPS["bfloat16"]), "card": card}
    del out
    print(f"phase 12 (a) launch/train.py --arch {PLANNER_ARCH} (full "
          f"width) on the card: {json.dumps(launcher)}", flush=True)
    if launcher["mesh_device"] != device or launcher["mesh_size"] != 1 \
            or placements != {"Replicate"} or not launcher["legal"] \
            or not np.isfinite(launcher["losses"]).all() \
            or launcher["forward_launches"] != want["forward"] \
            or launcher["backward_launches"] != want["backward"] \
            or launcher["plain_calls"]:
        raise AssertionError(f"phase 12 (a): {launcher}")

    # (b) the dry run's train cell with real weights as DTensors
    shape = ShapeSpec("planner_train", PLANNER_SEQ, PLANNER_BATCH, "train")
    rng = np.random.default_rng(SEED + 12)
    toks = torch.from_numpy(rng.integers(
        0, full.vocab, (PLANNER_BATCH, PLANNER_SEQ + 1))).to(device)
    batch = {"tokens": toks[:, :-1].to(torch.int32).contiguous(),
             "labels": toks[:, 1:].to(torch.int32).contiguous()}

    def weights():
        return T.init_params(full, torch.Generator(
            device=device).manual_seed(SEED))

    mesh = mesh_mod.make_host_mesh(device=device)
    try:
        params, specs = weights()
        zero()
        t0 = time.perf_counter()
        _, cfg, real, (_, _, m) = D.count_cell(
            full, shape, mesh, params=params, specs=specs, batch=batch)
        sharded = {"loss": _full(m["loss"]),
                   "grad_norm": _full(m["grad_norm"]),
                   "s": time.perf_counter() - t0,
                   "forward_launches": fa.launches,
                   "backward_launches": fa.bwd_launches,
                   "local_calls": fa_ops.local_calls,
                   "plain_calls": fa_ops.plain_calls,
                   "microbatch": cfg.microbatch}
        del params, m
    finally:
        mesh_mod.release()
    gc.collect()
    torch.cuda.empty_cache()
    params, _ = weights()
    opt_cfg = AdamWConfig(quantize_moments=cfg.opt_8bit)
    _, _, m = make_train_step(cfg, opt_cfg)(
        params, init_opt_state(params, opt_cfg), batch)
    plain = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del params, m
    gc.collect()
    torch.cuda.empty_cache()
    diff = {k: abs(sharded[k] - plain[k]) / abs(plain[k])
            for k in ("loss", "grad_norm")}
    calls = 2 * n_attn * cfg.microbatch
    want_b = {"forward": calls, "backward": n_attn * cfg.microbatch,
              "local_calls": calls}
    cell = {"sharded": sharded, "plain": plain, "rel_diff": diff,
            "same_bits": sharded["loss"] == plain["loss"]
            and sharded["grad_norm"] == plain["grad_norm"],
            "expected": want_b}
    print(f"phase 12 (b) the dry run's train cell as DTensors on the "
          f"card's 1x1 mesh: {json.dumps(cell)}", flush=True)
    if max(diff.values()) > TRAIN_GATE["norm_rel"] \
            or sharded["forward_launches"] != want_b["forward"] \
            or sharded["backward_launches"] != want_b["backward"] \
            or sharded["local_calls"] != want_b["local_calls"] \
            or sharded["plain_calls"]:
        raise AssertionError(f"phase 12 (b): {cell}")

    # (c) the shape-only count of the same cell against the real one
    mesh = mesh_mod.make_fake_mesh((1, 1), ("data", "model"))
    try:
        t0 = time.perf_counter()
        _, _, shape_only, _ = D.count_cell(full, shape, mesh)
        shape_only_s = time.perf_counter() - t0
    finally:
        mesh_mod.release()
    rel = abs(shape_only["flops_corrected"] - real["flops_corrected"]) \
        / real["flops_corrected"]
    counts = {"real": {k: real[k] for k in (
        "flops_corrected", "memory_bytes_corrected",
        "collective_bytes_corrected", "ops")},
        "shape_only": {k: shape_only[k] for k in (
            "flops_corrected", "memory_bytes_corrected",
            "collective_bytes_corrected", "ops")},
        "flops_rel_diff": rel, "shape_only_s": shape_only_s,
        "model_flops": model_flops,
        "mfu_step2_bf16_datasheet": launcher["mfu_step2_bf16_datasheet"],
        "card": card}
    print(f"phase 12 (c) op counts, shape-only (meta tensors, 1x1 fake "
          f"mesh) and real: "
          f"{json.dumps(counts)}", flush=True)
    if rel > PLANNER_FLOP_TOL:
        raise AssertionError(f"phase 12 (c): {counts}")

    decode = decode_cell_on_card(torch, card, fa, fa_ops, full, device)
    moe = moe_prefill_on_card(torch, card, fa, fa_ops, device)
    jamba = jamba_cell_on_card(torch, card, kernels, device)
    return {"launcher": launcher, "cell": cell, "counts": counts,
            "decode": decode, "moe_prefill": moe, "jamba_train": jamba,
            "s": time.perf_counter() - t_phase}


def decode_cell_on_card(torch, card, fa, fa_ops, full, device) -> dict:
    """Phase 12 (d): the dry run's decode cell with real weights and a
    prefill's caches as DTensors on the card's 1x1 mesh, against the
    same decode step on plain tensors."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core import planner as PL
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    toks = torch.from_numpy(rng.integers(
        0, full.vocab, (DECODE_BATCH, DECODE_PROMPT + 1)).astype(
            np.int32)).to(device)
    params, specs = T.init_params(full, torch.Generator(
        device=device).manual_seed(SEED))
    with torch.no_grad():
        caches, _ = T.prefill(params, {"tokens": toks[:, :-1]}, full,
                              max_seq=DECODE_MAX_SEQ)
        for c in caches:                # one position a layer
            c["kv"]["index"] = c["kv"]["index"][:, 0].contiguous()
        step = toks[:, -1:].contiguous()
        plain_caches = [{"kv": {k: t.clone() for k, t in c["kv"].items()}}
                        for c in caches]
        plain, _ = T.decode_step(params, step, plain_caches, full)
        plain = plain[:, :full.vocab].float()
        del plain_caches
        shape = ShapeSpec("planner_decode", DECODE_MAX_SEQ, DECODE_BATCH,
                          "decode")
        moved = []

        def probe(cfg, args, out):
            strategy = next(st for st in PL.make_strategies(mesh)
                            if st.name == "fsdp_tp")

            def check(t):
                want = PL.cache_sharding(mesh, strategy, cfg, DECODE_BATCH,
                                         tuple(t.shape)).placements
                if tuple(t.placements) != tuple(want):
                    moved.append(str(t.placements))

            for c in args[2]:
                for t in c["kv"].values():
                    check(t)

        mesh = mesh_mod.make_host_mesh(device=device)
        try:
            fa.launches = 0
            fa_ops.plain_calls = fa_ops.local_calls = 0
            t1 = time.perf_counter()
            plan, _, _, (logits, _) = D.count_cell(
                dataclasses.replace(full, force_strategy="fsdp_tp"), shape,
                mesh, params=params, specs=specs,
                batch={"tokens": step, "caches": caches}, probe=probe)
            step_s = time.perf_counter() - t1
            got = logits.full_tensor()[:, :full.vocab].float()
            launches, local_calls, plain_calls = \
                fa.launches, fa_ops.local_calls, fa_ops.plain_calls
        finally:
            mesh_mod.release()
    res = {"strategy": plan.strategy.name,
           "argmax_equal": bool((got.argmax(-1) == plain.argmax(-1)).all()),
           "max_logit_diff": float((got - plain).abs().max()),
           "launches": launches, "local_calls": local_calls,
           "plain_calls": plain_calls, "caches_moved": moved,
           "expected_launches": full.layers, "step_s": step_s,
           "s": time.perf_counter() - t0, "card": card}
    del params, caches, logits, got, plain
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 (d) the dry run's decode cell ({DECODE_BATCH} rows "
          f"after a {DECODE_PROMPT}-token prefill) as DTensors on the "
          f"card's 1x1 mesh: {json.dumps(res)}", flush=True)
    if not res["argmax_equal"] or res["max_logit_diff"] > LM_LOGIT_TOL \
            or launches != full.layers or local_calls != full.layers \
            or plain_calls or moved:
        raise AssertionError(f"phase 12 (d): {res}")
    return res


def moe_prefill_on_card(torch, card, fa, fa_ops, device) -> dict:
    """Phase 12 (e): the dry run's prefill cell of MOE_ARCH with real
    weights as DTensors on the card's 1x1 mesh, against the same prefill
    on plain tensors: the MoE layers' routing, dispatch and combine on
    each rank's shard (``moe._Sharded``) in every layer, the same
    assignments dropped."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    full = get_config(MOE_ARCH)
    rng = np.random.default_rng(SEED + 14)
    toks = torch.from_numpy(rng.integers(
        0, full.vocab, (MOE_BATCH, MOE_PROMPT)).astype(np.int32)).to(device)
    params, specs = T.init_params(full, torch.Generator(
        device=device).manual_seed(SEED))
    plain_slots, sharded_slots = [], []
    route, sharded_route = moe.route, moe._Sharded.route

    def plain_route(p, ht, cfg):
        weights, slot, cap = route(p, ht, cfg)
        plain_slots.append((slot, p["router"].shape[1] * cap))
        return weights, slot, cap

    def spy(layer, h, router):
        weights, slot = sharded_route(layer, h, router)
        sharded_slots.append((slot.full_tensor(), layer.e_pad * layer.cap))
        return weights, slot

    def dropped(slots):
        return [s.reshape(-1) == over for s, over in slots]

    moe.route, moe._Sharded.route = plain_route, spy
    try:
        with torch.no_grad():
            _, plain = T.prefill(params, {"tokens": toks}, full,
                                 max_seq=MOE_PROMPT)
            plain = plain.float()
            shape = ShapeSpec("moe_prefill", MOE_PROMPT, MOE_BATCH,
                              "prefill")
            mesh = mesh_mod.make_host_mesh(device=device)
            try:
                fa.launches = moe.local_calls = 0
                fa_ops.plain_calls = fa_ops.local_calls = 0
                t1 = time.perf_counter()
                plan, _, _, (_, logits) = D.count_cell(
                    dataclasses.replace(full, force_strategy="fsdp_tp"),
                    shape, mesh, params=params, specs=specs,
                    batch={"tokens": toks})
                step_s = time.perf_counter() - t1
                got = logits.full_tensor().float()
                launches, local_calls, plain_calls, moe_calls = \
                    fa.launches, fa_ops.local_calls, fa_ops.plain_calls, \
                    moe.local_calls
            finally:
                mesh_mod.release()
    finally:
        moe.route, moe._Sharded.route = route, sharded_route
    want, have = dropped(plain_slots), dropped(sharded_slots)
    res = {"strategy": plan.strategy.name,
           "argmax_equal": bool((got.argmax(-1) == plain.argmax(-1)).all()),
           "max_logit_diff": float((got - plain).abs().max()),
           "launches": launches, "local_calls": local_calls,
           "plain_calls": plain_calls, "moe_local_calls": moe_calls,
           "dropped": [int(m.sum()) for m in have],
           "same_drops": len(want) == len(have) == full.layers and all(
               bool(torch.equal(a, b)) for a, b in zip(want, have)),
           "expected_layers": full.layers, "step_s": step_s,
           "s": time.perf_counter() - t0, "card": card}
    del params, logits, got, plain, plain_slots, sharded_slots, want, have
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 (e) the dry run's prefill cell of {MOE_ARCH} "
          f"({MOE_BATCH} rows of {MOE_PROMPT} tokens) as DTensors on the "
          f"card's 1x1 mesh: {json.dumps(res)}", flush=True)
    if not res["argmax_equal"] or res["max_logit_diff"] > LM_LOGIT_TOL \
            or launches != full.layers or local_calls != full.layers \
            or plain_calls or moe_calls != full.layers \
            or not sum(res["dropped"]) or not res["same_drops"]:
        raise AssertionError(f"phase 12 (e): {res}")
    return res


def jamba_cell_on_card(torch, card, kernels, device) -> dict:
    """Phase 12 (f): the dry run's train cell of JAMBA_CELL_RUN's model
    as DTensors on the card's 1x1 mesh under FSDP, its loss and gradient
    only, with no mesh axis for the experts: each MoE layer's expert
    products on the weights' shards (``moe._experts_on_shards``), every
    attention and scan on its kernels; against the same loss and
    gradient on plain tensors, and its shape-only op count against the
    real one."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.train.train_loop import grad_norm, loss_and_grads
    from repro_torch.train.tree import leaves_with_paths

    fa, fa_ops, _, sc, sc_ops, _ = kernels
    t0 = time.perf_counter()
    spec = TRAIN_RUNS[JAMBA_CELL_RUN]
    cfg, reduced = _train_config(torch, spec)
    cfg = dataclasses.replace(cfg, force_strategy="fsdp")
    kinds = [cfg.layer_kind(i) for i in range(cfg.period)]
    n_attn = cfg.n_periods * kinds.count("attn")
    n_mamba = cfg.n_periods * kinds.count("mamba")
    n_moe = cfg.n_periods * sum(cfg.layer_is_moe(i)
                                for i in range(cfg.period))
    remat = 2 if cfg.remat in ("full", "dots") else 1
    rng = np.random.default_rng(SEED + 15)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (spec["batch"], TRAIN_SEQ + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous().to(device),
             "labels": toks[:, 1:].contiguous().to(device)}
    shape = ShapeSpec("jamba_train", TRAIN_SEQ, spec["batch"], "train")
    planned = []

    def wire(wired):
        # a mesh of size-1 axes gives the 16 padded experts an axis;
        # (32, 8)'s plan gives them none
        planned.append(wired.moe_expert_axes)
        return dataclasses.replace(wired, moe_expert_axes=None,
                                   moe_capacity_axes=None)

    def weights():
        return T.init_params(cfg, torch.Generator(
            device=device).manual_seed(SEED), share_experts=True,
            expert_multiple=spec["expert_multiple"])

    def experts(grads):
        return {"/".join(path): g for path, g in leaves_with_paths(grads)
                if "moe" in path and path[-1] in ("wi", "wg", "wo",
                                                  "router")}

    mesh = mesh_mod.make_host_mesh(device=device)
    try:
        params, specs = weights()
        fa.launches = fa.bwd_launches = 0
        fa_ops.plain_calls = fa_ops.local_calls = 0
        sc.launches = sc.bwd_launches = 0
        sc_ops.plain_calls = sc_ops.bwd_plain_calls = sc_ops.local_calls = 0
        moe.local_calls = moe.shard_calls = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        plan, wired, real, (loss, grads, norm) = D.count_cell(
            cfg, shape, mesh, params=params, specs=specs, batch=batch,
            grad_only=True, wire=wire)
        sharded = {"loss": _full(loss), "grad_norm": _full(norm),
                   "step_s": time.perf_counter() - t1,
                   "forward_launches": fa.launches,
                   "backward_launches": fa.bwd_launches,
                   "local_calls": fa_ops.local_calls,
                   "plain_calls": fa_ops.plain_calls,
                   "scan_forward_launches": sc.launches,
                   "scan_backward_launches": sc.bwd_launches,
                   "scan_local_calls": sc_ops.local_calls,
                   "scan_plain_calls": sc_ops.plain_calls
                   + sc_ops.bwd_plain_calls,
                   "moe_local_calls": moe.local_calls,
                   "moe_shard_calls": moe.shard_calls,
                   "peak_bytes": torch.cuda.max_memory_allocated()}
        got = experts(grads)
        names = sorted(got)
        got = _to_host(torch, [got[k].full_tensor() for k in names])
        del params, grads, loss, norm
    finally:
        mesh_mod.release()
    gc.collect()
    torch.cuda.empty_cache()
    params, _ = weights()
    loss, grads = loss_and_grads(wired, params, batch)
    plain = {"loss": float(loss), "grad_norm": float(grad_norm(grads))}
    want = experts(grads)
    gate = _grad_gate(torch, got, [want[k] for k in names], names)
    del params, grads, loss, want, got
    gc.collect()
    torch.cuda.empty_cache()
    # the shape-only count of the same cell (meta weights: 16 padded
    # experts, unshared; the expert products' rows, E x cap, and so their
    # FLOPs, are the same)
    fake = mesh_mod.make_fake_mesh((1, 1), ("data", "model"))
    try:
        t1 = time.perf_counter()
        _, _, shape_only, _ = D.count_cell(cfg, shape, fake,
                                           grad_only=True, wire=wire)
        shape_only_s = time.perf_counter() - t1
    finally:
        mesh_mod.release()
    flops_rel = abs(shape_only["flops_corrected"] - real["flops_corrected"]) \
        / real["flops_corrected"]
    diff = {k: abs(sharded[k] - plain[k]) / abs(plain[k])
            for k in ("loss", "grad_norm")}
    want_counts = {
        "forward_launches": remat * n_attn, "backward_launches": n_attn,
        "local_calls": remat * n_attn, "plain_calls": 0,
        "scan_forward_launches": remat * n_mamba,
        "scan_backward_launches": n_mamba,
        "scan_local_calls": remat * n_mamba, "scan_plain_calls": 0,
        "moe_local_calls": remat * n_moe, "moe_shard_calls": remat * n_moe}
    res = {"strategy": plan.strategy.name, "planned_moe_expert_axes":
           planned[0], "wired_moe_expert_axes": wired.moe_expert_axes,
           "sharded": sharded, "plain": plain, "rel_diff": diff,
           "expert_grads": gate, "expected": want_counts,
           "flops": {"real": real["flops_corrected"],
                     "shape_only": shape_only["flops_corrected"],
                     "rel_diff": flops_rel, "shape_only_s": shape_only_s},
           "collective_bytes": real["collective_bytes_corrected"],
           "reduced": reduced, "s": time.perf_counter() - t0,
           "card": card}
    print(f"phase 12 (f) the dry run's train cell of {cfg.name} (one "
          f"period, {TRAIN_SEQ} tokens) as DTensors on the card's 1x1 "
          f"mesh, FSDP, no expert axis, loss and gradient: "
          f"{json.dumps(res)}", flush=True)
    if plan.strategy.name != "fsdp" or wired.moe_expert_axes is not None \
            or max(diff.values()) > TRAIN_GATE["norm_rel"] \
            or not gate["passes"] or flops_rel > PLANNER_FLOP_TOL \
            or any(sharded[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"phase 12 (f): {res}")
    return res


def _shardings(tree) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _shardings(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _shardings(v)]
    return [tree]


def _summary(name, source, replaces, cases, path):
    """The kernel's entry of the ``{"kernels": [...]}`` line: the
    numbers of its main path's chunk case (the first), the worst error
    per dtype, every case, and its path's run."""
    chunk = cases[0]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": path["launches"],
        "max_abs_err": chunk["max_abs_err"], "ms": chunk["ms"],
        "plain_ms": chunk["plain_ms"], "bound_ms": chunk["bound_ms"],
        "bound_by": chunk["bound_by"], "library_ms": chunk["library_ms"],
        "shape": chunk["shape"], "dtype": chunk["dtype"],
        "dtypes": {c["dtype"]: max(d["max_abs_err"] for d in cases
                                   if d["dtype"] == c["dtype"])
                   for c in cases},
        "cases": cases, "main_path": path,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. environment
    card = _nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import obs
    from repro_torch.core import cost
    from repro_torch.core.compiler import compile_kernel
    from repro_torch.distrib import ClusterRuntime
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import mamba_scan as sc
    from repro_torch.kernels.mamba_scan import ops as sc_ops
    from repro_torch.kernels.mamba_scan import ref as sc_ref
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_promoted_ref
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matmul.ref import matmul_ref

    if any(m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")

    # 2. build, one nvcc per source, all started together
    kernels = {"matmul": mm, "flash_attention": fa, "mamba_scan": sc}
    # (name, source)
    sources = [(name, k.SOURCE) for name, k in kernels.items()] \
        + [("flash_attention_bwd", fa.BWD_SOURCE),
           ("mamba_scan_bwd", sc.BWD_SOURCE)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(kbuild.build, [src for _, src in sources]))
    for (name, src), (lib, log, secs) in zip(sources, built):
        print(f"built {src.relative_to(ROOT)} -> "
              f"{lib.relative_to(ROOT)} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        for pattern, (stores, loads) in SPILL_MAX[name]:
            found = spills(log, pattern)
            print(f"  checked functions of {name} ({pattern}): "
                  f"{len(found)}, spill bytes (stores, loads) "
                  f"{sorted(set(found.values()))}, at most "
                  f"{(stores, loads)}", flush=True)
            if not found or any(s > stores or ld > loads
                                for s, ld in found.values()):
                raise AssertionError(f"{name}: ptxas reports spills over "
                                     f"{(stores, loads)} (or no checked "
                                     f"function) in {pattern}: {found}")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    cases = {"matmul": check_matmul(torch, mm, matmul_ref),
             "flash_attention": check_flash(torch, fa, fa_ops, fa_ref),
             "flash_attention_bwd": check_flash_bwd(torch, fa, fa_ref),
             "mamba_scan": check_scan(torch, sc,
                                      mamba_scan_promoted_ref),
             "mamba_scan_bwd": check_scan_bwd(torch, sc, sc_ref)}
    for name, label, dname, before, run in EARLIER_MS:
        row = next(c for c in cases[name]
                   if c["case"] == label and c["dtype"] == dname)
        print(f"{name} {label} {dname} {row['shape']}: "
              f"{row['ms']:.3f} ms redesigned for Hopper, {before:.3f} "
              f"ms before ({run})", flush=True)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 4. the main paths
    t0 = time.perf_counter()
    # trace=True: worker run spans give the compute and idle phases.
    # Liveness is the runtime's default (1 s beats, 15 missed): no run
    # may count a fault (a respawn, an expired heartbeat), but the STAP
    # kill drill's.
    rt = ClusterRuntime(workers=WORKERS, device="cuda", trace=True)
    print(f"fleet: {WORKERS} workers up in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(start method {rt.start_method})", flush=True)
    try:
        paths = main_paths(rt, compile_kernel, obs, cost, kernels)
        print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        # 5. the STAP path, every count to 0 first
        pricing = _record_pricing(cost)
        for k in ("torch_chunks", "torch_fallbacks", "cuda_chunks",
                  "cuda_fallbacks", "batch_hits", "batch_builds",
                  "batch_fallbacks"):
            setattr(rt, k, 0)
        rt.chunks_executed.clear()
        stap = stap_path(rt, compile_kernel, obs, pricing, torch)
        print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

        # 6. the whole-kernel path (in this process; the fleet idles)
        whole = whole_kernel_path(torch)
        print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

        # 7. STAP served on the same fleet
        served = served_stap(rt, compile_kernel, obs, torch, card)
    finally:
        rt.shutdown()
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 8. raylite on the card
    import examples.torch_stap_pipeline as pipeline
    raylite = pipeline.main("cuda")
    chunks = raylite["pfor_chunks"]
    if not chunks["torch"] or chunks["np"]:
        raise AssertionError(f"raylite: chunks {chunks}, not all torch")
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 9. the LM served on the card
    lm = served_lm(torch, card, fa, fa_ops, fa_ref)
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 9b. the LM served from a cluster worker, with a worker-kill drill
    cluster_lm = served_lm_cluster(torch, card)
    print(f"phase 9b done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 10. the MoE and recurrent families served on the card
    family_kernels = (fa, fa_ops, fa_ref, sc, sc_ops, sc_ref)
    families = {name: served_family(torch, card, name, family_kernels)
                for name in FAMILIES}
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 11. training on the card, each run on a card the earlier phases
    # have left (nearly) empty
    train = {}
    for name in TRAIN_RUNS:
        left = _settle(torch, f"before {name}")
        if left > SETTLED_MAX_GIB:
            raise AssertionError(f"{name}: {left:.3f} GiB still allocated "
                                 f"before the run (at most "
                                 f"{SETTLED_MAX_GIB} GiB)")
        train[name] = trained(torch, card, name,
                              (fa, fa_ops, fa_ref, sc, sc_ops, sc_ref))
        train[name]["allocated_before_gib"] = left
    launcher = launcher_smoke(torch, sc)
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 12. the planner on the card
    left = _settle(torch, "before phase 12")
    if left > SETTLED_MAX_GIB:
        raise AssertionError(f"phase 12: {left:.3f} GiB still allocated "
                             f"(at most {SETTLED_MAX_GIB} GiB)")
    planner = planner_on_card(torch, card,
                              (fa, fa_ops, fa_ref, sc, sc_ops, sc_ref))
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s "
          f"({planner['s']:.1f} s)", flush=True)

    # 13. summary
    base = "src/repro_torch/kernels"
    summary = [
        _summary("matmul", f"{base}/matmul/csrc/matmul.cu",
                 "src/repro/kernels/matmul/matmul.py:37", cases["matmul"],
                 paths["matmul"]),
        _summary("flash_attention",
                 f"{base}/flash_attention/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/flash_attention.py:75",
                 cases["flash_attention"], paths["flash_attention"]),
        _summary("mamba_scan", f"{base}/mamba_scan/csrc/mamba_scan.cu",
                 "src/repro/kernels/mamba_scan/mamba_scan.py:55",
                 cases["mamba_scan"], paths["mamba_scan"]),
    ]
    summary[1]["lm_path"] = {k: lm[k] for k in (
        "launches", "plain_calls", "prefills", "decode_steps", "requests")}
    # phase 9b's run in the workers (the replayed ops' launches included)
    summary[1]["cluster_lm_path"] = {k: cluster_lm[k] for k in (
        "launches", "plain_calls", "prefills", "decode_steps", "requests",
        "lineage_replays")}
    # phase 10's runs: flash in both models, the scan in Jamba's prefills
    summary[1]["family_paths"] = {name: {
        "launches": f["flash_launches"], "plain_calls":
        f["flash_plain_calls"], "prefills": f["prefills"],
        "decode_steps": f["decode_steps"]} for name, f in families.items()}
    # phase 11's runs: the forward twice (remat) and the backward once
    # for every attention call
    summary[1]["train_paths"] = {name: {
        "launches": t["counts"]["forward_launches"],
        "plain_calls": t["counts"]["plain_calls"],
        "steps": TRAIN_STEPS} for name, t in train.items()}
    # phase 12's runs: the launcher's steps, and the DTensor train and
    # decode steps' attention calls through local_map
    summary[1]["planner_paths"] = {
        "launcher": {k: planner["launcher"][k] for k in (
            "forward_launches", "backward_launches", "plain_calls")},
        "dtensor_step": {k: planner["cell"]["sharded"][k] for k in (
            "forward_launches", "backward_launches", "local_calls",
            "plain_calls")},
        "dtensor_decode_step": {k: planner["decode"][k] for k in (
            "launches", "local_calls", "plain_calls", "max_logit_diff",
            "step_s")},
        "dtensor_moe_prefill": {k: planner["moe_prefill"][k] for k in (
            "launches", "local_calls", "plain_calls", "moe_local_calls",
            "max_logit_diff", "step_s")},
        "dtensor_jamba_train": {k: planner["jamba_train"]["sharded"][k]
                                for k in (
            "forward_launches", "backward_launches", "local_calls",
            "plain_calls", "moe_local_calls", "moe_shard_calls",
            "step_s")}}
    bwd = cases["flash_attention_bwd"]
    main_case = next(c for c in bwd if c["case"] == "stablelm")
    summary[1]["backward"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": f"{base}/flash_attention/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:75"
                    " (the gradient of the function it computes; the TPU "
                    "package took it from JAX autodiff)",
        "launches": sum(t["counts"]["backward_launches"]
                        for t in train.values()),
        "kernels_per_launch": 3,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": main_case["shape"], "dtype": main_case["dtype"],
        "dtypes": {c["dtype"]: max(d["max_abs_err"] for d in bwd
                                   if d["dtype"] == c["dtype"])
                   for c in bwd},
        "cases": bwd,
        "train_paths": {name: {
            "launches": t["counts"]["backward_launches"],
            "plain_calls": t["counts"]["plain_calls"]}
            for name, t in train.items()}}
    summary[2]["family_paths"] = {name: {
        "launches": f["scan_launches"], "plain_calls":
        f["scan_plain_calls"], "prefills": f["prefills"]}
        for name, f in families.items() if f["scan_launches"]}
    # phase 11's hybrid run: each Mamba layer's scan forward twice
    # (remat) and backward once a step
    scan_train = {name: {
        "launches": t["counts"]["scan_forward_launches"],
        "backward_launches": t["counts"]["scan_backward_launches"],
        "plain_calls": t["counts"]["scan_plain_calls"],
        "steps": TRAIN_STEPS} for name, t in train.items()
        if t["counts"]["scan_backward_launches"]}
    summary[2]["train_paths"] = scan_train
    # phase 12 (f): the DTensor train cell's scans through local_map
    summary[2]["planner_paths"] = {
        "dtensor_jamba_train": {k: planner["jamba_train"]["sharded"][k]
                                for k in (
            "scan_forward_launches", "scan_backward_launches",
            "scan_local_calls", "scan_plain_calls")}}
    sbwd = cases["mamba_scan_bwd"]
    main_case = sbwd[0]
    summary[2]["backward"] = {
        "name": "mamba_scan_bwd", "route": "cuda",
        "source": f"{base}/mamba_scan/csrc/mamba_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:55 (the "
                    "gradient of the function it computes; the TPU package "
                    "took it from JAX autodiff of its jnp scan, "
                    "src/repro/models/ssm.py:51)",
        "launches": sum(t["backward_launches"] for t in scan_train.values()),
        "kernels_per_launch": 5,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": main_case["shape"], "dtype": main_case["dtype"],
        "dtypes": {c["dtype"]: max(d["max_abs_err"] for d in sbwd
                                   if d["dtype"] == c["dtype"])
                   for c in sbwd},
        "cases": sbwd, "train_paths": scan_train,
        "launcher_smoke": launcher}
    print(json.dumps({"stap_path": stap, "whole_kernel_path": whole,
                      "served_stap": served, "raylite": raylite,
                      "served_lm": lm, "served_lm_cluster": cluster_lm,
                      "served_families": families,
                      "trained": train, "jamba_launcher_smoke": launcher,
                      "planner": planner}),
          flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
