"""The port's launch layer on the CPU: the op count
(``launch/op_analysis.py``) against hand counts, the dry run
(``launch/dryrun.py``) on a fake (2, 2) ``DeviceMesh`` for three
families × three kinds and against the reference's trip-count-corrected
HLO count, the kernels' ops on DTensors over four ``gloo`` ranks, the
production meshes, and the training launcher's planner call.

Every test that starts a process group destroys it (a worker process
runs several test files). Tolerances are stated with each test.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core import planner as PL
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_analysis as OA

from torch_reference import run_reference

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("stablelm_3b", "olmoe_1b_7b", "jamba_1_5_large_398b")
SMOKE = {"train": ShapeSpec("smoke_train", 64, 8, "train"),
         "prefill": ShapeSpec("smoke_prefill", 64, 8, "prefill"),
         "decode": ShapeSpec("smoke_decode", 64, 8, "decode")}


@pytest.fixture
def mesh22():
    mesh = mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
    yield mesh
    mesh_mod.release()


# ---------------------------------------------------------------------------
# op_analysis against hand counts (exact)
# ---------------------------------------------------------------------------

def test_op_count_of_a_product():
    x, y = torch.randn(64, 32), torch.randn(32, 16)
    got = OA.analyze_step(torch.mm, x, y)
    assert got["flops_corrected"] == 2 * 64 * 32 * 16
    assert got["memory_bytes_corrected"] == 4 * (64 * 32 + 32 * 16
                                                 + 64 * 16)
    assert got["collective_bytes_corrected"] == 0
    assert got["max_trip_product"] == 1
    assert got["top_memory_opcodes"] == {"mm": 4 * (64 * 32 + 32 * 16
                                                    + 64 * 16)}


def test_op_count_of_a_sharded_product_is_per_chip(mesh22):
    """X's rows over ``data``, Y's columns over ``model``: each chip
    multiplies a quarter, with no collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh22,
                          [Shard(0), Replicate()])
    y = distribute_tensor(torch.empty(32, 16, device="meta"), mesh22,
                          [Replicate(), Shard(1)])
    got = OA.analyze_step(torch.mm, x, y)
    assert got["flops_corrected"] == 2 * 64 * 32 * 16 / 4
    assert got["memory_bytes_corrected"] == 4 * (32 * 32 + 32 * 8 + 32 * 8)
    assert got["collective_bytes_corrected"] == 0


def test_op_count_of_a_redistribute_is_its_all_gather(mesh22):
    """Shard(0) → Replicate over ``data``: one all-gather whose output is
    the whole tensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh22,
                          [Shard(0), Replicate()])
    got = OA.analyze_step(
        lambda t: t.redistribute(mesh22, [Replicate(), Replicate()]), x)
    assert got["collective_per_kind"]["all-gather"] == 64 * 32 * 4
    assert got["collective_counts"] == {
        "all-gather": 1, "all-reduce": 0, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    assert got["collective_bytes_corrected"] == 64 * 32 * 4
    assert got["flops_corrected"] == 0


def test_op_count_skips_dtensor_propagation(mesh22):
    """An in-place ``index_copy_`` into a DTensor (a KV cache's write):
    DTensor propagates its sharding through the op's decomposition, run
    on meta tensors of the global shape; the count holds only the local
    op (the local cache read and written, the local rows read), not the
    global cache, which no rank touches."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    cache = distribute_tensor(torch.empty(64, 128, 16, device="meta"),
                              mesh22, [Shard(0), Replicate()])
    rows = distribute_tensor(torch.empty(64, 1, 16, device="meta"),
                             mesh22, [Shard(0), Replicate()])
    at = torch.zeros(1, dtype=torch.long, device="meta")
    got = OA.analyze_step(lambda: cache.index_copy_(1, at, rows))
    local = 4 * (32 * 128 * 16 * 2 + 32 * 16)
    assert got["memory_bytes_corrected"] <= local + 64


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_ops_count_by_their_formulas(device):
    """The flash and scan ops' custom ops count by their formulas
    (SDPA's 4·BH·Sq·Skv·D forward, 10·… backward; the scan's
    SCAN_FWD_OPS / SCAN_BWD_OPS per element), whether the plain version
    runs (CPU tensors) or only the shape function (meta tensors); the
    scan's also under ``flops_scan``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as sc_ops

    bh, s, d = 6, 32, 16
    q, k, v = (torch.randn(bh, s, d, device=device, requires_grad=True)
               for _ in range(3))

    def attn():
        out = fa_ops.flash_attention_bhsd(q, k, v, causal=True)
        torch.autograd.grad(out.sum(), (q, k, v))

    got = OA.analyze_step(attn)
    x = torch.randn(2, 24, 8, device=device, requires_grad=True)
    bm = torch.randn(2, 24, 4, device=device)
    scan = OA.analyze_step(lambda: torch.autograd.grad(
        sc_ops.mamba_scan(x, x, bm, bm, torch.randn(8, 4, device=device),
                          torch.randn(8, device=device)).sum(), x))
    assert got["flops_corrected"] == (4 + 10) * bh * s * s * d
    assert scan["flops_corrected"] == (OA.SCAN_FWD_OPS + OA.SCAN_BWD_OPS) \
        * 2 * 24 * 8 * 4
    assert scan["flops_scan"] == scan["flops_corrected"]
    assert got["flops_scan"] == 0


# ---------------------------------------------------------------------------
# The dry run's cells on a fake (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", [None, "fsdp_tp"])
@pytest.mark.parametrize("kind", list(SMOKE))
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cell_runs_ok(mesh22, arch, kind, strategy):
    """The planner's own choice (``dp`` at these sizes) and FSDP×TP
    forced: every op of the step finds a sharding."""
    cfg = dataclasses.replace(get_smoke_config(arch),
                              force_strategy=strategy)
    shape = SMOKE[kind]
    D.SHAPES.setdefault(shape.name, shape)
    res = D.run_cell(arch, shape.name, cfg_override=cfg, mesh=mesh22,
                     verbose=False)
    assert res["status"] == "ok"
    assert res["chips"] == 4
    if strategy:
        assert res["strategy"] == strategy
    counts = res["op_counts"]
    assert counts["flops_corrected"] > 0
    assert counts["memory_bytes_corrected"] > 0
    if kind == "train" or strategy:
        assert counts["collective_bytes_corrected"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


def test_microbatches_of_a_dtensor_batch_split_each_ranks_rows(mesh22):
    """A batch sharded over the ranks splits into microbatches per rank
    (each rank's i-th rows), sharded as the batch; a train cell with two
    microbatches runs ``ok``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.train.train_loop import _split_microbatches

    batch = {"tokens": distribute_tensor(torch.empty(8, 16, device="meta"),
                                         mesh22, [Shard(0), Shard(0)])}
    parts = _split_microbatches(batch, 2)
    assert [tuple(p["tokens"].shape) for p in parts] == [(4, 16)] * 2
    assert all(tuple(p["tokens"].to_local().shape) == (1, 16)
               and p["tokens"].placements == (Shard(0), Shard(0))
               for p in parts)
    rep = distribute_tensor(torch.empty(8, 16, device="meta"), mesh22,
                            [Replicate(), Replicate()])
    with pytest.raises(ValueError):
        _split_microbatches({"tokens": distribute_tensor(
            torch.empty(4, 16, device="meta"), mesh22,
            [Shard(0), Shard(0)])}, 2)
    assert _split_microbatches({"t": rep}, 2)[1]["t"].shape == (4, 16)
    cfg = dataclasses.replace(get_smoke_config("stablelm_3b"), microbatch=2)
    D.SHAPES.setdefault(SMOKE["train"].name, SMOKE["train"])
    res = D.run_cell("stablelm_3b", SMOKE["train"].name, cfg_override=cfg,
                     mesh=mesh22, verbose=False)
    assert res["status"] == "ok" and res["microbatch"] == 2


REFERENCE_TRAIN_CELL = """
import dataclasses, json
jax.config.update("jax_enable_x64", False)
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.configs.registry import ShapeSpec
from repro.core import planner as PL
from repro.launch import dryrun as D, hlo_analysis
from repro.models import transformer as T

cfg = get_smoke_config(str(inputs["arch"]))
shape = ShapeSpec("smoke_train", int(inputs["seq"]), int(inputs["batch"]),
                  "train")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
p_shapes = jax.eval_shape(lambda: T.init_params(cfg, jax.random.key(0))[0])
plan = PL.plan(cfg, D._static_specs(cfg), p_shapes, mesh,
               seq=shape.seq_len, batch=shape.global_batch, kind="train")
rows = shape.global_batch // max(1, plan.estimate.microbatch)
ax = ()
for i in range(len(plan.strategy.batch_axes), 0, -1):
    cand = plan.strategy.batch_axes[:i]
    if rows % PL._mesh_size(mesh, cand) == 0:
        ax = cand
        break
cfg = dataclasses.replace(cfg, microbatch=plan.estimate.microbatch,
                          act_batch_axes=ax or None)
jitted, args = D.build_train_cell(cfg, shape, mesh, plan)
with mesh:
    compiled = jitted.lower(*args).compile()
res = hlo_analysis.analyze_compiled(compiled)
outputs["res"] = np.asarray(json.dumps({
    "strategy": plan.strategy.name,
    "microbatch": plan.estimate.microbatch,
    "flops": res["flops_corrected"]}))
"""


def test_smoke_train_flops_within_5_percent_of_the_reference(mesh22,
                                                             tmp_path):
    """Per-chip FLOPs of stablelm_3b's smoke train cell (seq 64, batch 8)
    on a (2, 2) mesh within 5 % of the reference's trip-count-corrected
    HLO count of the same cell (the same strategy and microbatch; the
    port's flash backward recomputes the scores, 10 products of the
    dense (Sq, Skv) where autodiff of the reference's takes 8)."""
    out = run_reference(REFERENCE_TRAIN_CELL,
                        {"arch": np.asarray("stablelm_3b"),
                         "seq": np.asarray(64), "batch": np.asarray(8)},
                        tmp_path)
    ref = json.loads(str(out["res"]))
    cfg = dataclasses.replace(get_smoke_config("stablelm_3b"),
                              force_strategy=ref["strategy"])
    plan, cfg, counts, _ = D.count_cell(cfg, SMOKE["train"], mesh22)
    assert cfg.microbatch == ref["microbatch"]
    ratio = counts["flops_corrected"] / ref["flops"]
    assert abs(ratio - 1.0) <= 0.05, (counts["flops_corrected"],
                                      ref["flops"])


def test_full_size_stablelm_train_cell_on_the_production_mesh():
    """stablelm_3b × train_4k on the (32, 8) fake mesh: ok, with nonzero
    per-chip FLOPs, memory and collective bytes."""
    try:
        res = D.run_cell("stablelm_3b", "train_4k", verbose=False)
    finally:
        mesh_mod.release()
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["mesh_shape"] == {"data": 32, "model": 8}
    counts = res["op_counts"]
    assert counts["flops_corrected"] > 0
    assert counts["memory_bytes_corrected"] > 0
    assert counts["collective_bytes_corrected"] > 0


# stablelm_3b × decode_32k on the (32, 8) mesh under the planner's plan
# (fsdp_tp, the reference's too), per chip, as the reference's dry run
# counts it on that mesh: ``PYTHONPATH=src:tests python
# tests/torch_dryrun_parity.py --arch stablelm_3b --shape decode_32k
# --mesh 32,8 --strategy fsdp_tp`` (PERF.md, section 6)
REFERENCE_STABLELM_DECODE = {"flops": 8.037e9, "collective_bytes": 4.863e8}


def test_full_size_stablelm_decode_within_bound_of_the_reference():
    """Per-chip FLOPs at most 1.25x and collective bytes at most 3x the
    reference's on the same mesh and plan: the batch stays sharded over
    ``data`` through attention and the caches (each chip attends its 4
    rows, not all 128)."""
    try:
        res = D.run_cell("stablelm_3b", "decode_32k", verbose=False)
    finally:
        mesh_mod.release()
    assert res["status"] == "ok" and res["strategy"] == "fsdp_tp"
    counts = res["op_counts"]
    assert counts["flops_corrected"] \
        <= 1.25 * REFERENCE_STABLELM_DECODE["flops"]
    assert counts["collective_bytes_corrected"] \
        <= 3.0 * REFERENCE_STABLELM_DECODE["collective_bytes"]


# the MoE prefill cells on the (32, 8) mesh under the reference's plan
# (fsdp_tp), per chip, as the reference's dry run counts them there
# (``tests/torch_dryrun_parity.py --arch ARCH --shape prefill_32k --mesh
# 32,8``; PERF.md, section 6)
REFERENCE_MOE_PREFILL = {
    "olmoe_1b_7b": {"flops": 5.734e14, "collective_bytes": 1.390e11},
    "qwen2_moe_a2_7b": {"flops": 8.631e14, "collective_bytes": 2.253e11}}


@pytest.mark.parametrize("arch", list(REFERENCE_MOE_PREFILL))
def test_full_size_moe_prefill_within_bound_of_the_reference(arch):
    """Per-chip FLOPs at most 1.25x and collective bytes at most 3x the
    reference's: each rank routes its own tokens, the rows go only over
    the batch's axes, and no chip gathers the experts' whole output
    (olmoe: 42.9 GB a layer, 6.15x the reference's bytes)."""
    try:
        res = D.run_cell(arch, "prefill_32k", verbose=False)
    finally:
        mesh_mod.release()
    ref = REFERENCE_MOE_PREFILL[arch]
    assert res["status"] == "ok" and res["strategy"] == "fsdp_tp"
    counts = res["op_counts"]
    assert counts["flops_corrected"] <= 1.25 * ref["flops"]
    assert counts["collective_bytes_corrected"] \
        <= 3.0 * ref["collective_bytes"]


# Jamba's train cell on the (32, 8) mesh under the reference's plan
# (fsdp: its 16 experts split over no mesh axis), per chip, as the
# reference's dry run counts it there (``tests/torch_dryrun_parity.py
# --arch jamba_1_5_large_398b --shape train_4k --mesh 32,8 --strategy
# fsdp``; PERF.md, section 6), and its largest expert product: each dot
# on 1/256 of one weight dimension
REFERENCE_JAMBA_TRAIN = {"flops": 8.450e15, "collective_bytes": 6.241e13,
                         "expert_dot_flops": 4.123e12}


def test_full_size_jamba_train_within_bound_of_the_reference():
    """Per-chip FLOPs at most 1.25x and collective bytes at most 3x the
    reference's, and no single ``bmm`` over 2x the reference's expert
    dot: each chip multiplies the whole buffer by its own shard of the
    expert weights (every chip ran the whole down product, 1.055e15
    FLOPs a call: 13.84x the reference's FLOPs)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("jamba_1_5_large_398b"),
                              force_strategy="fsdp")
    try:
        res = D.run_cell("jamba_1_5_large_398b", "train_4k",
                         cfg_override=cfg, verbose=False)
    finally:
        mesh_mod.release()
    ref = REFERENCE_JAMBA_TRAIN
    assert res["status"] == "ok" and res["strategy"] == "fsdp"
    counts = res["op_counts"]
    assert counts["flops_corrected"] <= 1.25 * ref["flops"]
    assert counts["collective_bytes_corrected"] \
        <= 3.0 * ref["collective_bytes"]
    assert counts["max_op_flops"]["bmm"] <= 2 * ref["expert_dot_flops"]


def test_full_size_jamba_decode_on_the_multi_pod_mesh():
    """jamba_1_5_large_398b × decode_32k on the (2, 32, 8) fake mesh
    runs ``ok`` (it failed in DTensor's redistribute of a partial sum
    over ``pod`` and ``model``)."""
    try:
        res = D.run_cell("jamba_1_5_large_398b", "decode_32k",
                         multi_pod=True, verbose=False)
    finally:
        mesh_mod.release()
    assert res["status"] == "ok", res.get("error")
    assert res["chips"] == 512
    counts = res["op_counts"]
    assert counts["flops_corrected"] > 0
    assert counts["collective_bytes_corrected"] > 0


def test_a_cell_error_is_recorded_with_its_traceback(tmp_path, monkeypatch):
    """A propagation error is the cell's ``status: "error"`` (with its
    traceback), never a skipped op."""
    from torch.distributed.tensor import Shard, distribute_tensor

    def broken(cfg, shape, mesh, **kwargs):
        t = distribute_tensor(torch.empty(8, 8, device="meta"), mesh,
                              [Shard(0), Shard(1)])
        return t.view(64, 1) @ t            # no sharding for this product

    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    monkeypatch.setattr(D, "count_cell", broken)
    D.main(["--arch", "stablelm_3b", "--shape", "train_4k"])
    assert not dist.is_initialized()
    res = json.loads((tmp_path / "results.json").read_text())
    cell = res["stablelm_3b|train_4k|single"]
    assert cell["status"] == "error"
    assert "Traceback" in cell["traceback"]


def test_sweep_runs_cells_in_processes(tmp_path, monkeypatch):
    """``--all --jobs N``: each cell in a process of its own, its result
    saved by the sweep; an excluded cell is left out."""
    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    D.sweep(["xlstm_125m"], ["decode_32k", "long_500k", "train_4k"],
            [False], jobs=2, exclude={"xlstm_125m|train_4k"})
    assert not dist.is_initialized()
    res = json.loads((tmp_path / "results.json").read_text())
    assert sorted(res) == ["xlstm_125m|decode_32k|single",
                           "xlstm_125m|long_500k|single"]
    assert all(r["status"] == "ok" for r in res.values())


# ---------------------------------------------------------------------------
# The kernels' ops on DTensors, four gloo ranks (f32, 1e-5 absolute)
# ---------------------------------------------------------------------------

SHARDED_CASES = ["flash/gqa_heads_sharded", "flash/mqa_kv_whole",
                 "flash/gqa_kv_indivisible", "flash/seq_sharded_gathered",
                 "flash/decode_offsets", "flash/cross_not_causal",
                 "scan/batch_channels", "scan/batch_channels_state",
                 "scan/length_gathered"]


@pytest.fixture(scope="module")
def sharded_ops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_ops.py"),
         str(rank), "4", str(tmp / "store"), str(tmp / "out.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_kernel_op_on_dtensors_equals_the_plain_op(sharded_ops, case):
    """Output and every input's gradient of the op on DTensors (a (2, 2)
    mesh: batch over ``data``, heads or channels over ``model``; K/V
    whole where their heads do not split; the sequence gathered where it
    was sharded) against the op on the whole tensors."""
    assert sharded_ops[case] <= 1e-5


def test_sharded_calls_go_through_local_map(sharded_ops):
    assert sharded_ops["local_calls"] == {"flash": 6, "scan": 3}


# ---------------------------------------------------------------------------
# Meshes and the training launcher's planner call
# ---------------------------------------------------------------------------

def test_production_meshes():
    try:
        mesh = mesh_mod.make_production_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (32, 8)
        with pytest.raises(mesh_mod.GroupInUse):
            mesh_mod.make_production_mesh(multi_pod=True)
        with pytest.raises(mesh_mod.GroupInUse):
            mesh_mod.make_host_mesh(device="cpu")
        mesh_mod.release()
        mesh = mesh_mod.make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 32, 8)
    finally:
        mesh_mod.release()
    assert not dist.is_initialized()


def test_a_missing_fake_backend_raises(monkeypatch):
    import torch._C._distributed_c10d as c10d

    monkeypatch.setattr(dist.Backend, "_plugins", {})
    monkeypatch.delattr(c10d, "FakeProcessGroup")
    with pytest.raises(mesh_mod.FakeBackendUnavailable):
        mesh_mod.make_production_mesh()
    assert not dist.is_initialized()


def test_train_launcher_plans_on_the_host_mesh():
    from repro_torch.launch import train as launch_train

    out = launch_train.main(["--arch", "stablelm_3b", "--smoke", "--steps",
                             "2", "--batch", "2", "--seq", "16",
                             "--log-every", "1", "--device", "cpu"])
    plan = out["plan"]
    assert not dist.is_initialized()           # released after planning
    assert plan.mesh.device_type == "cpu" and plan.mesh.size() == 1
    assert plan.estimate.legal
    from torch.distributed.tensor import Replicate

    flat = _flat_shardings(plan.param_shardings)
    assert flat and all(p == Replicate() for sh in flat
                        for p in sh.placements)
    assert np.isfinite(out["losses"]).all()


def _flat_shardings(tree):
    if isinstance(tree, PL.MeshSharding):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [s for v in vals for s in _flat_shardings(v)]
