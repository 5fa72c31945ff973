"""Multi-pod dry run of the port: one sharded step of every (arch × shape ×
mesh) cell, on the host.

For each cell:
  * auto-shard with the planner (legality → profitability,
    ``core/planner.py``) on the production ``DeviceMesh``
    (``launch/mesh.py``: 256 or 512 ranks of a ``fake`` process group,
    this process rank 0),
  * build the step (train step / prefill / decode step) and its
    arguments: parameters, optimizer state, batch and caches at full size
    as meta tensors (shapes only, no memory; the parameters drawn under
    ``FakeTensorMode``, :func:`meta_params`), placed as DTensors by the
    plan,
  * run the step once under ``implicit_replication()`` and
    ``launch/op_analysis.py``: DTensor's sharding propagation decides
    every op's local shards and collectives, as XLA's partitioner did
    in the reference's lower/compile, so a propagation failure surfaces
    as a real error (``status: "error"`` with its traceback), and the
    count is per chip, from the local shards,
  * record the planner's estimate, the per-chip counts and the
    roofline terms on :data:`~repro_torch.core.cost.H100_SXM` (datasheet
    figures) into ``artifacts/dryrun_torch/results.json``.

The dry run is host-only by nature: no card runs it, and its "seconds"
are the host's (``trace_s``: planning, building and the traced step, in
place of the reference's ``lower_s``/``compile_s``). The cell builders
also take real tensors: ``chip_smoke.py`` phase 12 runs the train cell
on the card's 1×1 mesh with real weights.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm_3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] \
      [--jobs 4] [--exclude 'xlstm_125m|prefill_32k']
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.registry import ShapeSpec, cell_is_skipped
from repro_torch.core import planner as planner_mod
from repro_torch.core.cost import H100_SXM, roofline
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
from repro_torch.train.train_loop import grad_norm, loss_and_grads
from repro_torch.train.tree import tree_map

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


# ---------------------------------------------------------------------------
# Inputs and parameters
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                device="cpu") -> Dict[str, torch.Tensor]:
    """One cell's input batch (zeros of the reference's shapes and
    dtypes; fake under ``FakeTensorMode``)."""
    B, S = shape.global_batch, shape.seq_len

    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.embeds_input:
            batch["embeds"] = zeros((B, S, cfg.d_model), torch.float32)
        else:
            batch["tokens"] = zeros((B, S), torch.int32)
        if shape.kind == "train":
            batch["labels"] = zeros((B, S), torch.int32)
        if cfg.is_encdec:
            batch["src_embeds"] = zeros((B, S, cfg.d_model), torch.float32)
        return batch
    # decode: one new token against a full cache
    return {"tokens": zeros((B, 1), torch.int32)}


def meta_params(cfg: ArchConfig):
    """(params, specs): the model's parameters at full size as meta
    tensors (shapes and dtypes, no memory) and their logical axes, drawn
    as fake tensors (``FakeTensorMode``) and moved to the meta device:
    the step runs with no ambient fake mode, under which DTensor's
    strided shards (a flatten of two dims sharded over two mesh dims)
    cannot compute their offsets (``arange(...).tolist()``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params, specs = T.init_params(cfg, torch.Generator().manual_seed(0))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params), specs


def place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor by its
    :class:`~repro_torch.core.planner.MeshSharding` in ``shardings`` (a
    tree of the same structure, or one sharding for every leaf)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        return distribute_tensor(t, sh.mesh, sh.placements)

    if isinstance(shardings, planner_mod.MeshSharding):
        return tree_map(lambda t: one(t, shardings), tree)
    return tree_map(one, tree, shardings)


def _place_params(params, specs, plan):
    """The parameters as DTensors by the plan; a tensor at several
    places of the tree (tied: ``init_params(share_experts=True)``) is
    placed once, so that it stays one leaf (``train/tree.py``)."""
    placed = {}

    def one(_, t, sh):
        key = (id(t), tuple(sh.placements))
        if key not in placed:
            placed[key] = place(t, sh)
        return placed[key]

    return planner_mod.map_specs(one, specs, params, plan.param_shardings)


def _place_batch(batch, mesh, plan, shape: ShapeSpec):
    return {k: place(v, planner_mod.batch_sharding(
        mesh, plan.strategy, shape.global_batch, extra_dims=v.dim() - 1))
        for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Cell builders: (step function, its arguments)
# ---------------------------------------------------------------------------

def build_train_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, plan, params,
                     specs, batch=None):
    """The train step and (params, opt_state, batch) as DTensors: the
    moments take their parameter's sharding (``init_opt_state`` makes
    them like the parameters), the step counter and moment scales are
    replicated."""
    opt_cfg = AdamWConfig(quantize_moments=cfg.opt_8bit)
    step = make_train_step(cfg, opt_cfg)
    p = _place_params(params, specs, plan)
    opt = init_opt_state(p, opt_cfg)
    if batch is None:
        batch = input_specs(cfg, shape)
    return step, (p, opt, _place_batch(batch, mesh, plan, shape))


def build_grad_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, plan, params,
                    specs, batch=None):
    """The train cell's loss and gradient, without the optimizer's step
    (``count_cell(..., grad_only=True)``): the step takes (params,
    batch) as DTensors and returns the mean loss, the gradient tree
    (each leaf on its parameter's placements) and its norm."""
    def grad_step(params, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        return loss, grads, grad_norm(grads)

    if batch is None:
        batch = input_specs(cfg, shape)
    return grad_step, (_place_params(params, specs, plan),
                       _place_batch(batch, mesh, plan, shape))


def build_prefill_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, plan,
                       params, specs, batch=None):
    def prefill_fn(params, batch):
        return T.prefill(params, batch, cfg, max_seq=shape.seq_len)

    if batch is None:
        batch = input_specs(cfg, shape)
    return prefill_fn, (_place_params(params, specs, plan),
                        _place_batch(batch, mesh, plan, shape))


def build_decode_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, plan,
                      params, specs, batch=None):
    """The decode step and (params, tokens, caches) as DTensors, the
    caches placed by ``cache_sharding``. ``batch`` holds the ``tokens``
    and, where given, the ``caches`` to decode against (a prefill's,
    with one position per layer); else the caches are zeros of the
    shape's length."""
    B, S = shape.global_batch, shape.seq_len
    cross = S if cfg.is_encdec else 0

    def serve_step(params, tokens, caches):
        return T.decode_step(params, tokens, caches, cfg)

    batch = batch or input_specs(cfg, shape)
    tok = batch["tokens"]
    caches = batch.get("caches")
    if caches is None:
        caches = T.init_caches(cfg, B, S, cross_len=cross,
                               uniform_index=True, device=tok.device)
    caches = tree_map(lambda t: place(t, planner_mod.cache_sharding(
        mesh, plan.strategy, cfg, B, tuple(t.shape))), caches)
    tok = place(tok, planner_mod.batch_sharding(mesh, plan.strategy, B,
                                                extra_dims=1))
    return serve_step, (_place_params(params, specs, plan), tok, caches)


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def wire_config(cfg: ArchConfig, shape: ShapeSpec, mesh, plan) -> ArchConfig:
    """The planner's microbatch, and the mesh axes the activations and
    the MoE dispatch are anchored to (``act_batch_axes``,
    ``moe_expert_axes``, ``moe_capacity_axes``), as the reference's
    dry run sets them."""
    rows = shape.global_batch
    if shape.kind == "train":
        rows = shape.global_batch // max(1, plan.estimate.microbatch)
    # anchor activations on the planner's effective DP axes
    ax: tuple = ()
    for i in range(len(plan.strategy.batch_axes), 0, -1):
        cand = plan.strategy.batch_axes[:i]
        if rows % planner_mod._mesh_size(mesh, cand) == 0:
            ax = cand
            break
    moe_ax = cap_ax = None
    if cfg.n_experts:
        from repro_torch.models.moe import padded_experts

        e_pad = padded_experts(cfg, 16)
        f = cfg.expert_d_ff or cfg.d_ff
        spec = planner_mod.resolve_leaf_spec(
            (e_pad, cfg.d_model, f), ("experts", "embed", "mlp"),
            plan.strategy, mesh)
        if spec[0] is not None:
            moe_ax = (spec[0],) if isinstance(spec[0], str) \
                else tuple(spec[0])
            # capacity dim covers the mesh axes experts cannot
            cap_ax = tuple(a for a in planner_mod.axis_names(mesh)
                           if a not in moe_ax) or None
    return dataclasses.replace(
        cfg, microbatch=plan.estimate.microbatch
        if shape.kind == "train" else cfg.microbatch,
        act_batch_axes=ax or None, moe_expert_axes=moe_ax,
        moe_capacity_axes=cap_ax)


BUILDERS = {"train": build_train_cell, "prefill": build_prefill_cell,
            "decode": build_decode_cell}


def count_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, params=None,
               specs=None, batch=None, verbose: bool = False,
               probe=None, grad_only: bool = False, wire=None):
    """(plan, wired config, counts, the step's output): plan the cell on
    ``mesh``, build it and run its step once under the op count. Without
    ``params`` the parameters and inputs are meta tensors at full size
    (:func:`meta_params`; the dry run); with real ``params`` (and
    ``specs``, and optionally ``batch``), a real step. ``probe(cfg,
    args, out)``, where given, is called after the step with the wired
    config, the step's arguments (its caches written in place) and its
    output. ``grad_only``: a train cell's loss and gradient, no
    optimizer step (:func:`build_grad_cell`). ``wire(cfg)``, where
    given, edits the wired config (a mesh of size-1 axes gives the
    experts an axis that (32, 8)'s plan does not)."""
    from torch.distributed.tensor.experimental import implicit_replication

    if params is None:
        params, specs = meta_params(cfg)
        batch = input_specs(cfg, shape, device="meta")
    plan = planner_mod.plan(cfg, specs, params, mesh, seq=shape.seq_len,
                            batch=shape.global_batch, kind=shape.kind)
    cfg = wire_config(cfg, shape, mesh, plan)
    if wire is not None:
        cfg = wire(cfg)
    if verbose:
        print(f"[{cfg.name} × {shape.name}] mb={cfg.microbatch} "
              f"{plan.describe()}", flush=True)
    build = build_grad_cell if grad_only else BUILDERS[shape.kind]
    fn, args = build(cfg, shape, mesh, plan, params, specs, batch)
    with implicit_replication(), op_analysis.OpCounter() as counter:
        out = fn(*args)
    if probe is not None:
        probe(cfg, args, out)
    return plan, cfg, counter.result(), out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             cfg_override: Optional[ArchConfig] = None, mesh=None,
             verbose: bool = True) -> Dict[str, Any]:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    skip = cell_is_skipped(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": skip}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = planner_mod.mesh_chips(mesh)
    t0 = time.perf_counter()
    plan, cfg, corrected, _ = count_cell(cfg, shape, mesh, verbose=verbose)
    t_trace = time.perf_counter() - t0

    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": planner_mod.axis_sizes(mesh),
        "chips": chips,
        "status": "ok",
        "strategy": plan.strategy.name,
        "microbatch": cfg.microbatch,
        "trace_s": round(t_trace, 2),
        "planner_estimate": {
            "hbm_gib_per_chip": plan.estimate.hbm_bytes_per_chip / 2**30,
            "compute_s": plan.estimate.compute_s,
            "memory_s": plan.estimate.memory_s,
            "collective_s": plan.estimate.collective_s,
            "legal": plan.estimate.legal,
        },
        "op_counts": corrected,
    }

    # roofline terms on one H100 (datasheet figures). The counts are
    # per chip (each rank's local shards), so the terms divide by 1 chip.
    n_active = cfg.active_param_count()
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active \
        * tokens
    flops = corrected["flops_corrected"]
    nbytes = corrected["memory_bytes_corrected"]
    coll_bytes = corrected["collective_bytes_corrected"]
    rt = roofline(flops, nbytes, coll_bytes, 1, H100_SXM)
    global_flops = flops * chips
    result["roofline"] = {
        "chip": H100_SXM.name,
        "compute_s": rt.compute_s,
        "memory_s": rt.memory_s,
        "collective_s": rt.collective_s,
        "dominant": rt.dominant,
        "model_flops": model_flops,
        "flops_global": global_flops,
        "useful_flops_ratio": (model_flops / global_flops
                               if global_flops else None),
    }
    if verbose:
        print(f"  ok: trace={t_trace:.1f}s flops={flops:.3e} "
              f"bytes={nbytes:.3e} coll={coll_bytes:.3e} "
              f"dominant={rt.dominant}", flush=True)
    return result


# ---------------------------------------------------------------------------
# Sweep + cache
# ---------------------------------------------------------------------------

def _results_path() -> str:
    os.makedirs(ART_DIR, exist_ok=True)
    return os.path.join(ART_DIR, "results.json")


def load_results() -> Dict[str, Any]:
    path = _results_path()
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(res: Dict[str, Any]) -> None:
    with open(_results_path(), "w") as f:
        json.dump(res, f, indent=1)


def cell_key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"


def error_result(arch: str, shape: str, multi_pod: bool,
                 exc: BaseException) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape,
            "mesh": "multi" if multi_pod else "single",
            "status": "error", "error": str(exc)[:2000],
            "traceback": traceback.format_exc()[-4000:]}


def _cell_in_process(arch: str, shape: str, multi_pod: bool):
    """One cell in a process of its own (``main --no-save``): its
    result, the last line the process prints."""
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--no-save"] \
        + (["--multi-pod"] if multi_pod else [])
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if multi_pod else "single",
                "status": "error", "error": proc.stderr[-2000:]}


def sweep(archs, shapes, meshes, force=False, jobs: int = 1,
          exclude=()) -> None:
    """Every (arch, shape) cell on each mesh, but those already ``ok`` or
    ``skipped`` (unless ``force``) and those in ``exclude``
    (``arch|shape``). With ``jobs`` > 1, that many cells at a time, each
    in a process of its own (one mesh a process group)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import release

    results = load_results()
    for multi_pod in meshes:
        release()                     # one mesh size a process group
        todo = []
        for arch in archs:
            for shape in shapes:
                key = cell_key(arch, shape, multi_pod)
                prev = results.get(key)
                if f"{arch}|{shape}" in exclude or (
                        prev and not force and prev.get("status") in (
                            "ok", "skipped")):
                    continue
                todo.append((arch, shape, key))

        def one(cell):
            arch, shape, key = cell
            if jobs > 1:
                return _cell_in_process(arch, shape, multi_pod)
            try:
                return run_cell(arch, shape, multi_pod=multi_pod)
            except Exception as exc:  # noqa: BLE001 - a cell's error
                print(f"[{key}] ERROR: {exc}", flush=True)
                return error_result(arch, shape, multi_pod, exc)

        with ThreadPoolExecutor(max(1, jobs)) as pool:
            for (_, _, key), res in zip(todo, pool.map(one, todo)):
                results[key] = res
                save_results(results)
                print(f"[{key}] {res['status']} {res.get('trace_s')}",
                      flush=True)
    release()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append",
                    default=[], metavar="KEY=VALUE",
                    help="config override for hillclimb iterations "
                         "(e.g. --set microbatch=8)")
    ap.add_argument("--tag", default=None,
                    help="store result under <cell>#<tag> (keeps the "
                         "baseline row)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells at a time, each in its own process")
    ap.add_argument("--exclude", action="append", default=[],
                    metavar="ARCH|SHAPE", help="--all: a cell to leave out")
    ap.add_argument("--no-save", action="store_true",
                    help="print the cell's whole result as the last line "
                         "and leave results.json as it is")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        sweep(ARCHS, list(SHAPES), meshes, force=args.force,
              jobs=args.jobs, exclude=set(args.exclude))
        return
    assert args.arch and args.shape, "--arch and --shape (or --all)"
    cfg_override = None
    if args.overrides:
        cfg_override = get_config(args.arch)
        kv = {}
        for ov in args.overrides:
            k, v = ov.split("=", 1)
            cur = getattr(cfg_override, k)
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            kv[k] = v
        cfg_override = dataclasses.replace(cfg_override, **kv)
    from repro_torch.launch.mesh import release

    try:
        res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       cfg_override=cfg_override)
    except Exception as exc:  # noqa: BLE001 - recorded as the cell's error
        res = error_result(args.arch, args.shape, args.multi_pod, exc)
        print(f"ERROR: {exc}", flush=True)
    finally:
        release()
    if args.overrides:
        res["overrides"] = args.overrides
    if args.no_save:
        print(json.dumps(res))
        return
    key = cell_key(args.arch, args.shape, args.multi_pod)
    if args.tag:
        key = f"{key}#{args.tag}"
    results = load_results()
    results[key] = res
    save_results(results)
    print(json.dumps({k: res.get(k) for k in
                      ("status", "strategy", "microbatch", "trace_s",
                       "roofline")}, indent=1))


if __name__ == "__main__":
    main()
