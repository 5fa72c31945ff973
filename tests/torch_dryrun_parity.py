"""Same-mesh parity of the dry run: the port's per-chip op count of a
cell against the reference's, on a mesh of one shape and under one
forced strategy.

Reference side, in one ``run_reference`` subprocess for every cell of a
mesh (JAX starts once): ``repro.launch.dryrun.run_cell`` (the planner,
the cell builder, lower + compile, ``hlo_analysis.analyze_compiled``)
with its production mesh swapped for ``jax.make_mesh(shape, axes)`` over
the 512 host devices its import sets up. Port side, in this process:
``repro_torch.launch.dryrun.count_cell`` on ``make_fake_mesh`` of the
same shape. Both sides report per-chip FLOPs, memory bytes, collective
bytes and counts per kind, and the strategy and microbatch they ran.

A cell is a dict: ``arch``, ``strategy`` (None: the planner's choice),
``smoke`` (the smoke config, else the full one) and ``shape``: a
registry shape's name, or ``[name, seq, batch, kind]``.

By hand, one cell (full size takes seconds on each side, most of it the
reference's compile)::

    PYTHONPATH=src:tests python tests/torch_dryrun_parity.py \\
        --arch stablelm_3b --shape decode_32k --mesh 32,8 \\
        --strategy fsdp_tp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import Dict, List

import numpy as np

from torch_reference import run_reference

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}

REFERENCE_CELLS = r"""
import dataclasses, json, re, time
jax.config.update("jax_enable_x64", False)
from repro.launch import dryrun as D        # sets 512 host devices
from repro.configs import get_config, get_smoke_config
from repro.configs.registry import ShapeSpec

from repro.launch import hlo_analysis as H


# FLOPs of every dot and convolution of the module, those inside fusion
# and call computations too, each computation times its enclosing while
# loops' trip counts. hlo_analysis walks only while bodies and
# conditional branches, so a dot that XLA fused (on the CPU, a product
# whose rows are one: a decode step's token on each chip) counts nothing
# there.
def all_dot_flops(text):
    comps, entry = H.parse_module(text)
    total = 0.0

    def walk(name, mult, depth=0):
        nonlocal total
        comp = comps.get(name)
        if comp is None or depth > 64:
            return
        for ins in comp.instrs:
            if ins.opcode in ("dot", "convolution"):
                total += mult * H._dot_flops(ins, comp)
            trip = H._trip_count(ins) if ins.opcode == "while" else 1
            for key in ("body", "condition", "calls", "to_apply"):
                called = H._called(ins, key)
                if called:
                    walk(called, mult * trip, depth + 1)
            if ins.opcode == "conditional":
                for nm in re.findall(r"%([\w.\-]+)", ins.attrs):
                    if nm in comps:
                        walk(nm, mult, depth + 1)

    walk(entry, 1.0)
    return total


texts = []
_analyze = H.analyze_compiled


def _keep_text(compiled):
    texts.append(compiled.as_text())
    return _analyze(compiled)


H.analyze_compiled = _keep_text
spec = json.loads(str(inputs["spec"]))
mesh_shape, axes = tuple(spec["mesh"]), tuple(spec["axes"])
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(mesh_shape,
                                                               axes)
res = []
for c in spec["cells"]:
    cfg = get_smoke_config(c["arch"]) if c["smoke"] else get_config(c["arch"])
    cfg = dataclasses.replace(cfg, force_strategy=c["strategy"])
    shape = c["shape"]
    if isinstance(shape, list):
        D.SHAPES[shape[0]] = ShapeSpec(shape[0], int(shape[1]),
                                       int(shape[2]), shape[3])
        shape = shape[0]
    t0 = time.perf_counter()
    r = D.run_cell(c["arch"], shape, cfg_override=cfg, verbose=False)
    h = r["hlo_corrected"]
    res.append({"strategy": r["strategy"], "microbatch": r["microbatch"],
                "flops": h["flops_corrected"],
                "flops_all_dots": all_dot_flops(texts.pop()),
                "memory_bytes": h["memory_bytes_corrected"],
                "collective_bytes": h["collective_bytes_corrected"],
                "per_kind": h["collective_per_kind"],
                "counts": h["collective_counts"],
                "seconds": time.perf_counter() - t0})
outputs["res"] = np.asarray(json.dumps(res))
"""


def _shape(shape):
    from repro_torch.configs import SHAPES
    from repro_torch.configs.registry import ShapeSpec

    if isinstance(shape, str):
        return SHAPES[shape]
    name, seq, batch, kind = shape
    return ShapeSpec(name, int(seq), int(batch), kind)


def _config(cell):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(cell["arch"]) if cell["smoke"] \
        else get_config(cell["arch"])
    return dataclasses.replace(cfg, force_strategy=cell["strategy"])


def reference_counts(cells: List[Dict], mesh_shape, tmp_dir,
                     timeout_s: float = 300.0) -> List[Dict]:
    """The reference's counts of ``cells`` on a mesh of ``mesh_shape``,
    one subprocess for all of them."""
    spec = {"mesh": list(mesh_shape), "axes": list(AXES[len(mesh_shape)]),
            "cells": cells}
    out = run_reference(REFERENCE_CELLS,
                        {"spec": np.asarray(json.dumps(spec))}, tmp_dir,
                        timeout_s=timeout_s)
    return json.loads(str(out["res"]))


def port_count(cell: Dict, mesh, probe=None) -> Dict:
    """The port's counts of ``cell`` on ``mesh`` (a fake ``DeviceMesh``
    of the reference's shape). ``probe(cfg, args, out)``, where given,
    sees the step's wired config, its DTensor arguments after the step
    (caches are written in place) and its output."""
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    plan, cfg, counts, _ = D.count_cell(_config(cell),
                                        _shape(cell["shape"]), mesh,
                                        probe=probe)
    return {"strategy": plan.strategy.name, "microbatch": cfg.microbatch,
            "batch_axes": list(plan.strategy.batch_axes),
            "flops": counts["flops_corrected"],
            "memory_bytes": counts["memory_bytes_corrected"],
            "collective_bytes": counts["collective_bytes_corrected"],
            "per_kind": counts["collective_per_kind"],
            "counts": counts["collective_counts"],
            "seconds": time.perf_counter() - t0}


def port_counts(cells: List[Dict], mesh_shape,
                placements: bool = False) -> List[Dict]:
    """The port's counts of ``cells`` on one fake mesh of ``mesh_shape``
    (the process's group, released after). With ``placements``, each
    cell's record also holds ``flash_partial_batch`` (how many flash op
    calls took an input that was a partial sum over one of the plan's
    batch axes) and, for a decode cell, ``caches_moved`` (the cache
    leaves whose placements after the step are not
    ``cache_sharding``'s)."""
    from repro_torch.core import planner as PL
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.tree import tree_map

    mesh = mesh_mod.make_fake_mesh(tuple(mesh_shape),
                                   AXES[len(mesh_shape)])
    sharded = fa_ops._sharded
    flash: List[tuple] = []

    def spy(q, k, v, **kwargs):
        flash.append(tuple(tuple(t.placements) for t in (q, k, v)))
        return sharded(q, k, v, **kwargs)

    def one(cell):
        flash.clear()
        moved: List[tuple] = []
        shape = _shape(cell["shape"])

        def probe(cfg, args, out):
            strategy = next(st for st in PL.make_strategies(mesh)
                            if st.name == cfg.force_strategy) \
                if cfg.force_strategy else None
            if shape.kind != "decode" or strategy is None:
                return

            def check(t):
                want = PL.cache_sharding(mesh, strategy, cfg,
                                         shape.global_batch,
                                         tuple(t.shape)).placements
                if tuple(t.placements) != tuple(want):
                    moved.append((tuple(t.shape), str(t.placements)))
                return t

            tree_map(check, args[2])

        rec = port_count(cell, mesh, probe=probe if placements else None)
        if placements:
            batch = {m for m, n in enumerate(mesh.mesh_dim_names)
                     if n in rec["batch_axes"]}
            rec["flash_calls"] = len(flash)
            rec["flash_partial_batch"] = sum(
                any(ps[m].is_partial() for ps in call for m in batch)
                for call in flash)
            rec["caches_moved"] = moved
        return rec

    if placements:
        fa_ops._sharded = spy
    try:
        return [one(c) for c in cells]
    finally:
        fa_ops._sharded = sharded
        mesh_mod.release()


# The smoke cells of the parity tests: three families × train and decode
# × FSDP×TP and FSDP forced, seq 64, batch 8
SMOKE_ARCHS = ("stablelm_3b", "olmoe_1b_7b", "jamba_1_5_large_398b")


def smoke_cells() -> List[Dict]:
    return [{"arch": a, "strategy": st, "smoke": True,
             "shape": [f"smoke_{k}", 64, 8, k]}
            for a in SMOKE_ARCHS for k in ("train", "decode")
            for st in ("fsdp_tp", "fsdp")]


def both_counts(cells: List[Dict], mesh_shape, tmp_dir,
                timeout_s: float = 300.0):
    """(reference's, port's with placements) counts of ``cells``: the
    reference's subprocess runs while this process counts the port's."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference_counts, cells, mesh_shape, tmp_dir,
                          timeout_s)
        port = port_counts(cells, mesh_shape, placements=True)
        return ref.result(), port


def ratios(ref: Dict, port: Dict) -> Dict[str, float]:
    """Port over reference, per count (inf where the reference's is 0
    and the port's is not)."""
    def r(a, b):
        return a / b if b else (0.0 if not a else float("inf"))

    return {k: r(port[k], ref[k])
            for k in ("flops", "memory_bytes", "collective_bytes")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    help="a registry shape, or name,seq,batch,kind")
    ap.add_argument("--mesh", default="32,8")
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    shape = args.shape.split(",")
    cell = {"arch": args.arch, "strategy": args.strategy,
            "smoke": args.smoke,
            "shape": shape[0] if len(shape) == 1 else shape}
    mesh_shape = tuple(int(s) for s in args.mesh.split(","))
    with tempfile.TemporaryDirectory() as tmp:
        ref = reference_counts([cell], mesh_shape, tmp, timeout_s=3600)[0]
    port = port_counts([cell], mesh_shape)[0]
    print(json.dumps({"cell": cell, "mesh": mesh_shape, "reference": ref,
                      "port": port, "port_over_reference":
                      ratios(ref, port)}, indent=1))


if __name__ == "__main__":
    main()
