"""One rank of the sharded-step check (``test_torch_sharded_step.py``
starts four, then six): a whole decode step and a whole train step of
smoke configs in float32, built by the dry run's cell builders on a
(2, 2) ``gloo`` mesh (``launch/dryrun.py::count_cell`` with real
tensors: parameters, batch and caches placed as DTensors by the plan),
against the same step on plain tensors. The decode step runs against
the caches of a plain prefill. Rank 0 writes, per case, the largest
relative error of the logits (decode) or of the loss and the gradient
norm (train), whether every flash input and every cache leaf after the
step kept its batch shards, the wired ``moe_expert_axes`` and, for the
MoE layers, the assignments each routing of the plain step dropped and
whether the sharded step's routings dropped the same ones.

On six ranks, a (3, 2) mesh: Jamba's train step under FSDP with no mesh
axis for its experts (16 padded experts split over neither 6 ranks nor
`data`'s 3; on (2, 2) they split over all four), at widths that split
over six (d_model and the experts' F 96), loss and gradient only: the
loss and each MoE leaf's gradient (``wi``, ``wg``, ``wo``, ``router``)
against the plain step's, and the step's all-to-alls. Twice: 12 rows of
32 tokens (each expert's capacity 60 rows, over D/6 = 16: ``wi`` and
``wg`` move to F) and, ``.../few``, 6 rows of 8 (capacity 7: their
partial sums move).

    PYTHONPATH=src python tests/torch_sharded_step.py RANK WORLD STORE OUT
"""

import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("stablelm_3b", "jamba_1_5_large_398b", "olmoe_1b_7b")
STRATEGIES = ("fsdp_tp", "fsdp")
KINDS = ("decode", "train")
SEQ, BATCH = 32, 8


# world size → the mesh's shape; the six-rank mesh's case, its widths
MESHES = {4: (2, 2), 6: (3, 2)}
NO_EXPERT_AXIS = "jamba_1_5_large_398b/train/fsdp"
FEW_ROWS = NO_EXPERT_AXIS + "/few"
WIDE = {"d_model": 96, "expert_d_ff": 96}
# (seq, batch) of the six-rank cases
WIDE_SHAPES = {NO_EXPERT_AXIS: (32, 12), FEW_ROWS: (8, 6)}
MOE_LEAVES = ("wi", "wg", "wo", "router")


def cases(world: int = 4):
    if world == 6:
        return list(WIDE_SHAPES)
    return [f"{a}/{k}/{s}" for a in ARCHS for k in KINDS for s in STRATEGIES]


def _rel(got, want) -> float:
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def _uniform(caches):
    """A prefill's caches with one position per layer (every row's
    prompt is as long), as the decode cell takes them."""
    for c in caches:
        if "kv" in c:
            c["kv"]["index"] = c["kv"]["index"][:, 0].contiguous()
    return caches


def _dropped(slots) -> list:
    """Each routing's dropped assignments (a mask in the global flat
    order) from its recorded (slot, E·cap)."""
    return [(s.full_tensor() if hasattr(s, "full_tensor") else s
             ).reshape(-1) == over for s, over in slots]


def _moe_grads(grads) -> dict:
    """{path: gradient} of the MoE leaves of a gradient tree (whole)."""
    from repro_torch.train.tree import leaves_with_paths

    return {"/".join(path): g.full_tensor() if hasattr(g, "full_tensor")
            else g for path, g in leaves_with_paths(grads)
            if "moe" in path and path[-1] in MOE_LEAVES}


def run_case(mesh, case: str, wide=None) -> dict:
    """One case (``arch/kind/strategy[/...]``); ``wide``: the six-rank
    cases' (seq, batch), at WIDE's widths, loss and gradient only."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core import planner as PL
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun as D
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.train_loop import loss_and_grads
    from repro_torch.train.tree import tree_map

    t0 = time.perf_counter()
    arch, kind, strategy = case.split("/")[:3]
    cfg = get_smoke_config(arch)
    # Jamba's smoke config cut to one period: attention, Mamba, MoE, MLP
    cfg = dataclasses.replace(cfg, layers=max(cfg.period, 2),
                              dtype=torch.float32, force_strategy=strategy)
    seq, batch_rows = wide or (SEQ, BATCH)
    if wide:
        cfg = dataclasses.replace(cfg, **WIDE)
    if arch == "olmoe_1b_7b":
        # an odd capacity (41): under FSDP×TP the buffer's capacity does
        # not split over `data`, so each `data` rank holds the whole of
        # its experts' buffer, through the backward too (Jamba's splits)
        cfg = dataclasses.replace(cfg, capacity_factor=1.3)
    shape = ShapeSpec(f"smoke_{kind}", seq, batch_rows, kind)
    params, specs = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch_rows, seq)).astype(np.int32))
    flash_ok = []

    def spy(q, k, v, **kw):
        # no flash input a partial sum over a mesh dim, its batch
        # sharded wherever the query's is
        flash_ok.append(all(not p.is_partial() for t in (q, k, v)
                            for p in t.placements))
        return sharded(q, k, v, **kw)

    plain_slots, sharded_slots = [], []

    def plain_route(p, ht, cfg):
        weights, slot, cap = route(p, ht, cfg)
        plain_slots.append((slot, p["router"].shape[1] * cap))
        return weights, slot, cap

    def sharded_route(layer, h, router):
        weights, slot = sharded_route_(layer, h, router)
        sharded_slots.append((slot, layer.e_pad * layer.cap))
        return weights, slot

    sharded = fa_ops._sharded
    route, sharded_route_ = moe.route, moe._Sharded.route
    fa_ops._sharded = spy
    moe.route, moe._Sharded.route = plain_route, sharded_route
    try:
        if kind == "decode":
            caches, _ = T.prefill(params, {"tokens": tokens[:, :-1]}, cfg,
                                  max_seq=seq)
            caches = _uniform(caches)
            step = tokens[:, -1:]
            plain_slots.clear()
            want, _ = T.decode_step(params, step, copy.deepcopy(caches), cfg)
            placed = []

            def probe(wired, args, out):
                strat = next(s for s in PL.make_strategies(mesh)
                             if s.name == strategy)
                tree_map(lambda t: placed.append(
                    tuple(t.placements) == PL.cache_sharding(
                        mesh, strat, wired, BATCH, tuple(t.shape)
                    ).placements), args[2])

            _, wired, _, (logits, _) = D.count_cell(
                cfg, shape, mesh, params=params, specs=specs,
                batch={"tokens": step, "caches": caches}, probe=probe)
            # the padded vocabulary's logits are -1e30 on both sides
            res = {"err": _rel(logits.full_tensor()[:, :cfg.vocab],
                               want[:, :cfg.vocab]),
                   "caches_kept": all(placed)}
        elif wide:
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            loss, grads = loss_and_grads(cfg, params, batch)
            want = _moe_grads(grads)
            shard_calls = moe.shard_calls
            _, wired, counts, (got_loss, got_grads, _) = D.count_cell(
                cfg, shape, mesh, params=params, specs=specs, batch=batch,
                grad_only=True)
            got = _moe_grads(got_grads)
            errs = {k: _rel(got[k], want[k]) for k in want}
            errs["loss"] = _rel(got_loss, loss)
            res = {"err": max(errs.values()), "errs": errs,
                   "shard_calls": moe.shard_calls - shard_calls,
                   "all_to_all": counts["collective_counts"]["all-to-all"],
                   "moe_layers": len(plain_slots)}
        else:
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            opt_cfg = AdamWConfig(quantize_moments=cfg.opt_8bit)
            plain = copy.deepcopy(params)
            *_, want = make_train_step(cfg, opt_cfg)(
                plain, init_opt_state(plain, opt_cfg), batch)
            _, wired, _, (_, _, got) = D.count_cell(
                cfg, shape, mesh, params=params, specs=specs, batch=batch)
            res = {"err": max(_rel(got[k], want[k])
                              for k in ("loss", "grad_norm")),
                   "loss": float(want["loss"]),
                   "grad_norm": float(want["grad_norm"])}
            assert isinstance(got["loss"], DTensor)
    finally:
        fa_ops._sharded = sharded
        moe.route, moe._Sharded.route = route, sharded_route_
    res["moe_expert_axes"] = wired.moe_expert_axes
    res["flash_ok"] = bool(flash_ok) and all(flash_ok)
    plain, got = _dropped(plain_slots), _dropped(sharded_slots)
    res["dropped"] = [int(m.sum()) for m in plain]
    res["same_drops"] = len(plain) == len(got) and all(
        torch.equal(a, b) for a, b in zip(plain, got))
    res["seconds"] = time.perf_counter() - t0
    return res


def main(rank: int, world: int, store_path: str, out_path: str) -> None:
    torch.set_num_threads(1)        # four ranks share the host's cores
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", MESHES[world],
                                mesh_dim_names=("data", "model"))
        res = {c: run_case(mesh, c, WIDE_SHAPES.get(c) if world == 6
                           else None) for c in cases(world)}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
