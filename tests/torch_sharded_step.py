"""One rank of the sharded-step check (``test_torch_sharded_step.py``
starts four): a whole decode step and a whole train step of smoke
configs in float32, built by the dry run's cell builders on a (2, 2)
``gloo`` mesh (``launch/dryrun.py::count_cell`` with real tensors:
parameters, batch and caches placed as DTensors by the plan), against
the same step on plain tensors. The decode step runs against the caches
of a plain prefill. Rank 0 writes, per case, the largest relative error
of the logits (decode) or of the loss and the gradient norm (train),
whether every flash input and every cache leaf after the step kept
its batch shards, and, for the MoE layers, the assignments each routing
of the plain step dropped and whether the sharded step's routings
dropped the same ones.

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


def cases():
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


def run_case(mesh, arch: str, kind: str, strategy: str) -> dict:
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
    from repro_torch.train.tree import tree_map

    t0 = time.perf_counter()
    cfg = get_smoke_config(arch)
    # Jamba's smoke config cut to one period: attention, Mamba, MoE, MLP
    cfg = dataclasses.replace(cfg, layers=max(cfg.period, 2),
                              dtype=torch.float32, force_strategy=strategy)
    if arch == "olmoe_1b_7b":
        # an odd capacity (41): under FSDP×TP the buffer's capacity does
        # not split over `data`, so each `data` rank holds the whole of
        # its experts' buffer, through the backward too (Jamba's splits)
        cfg = dataclasses.replace(cfg, capacity_factor=1.3)
    shape = ShapeSpec(f"smoke_{kind}", SEQ, BATCH, kind)
    params, specs = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32))
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
                                  max_seq=SEQ)
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

            _, _, _, (logits, _) = D.count_cell(
                cfg, shape, mesh, params=params, specs=specs,
                batch={"tokens": step, "caches": caches}, probe=probe)
            # the padded vocabulary's logits are -1e30 on both sides
            res = {"err": _rel(logits.full_tensor()[:, :cfg.vocab],
                               want[:, :cfg.vocab]),
                   "caches_kept": all(placed)}
        else:
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            opt_cfg = AdamWConfig(quantize_moments=cfg.opt_8bit)
            plain = copy.deepcopy(params)
            *_, want = make_train_step(cfg, opt_cfg)(
                plain, init_opt_state(plain, opt_cfg), batch)
            _, _, _, (_, _, got) = D.count_cell(
                cfg, shape, mesh, params=params, specs=specs, batch=batch)
            res = {"err": max(_rel(got[k], want[k])
                              for k in ("loss", "grad_norm")),
                   "loss": float(want["loss"]),
                   "grad_norm": float(want["grad_norm"])}
            assert isinstance(got["loss"], DTensor)
    finally:
        fa_ops._sharded = sharded
        moe.route, moe._Sharded.route = route, sharded_route_
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

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {c: run_case(mesh, *c.split("/")) for c in cases()}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
