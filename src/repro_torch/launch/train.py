"""Training launcher of the port:

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
        --smoke --steps 20 --batch 8 --seq 64 --ckpt-dir CKPT \
        [--device cpu]

The reference's ``repro/launch/train.py`` on the port: config → planner
(auto-sharding on the host mesh: ``launch/mesh.py``'s
``make_host_mesh``, a 1-rank ``nccl`` group on the card or ``gloo`` on
the CPU, released when the run ends; the parameters' shapes and logical
axes from ``init_params`` on fake tensors) → data pipeline
(``data/pipeline.py``, host-sharded, prefetch) → train step (grad
accumulation, remat, optional int8 grad compression, AdamW with optional
8-bit moments, written in place) → async checkpointing with
resume-on-restart. It trains on the card unless ``--device cpu`` is
given. As in the reference, the plan is printed and returned (``main``'s
``"plan"``) but not applied to the step; ``launch/dryrun.py`` applies
plans to sharded steps.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import planner as planner_mod
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T
from repro_torch.serve.engine import serving_device
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress", default=None, choices=[None, "int8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    cfg.microbatch = min(cfg.microbatch, max(1, args.batch // 2)) or 1
    # checked before a weight is drawn: no card raises DeviceUnavailable
    device = serving_device(args.device)

    # --- planner: auto-sharding on whatever mesh we actually have -------
    with FakeTensorMode():
        p_shapes, specs = T.init_params(cfg, torch.Generator().manual_seed(0))
    mesh = mesh_mod.make_host_mesh(device=device.type)
    try:
        plan = planner_mod.plan(cfg, specs, p_shapes, mesh, seq=args.seq,
                                batch=args.batch, kind="train")
    finally:
        mesh_mod.release()
    print(f"[train] {cfg.name}: {plan.describe()}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, quantize_moments=cfg.opt_8bit)
    step_fn = make_train_step(cfg, opt_cfg, compress=args.compress)

    # --- init or resume ---------------------------------------------------
    start_step = 0
    params, _ = T.init_params(cfg,
                              torch.Generator(device=device).manual_seed(0))
    opt = init_opt_state(params, opt_cfg)
    if args.ckpt_dir:
        last = C.latest_step(args.ckpt_dir)
        if last is not None:
            got, extra = C.restore(args.ckpt_dir, last,
                                   {"params": params, "opt": opt})
            params, opt = got["params"], got["opt"]
            start_step = int(extra.get("data_step", last))
            print(f"[train] resumed from step {last}", flush=True)
    print(f"[train] {cfg.name} on {device}", flush=True)

    data = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch,
                                    embeds_dim=cfg.d_model
                                    if cfg.embeds_input else 0,
                                    src_len=args.seq
                                    if cfg.is_encdec else 0,
                                    d_model=cfg.d_model),
                         start_step=start_step)
    ckpt = C.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    losses, step_s = [], []
    t0 = time.perf_counter()
    try:
        for i in range(start_step, start_step + args.steps):
            t_step = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.next().items()}
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))     # waits for the step
            step_s.append(time.perf_counter() - t_step)
            if (i + 1) % args.log_every == 0:
                tput = (i + 1 - start_step) * args.batch * args.seq \
                    / (time.perf_counter() - t0)
                print(f"[train] step {i + 1} loss {losses[-1]:.4f} "
                      f"({tput:.0f} tok/s)", flush=True)
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save_async(i + 1, {"params": params, "opt": opt},
                                extra={"data_step": i + 1})
    finally:
        data.stop()
        if ckpt:
            ckpt.wait()
    print(f"[train] done: loss {losses[0]:.4f} → {losses[-1]:.4f}")
    return {"losses": losses, "params": params, "plan": plan,
            "step_s": step_s}


if __name__ == "__main__":
    main()
