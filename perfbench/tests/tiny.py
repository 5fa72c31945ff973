"""A benchmark at a size a CPU test can hold: a copy of the benchmark's
folder beside a ``BENCHMARK.json`` of tiny cells, for ``run.main`` with
``device="cpu"`` (which skips the look for a card)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

MODELS = {
    "tiny_dense": {
        "family": "dense", "layers": 2, "d_model": 64, "n_heads": 4,
        "kv_heads": 4, "d_ff": 96, "vocab": 500, "padded_vocab": 2048,
        "mlp_act": "silu", "tie_embeddings": False, "rope_theta": 10000.0,
        "norm_eps": 1e-06, "microbatch": 2, "remat": "full",
        "fused_xent": True, "dtype": "bfloat16"},
    "tiny_moe": {
        "family": "moe", "layers": 2, "d_model": 64, "n_heads": 4,
        "kv_heads": 4, "d_ff": 32, "vocab": 500, "padded_vocab": 2048,
        "n_experts": 16, "experts_topk": 4, "expert_d_ff": 32,
        "moe_every": 1, "moe_offset": 0, "capacity_factor": 5.0,
        "mlp_act": "silu", "tie_embeddings": False, "rope_theta": 10000.0,
        "norm_eps": 1e-06, "microbatch": 2, "remat": "full",
        "fused_xent": True, "dtype": "bfloat16"},
}

TRAFFIC = {
    "tiny_train": {"kind": "train", "seq_len": 32, "batch": 2,
                   "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95,
                                 "eps": 1e-8, "weight_decay": 0.1,
                                 "grad_clip": 1.0},
                   "checked_steps": 3, "trace_steps": 1},
    "tiny_serve": {"kind": "serve", "loop": "closed", "clients": 4,
                   "n_slots": 4, "max_seq": 96, "prompt_dist": "log_uniform",
                   "prompt_tokens": [16, 48], "answer_dist": "log_uniform",
                   "answer_tokens": [8, 16], "block": 4, "prewarm_ticks": 2,
                   "trace_seconds": 0.2, "check_requests": 40},
}

# set as the cells' limits are, from readings at these sizes (init 0.1,
# five seeds; served: ten seeds, every finished request checked): sound
# loss_gap <= 2.9e-4, grad_gap <= 0.0057, change_gap <= 0.165; the fp8
# control's change_gap >= 0.687, half the batch's loss_gap >= 0.0074;
# dense served widest_gap <= 0.0215, the control's >= 0.058 where 9 or
# more requests finish; MoE served mean_gap <= 0.00041, the control's
# >= 0.00213 (its widest_gap, sound <= 0.058 and control >= 0.077, is
# not compared, as in the MoE cell)
LIMITS = {"train": {"loss_gap": 0.002, "grad_gap": 0.03, "change_gap": 0.35},
          "serve": {"widest_gap": 0.035, "wrong_lengths": 0},
          "tiny_moe.tiny_serve": {"mean_gap": 0.0012, "wrong_lengths": 0}}


def tiny_root(dest: Path) -> Path:
    """A root at ``dest`` holding ``BENCHMARK.json`` with the cells
    ``<model>.<mix>`` of every tiny model and mix, and ``perfbench/``
    (a copy, with their files added)."""
    dest = Path(dest)
    bench = dest / "perfbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    configs, workloads = [], []
    for name, model in MODELS.items():
        path = bench / "configs" / f"{name}.json"
        path.write_text(json.dumps({"name": name, "family": model["family"],
                                    "model": model, "init_std": 0.1,
                                    "reduced": []}))
        configs.append({"name": name, "source": "tiny", "reduced": [],
                        "file": f"perfbench/configs/{name}.json",
                        "why": "CPU test"})
        for mix, t in TRAFFIC.items():
            (bench / "traffic" / f"{mix}.json").write_text(json.dumps(t))
            cell = f"{name}.{mix}"
            (bench / "limits" / f"{cell}.json").write_text(
                json.dumps({"limits": LIMITS.get(cell, LIMITS[t["kind"]])}))
            workloads.append({"name": cell, "config": name, "traffic": mix,
                              "chips": 1, "why": "CPU test"})
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec.update(configs=configs, workloads=workloads)
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            kind = "train" if "train" in m["name"] else "serve"
            if "workloads" in m:
                m["workloads"] = [w["name"] for w in workloads
                                  if w["name"].endswith(kind)]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest
