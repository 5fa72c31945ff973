"""Model FLOPs of a mixture-of-experts decoder: :mod:`dense`'s counts
with each layer's FFN the router (d_model · experts) and the
``experts_topk`` experts a token is routed to (the experts that a
token does not reach, and a capacity's padding, are no model FLOPs)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

from perfbench.harness.bench import load_file

dense = load_file(Path(__file__).with_name("dense.py"), "perfbench_counts_dense")


def layer_params(m: Dict) -> int:
    gated = m.get("mlp_act", "silu") in ("silu", "gelu")
    expert = (3 if gated else 2) * m["d_model"] * m["expert_d_ff"]
    return (dense.attn_params(m) + m["d_model"] * m["n_experts"]
            + m["experts_topk"] * expert)


def train_step_flops(m: Dict, batch: int, seq: int) -> float:
    return dense.train_step_flops(m, batch, seq, layer_params)


def prefill_flops(m: Dict, s: int) -> float:
    return dense.prefill_flops(m, s, layer_params)


def decode_flops(m: Dict, context: int) -> float:
    return dense.decode_flops(m, context, layer_params)
