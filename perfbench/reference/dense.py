"""Plain float32 reference of a dense decoder: :mod:`.layers` with a
gated MLP (``act(h @ wg) * (h @ wi)`` then ``@ wo``) after each
attention."""

from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from perfbench.reference import layers

ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def ffn(p, l: int, x, m: Dict, precision: str):
    h = layers.rmsnorm(x, p["mlp/ln"][l], m["norm_eps"])
    up = layers.matmul(h, p["mlp/wi"][l], precision)
    up = ACTS[m.get("mlp_act", "silu")](
        layers.matmul(h, p["mlp/wg"][l], precision)) * up
    return x + layers.matmul(up, p["mlp/wo"][l], precision)


def logits_at(weights, m, tokens, positions, precisions=("float32",)):
    return layers.logits_at(weights, m, ffn, tokens, positions, precisions)


def train(weights, m, batches, opt, microbatch, precision="float32"):
    return layers.train(weights, m, ffn, batches, opt, microbatch,
                        precision)
