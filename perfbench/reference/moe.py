"""Plain float32 reference of a mixture-of-experts decoder:
:mod:`.layers` with, after each attention, token-choice routing (the
router's logits in float32, each token's ``experts_topk`` largest, their
softmax as weights) and every routed expert's gated MLP on its tokens,
weighted and summed. No token is dropped: the configurations run the
program at a capacity that holds every assignment. The router stays in
float32 in every precision, as the configurations state it."""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import layers
from perfbench.reference.dense import ACTS


def ffn(p, l: int, x, m: Dict, precision: str):
    b, s, d = x.shape
    h = layers.rmsnorm(x, p["moe/ln"][l], m["norm_eps"]).reshape(b * s, d)
    top, idx = torch.topk(h @ p["moe/router"][l], m["experts_topk"], -1)
    weight = torch.softmax(top, -1)
    act = ACTS[m.get("mlp_act", "silu")]
    y = torch.zeros_like(h)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        he = h[tok]
        up = layers.matmul(he, p["moe/wi"][l, e], precision)
        up = act(layers.matmul(he, p["moe/wg"][l, e], precision)) * up
        out = layers.matmul(up, p["moe/wo"][l, e], precision)
        y.index_add_(0, tok, out * weight[tok, slot][:, None])
    return x + y.reshape(b, s, d)


def logits_at(weights, m, tokens, positions, precisions=("float32",)):
    return layers.logits_at(weights, m, ffn, tokens, positions, precisions)


def train(weights, m, batches, opt, microbatch, precision="float32"):
    return layers.train(weights, m, ffn, batches, opt, microbatch,
                        precision)
