"""Model FLOPs of a dense decoder, from its sizes (a configuration
file's ``model``): the products a step needs, each multiply-add two
operations, with no recomputation counted (remat runs the forward
again; that is the program's cost, not the model's).

* a training step: 6 · N · T over the matmul parameters N (every layer's
  projections and MLP, and the output matrix over the real vocabulary;
  the embedding is a lookup) and the T tokens of the batch, plus causal
  attention's products (QKᵀ and PV: 4 · head_dim · heads a valid
  query-key pair forward, three times that with the backward);
* a prefill of S tokens: 2 · N_layers · S, the output matrix once (the
  program takes logits of the last position alone), and attention's
  forward products over its S(S+1)/2 pairs;
* a decode token at a context of c keys: 2 · N and attention over c
  keys.
"""

from __future__ import annotations

from typing import Dict

from perfbench.harness.weights import head_dim


def attn_params(m: Dict) -> int:
    d, hd = m["d_model"], head_dim(m)
    return 2 * d * m["n_heads"] * hd + 2 * d * m["kv_heads"] * hd


def ffn_params(m: Dict) -> int:
    """The matmul parameters a token goes through in one layer's FFN."""
    gated = m.get("mlp_act", "silu") in ("silu", "gelu")
    return (3 if gated else 2) * m["d_model"] * m["d_ff"]


def layer_params(m: Dict) -> int:
    return attn_params(m) + ffn_params(m)


def head_params(m: Dict) -> int:
    return m["vocab"] * m["d_model"]


def pairs(s: int) -> int:
    """Valid query-key pairs of causal attention over s tokens."""
    return s * (s + 1) // 2


def attn_pair_flops(m: Dict) -> int:
    """Forward operations a valid pair, over all heads of a layer."""
    return 4 * head_dim(m) * m["n_heads"]


def train_step_flops(m: Dict, batch: int, seq: int,
                     layer=layer_params) -> float:
    n = m["layers"] * layer(m) + head_params(m)
    attn = 3 * m["layers"] * attn_pair_flops(m) * pairs(seq) * batch
    return 6.0 * n * batch * seq + attn


def prefill_flops(m: Dict, s: int, layer=layer_params) -> float:
    return (2.0 * m["layers"] * layer(m) * s + 2.0 * head_params(m)
            + m["layers"] * attn_pair_flops(m) * pairs(s))


def decode_flops(m: Dict, context: int, layer=layer_params) -> float:
    return (2.0 * (m["layers"] * layer(m) + head_params(m))
            + m["layers"] * attn_pair_flops(m) * context)
