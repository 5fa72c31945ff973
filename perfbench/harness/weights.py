"""A model's weights, drawn from the seed on the device.

The weights are the benchmark's input: the program and the reference
are handed the same tensors. :func:`layout` lists the leaves in the
port's tree (``{"embed", "final_ln", "unembed", "blocks": [{"attn",
"mlp" | "moe"}]}``, each block's leaves stacked over the layers) from a
configuration file's ``model`` sizes alone; :func:`make` draws every
leaf of one dtype in one call of ``normal_`` on a ``torch.Generator``
of the device, at the source's ``initializer_range``, and views the
leaves out of that buffer. Norm scales are zeros: the port's RMSNorm
multiplies by ``1 + scale``, so they start at 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, str]   # path, shape,
#                                                     dtype, "normal"|"zeros"

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run seeded ``seed``
    (any whole number)."""
    words = [int(seed) % (1 << 64)] + [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int.from_bytes(state.tobytes(), "little") >> 1


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def gated(m: Dict) -> bool:
    return m.get("mlp_act", "silu") in ("silu", "gelu")


def layout(m: Dict) -> List[Leaf]:
    """The leaves of a dense or MoE decoder with the sizes ``m`` (a
    configuration file's ``model``), in a fixed order."""
    dt = m.get("dtype", "bfloat16")
    L, D, H, KVH = m["layers"], m["d_model"], m["n_heads"], m["kv_heads"]
    hd, vp = head_dim(m), m["padded_vocab"]
    out: List[Leaf] = [(("embed",), (vp, D), dt, "normal"),
                       (("final_ln",), (D,), dt, "zeros")]
    if not m.get("tie_embeddings", True):
        out.append((("unembed",), (vp, D), dt, "normal"))
    blk = ("blocks", "0")
    out += [(blk + ("attn", "wq"), (L, D, H, hd), dt, "normal"),
            (blk + ("attn", "wk"), (L, D, KVH, hd), dt, "normal"),
            (blk + ("attn", "wv"), (L, D, KVH, hd), dt, "normal"),
            (blk + ("attn", "wo"), (L, H, hd, D), dt, "normal"),
            (blk + ("attn", "ln"), (L, D), dt, "zeros")]
    if m.get("n_experts", 0):
        E, F = m["n_experts"], m["expert_d_ff"]
        ffn = [(blk + ("moe", "router"), (L, D, E), "float32", "normal"),
               (blk + ("moe", "ln"), (L, D), dt, "zeros"),
               (blk + ("moe", "wi"), (L, E, D, F), dt, "normal"),
               (blk + ("moe", "wo"), (L, E, F, D), dt, "normal")]
        if gated(m):
            ffn.append((blk + ("moe", "wg"), (L, E, D, F), dt, "normal"))
    else:
        F = m["d_ff"]
        ffn = [(blk + ("mlp", "wi"), (L, D, F), dt, "normal"),
               (blk + ("mlp", "wo"), (L, F, D), dt, "normal"),
               (blk + ("mlp", "ln"), (L, D), dt, "zeros")]
        if gated(m):
            ffn.append((blk + ("mlp", "wg"), (L, D, F), dt, "normal"))
    return out + ffn


def make(config: Dict, seed: int, device) -> Dict[Tuple[str, ...],
                                                   torch.Tensor]:
    """{path: tensor} of every leaf, drawn from ``seed`` on ``device``:
    one ``normal_`` a dtype (its leaves are views of that buffer, in
    :func:`layout`'s order), ``config["init_std"]`` their deviation."""
    m, std = config["model"], config["init_std"]
    leaves = layout(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    out: Dict[Tuple[str, ...], torch.Tensor] = {}
    for dt in sorted({d for _, _, d, how in leaves if how == "normal"}):
        mine = [(p, s) for p, s, d, how in leaves
                if how == "normal" and d == dt]
        n = sum(int(np.prod(s)) for _, s in mine)
        flat = torch.empty(n, dtype=DTYPES[dt], device=device)
        flat.normal_(0.0, std, generator=gen)
        at = 0
        for p, s in mine:
            k = int(np.prod(s))
            out[p] = flat[at:at + k].view(s)
            at += k
    for p, s, dt, how in leaves:
        if how == "zeros":
            out[p] = torch.zeros(s, dtype=DTYPES[dt], device=device)
    return {p: out[p] for p, _, _, _ in leaves}


def as_tree(flat: Dict[Tuple[str, ...], torch.Tensor]) -> Dict:
    """The port's nested params from {path: tensor} (``blocks`` a list)."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][str(i)]
                          for i in range(len(tree["blocks"]))]
    return tree

