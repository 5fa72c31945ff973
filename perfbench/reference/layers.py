"""The decoder's plain layers, float32, shared by the family references.

They follow the port's equations, which each configuration file lists
where they depart from the source: a pre-norm decoder with RMSNorm
scaled by ``1 + scale``, the token embedding times sqrt(d_model),
rotary embedding over the whole head (the two halves rotated, base
``rope_theta``), causal softmax attention at 1/sqrt(head_dim), query
head ``h`` on key head ``h // (heads / kv_heads)``, a final RMSNorm and
an untied output matrix over the real vocabulary. A family module
brings the feed-forward part (:func:`decoder`'s ``ffn``).

Every product goes through :func:`matmul`, in float32 with TF32 off,
or, for the control that has to fail the check, with both operands
(and, under autograd, the incoming gradient) rounded to fp8 e4m3 at a
per-tensor scale; a trained control holds its parameters in fp8 too.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0


def highest_precision() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 at a per-tensor scale (its largest
    magnitude at e4m3's largest), back in float32."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return a @ b
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, positions, theta):
    """x: (B, S, H, D); positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, precision: str, q_block=None):
    """q: (B, S, H, D), k/v: (B, S, KVH, D) → (B, S, H, D); queries in
    blocks of ``q_block`` rows (all at once where None), each over the
    keys up to its last row."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if g > 1:
        k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    step = q_block or s
    outs = []
    for a in range(0, s, step):
        e = min(s, a + step)
        sc = matmul(q[:, :, a:e], k[:, :, :e].transpose(-1, -2),
                    precision) / math.sqrt(d)
        rows = torch.arange(a, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        outs.append(matmul(torch.softmax(sc, -1), v[:, :, :e], precision))
    return torch.cat(outs, 2).transpose(1, 2)


def attn_block(p, l: int, x, positions, m: Dict, precision: str,
               q_block=None):
    """x + the layer's attention; ``p`` the leaves by name (f32)."""
    b, s, dm = x.shape
    h, kvh = m["n_heads"], m["kv_heads"]
    hd = p["attn/wq"].shape[-1]
    y = rmsnorm(x, p["attn/ln"][l], m["norm_eps"])

    def proj(w, heads):
        return matmul(y, w[l].reshape(dm, heads * hd),
                      precision).view(b, s, heads, hd)

    q = rope(proj(p["attn/wq"], h), positions, m["rope_theta"])
    k = rope(proj(p["attn/wk"], kvh), positions, m["rope_theta"])
    v = proj(p["attn/wv"], kvh)
    o = causal_attention(q, k, v, precision, q_block)
    return x + matmul(o.reshape(b, s, h * hd),
                      p["attn/wo"][l].reshape(h * hd, dm), precision)


Ffn = Callable[[Dict, int, torch.Tensor, Dict, str], torch.Tensor]


def decoder(p, tokens, m: Dict, precision: str, ffn: Ffn,
            remat: bool = False, q_block=None):
    """The residual stream after the last layer, (B, S, D)."""
    x = p["embed"][tokens.long()] * math.sqrt(m["d_model"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def layer(x, l):
        x = attn_block(p, l, x, positions, m, precision, q_block)
        return ffn(p, l, x, m, precision)

    for l in range(m["layers"]):
        x = torch.utils.checkpoint.checkpoint(
            layer, x, l, use_reentrant=False) if remat else layer(x, l)
    return x


def logits(p, x, m: Dict, precision: str):
    """Logits over the real vocabulary of the last layer's stream."""
    x = rmsnorm(x, p["final_ln"], m["norm_eps"])
    return matmul(x, p["unembed"][:m["vocab"]].T, precision)


def named(weights: Dict) -> Dict[str, torch.Tensor]:
    """{path: tensor} → {name: float32 tensor}: a block's leaves named
    ``<part>/<leaf>``, the others by their key. ``weights`` is emptied
    as it is read, so its tensors can be freed."""
    out = {}
    for path in list(weights):
        t = weights.pop(path)
        out[key(path)] = t.float() if t.dtype != torch.float32 \
            else t.clone()
    return out


def key(path) -> str:
    """A leaf's name: ``<part>/<leaf>`` in a block, else its key."""
    return "/".join(path[2:]) if path[0] == "blocks" else path[0]


@torch.no_grad()
def logits_at(weights, m: Dict, ffn: Ffn, tokens: torch.Tensor,
              positions: Sequence[int], precisions=("float32",),
              q_block: int = 1024) -> Dict[str, torch.Tensor]:
    """{precision: (len(positions), vocab) float32 logits} of one
    sequence ``tokens`` (S,) at ``positions``; ``weights`` {name:
    float32} (:func:`named`)."""
    out = {}
    idx = torch.as_tensor(list(positions), device=tokens.device)
    for prec in precisions:
        x = decoder(weights, tokens[None], m, prec, ffn, q_block=q_block)
        out[prec] = logits(weights, x[0, idx], m, prec)
    return out


def train(weights: Dict, m: Dict, ffn: Ffn, batches: List[Dict],
          opt: Dict, microbatch: int, precision: str = "float32") -> Dict:
    """Steps of the training job on ``batches`` from ``weights``
    ({path: tensor}, read as float32 and left as they are): each
    batch's rows split into ``microbatch`` parts whose mean losses and
    gradients are averaged, the gradient clipped to a global norm of
    ``opt["grad_clip"]``, then AdamW (bias-corrected moments; decay on
    every leaf of two or more dims, as the program's rule has it).
    Returns each step's loss, step 1's gradient norm a leaf (raw and as
    clipped) and each leaf's change over all the steps."""
    p = named(dict(weights))
    start = {key(path): t for path, t in weights.items()}
    if precision == "fp8":
        # held in fp8 too, as the program holds its parameters in the
        # configuration's bf16; the change is from that start
        p = {k: fp8(t) for k, t in p.items()}
    names = list(p)
    mom = {k: torch.zeros_like(t) for k, t in p.items()}
    vel = {k: torch.zeros_like(t) for k, t in p.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad_raw, grad_clipped = [], {}, {}
    for step, batch in enumerate(batches, 1):
        gsum = {k: torch.zeros_like(t) for k, t in p.items()}
        lsum = 0.0
        parts = zip(batch["tokens"].chunk(microbatch),
                    batch["labels"].chunk(microbatch))
        for tokens, labels in parts:
            leaf = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            with torch.enable_grad():
                x = decoder(leaf, tokens, m, precision, ffn, remat=True)
                lg = logits(leaf, x, m, precision)
                loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                       labels.reshape(-1).long())
                del x, lg
                grads = torch.autograd.grad(loss, [leaf[k] for k in names],
                                            allow_unused=True)
            for k, g in zip(names, grads):
                if g is not None:
                    gsum[k].add_(g)
            lsum += float(loss.detach())
            del leaf, grads, loss
        for g in gsum.values():
            g.div_(microbatch)
        losses.append(lsum / microbatch)
        gnorm = math.sqrt(sum(float(g.square().sum()) for g in gsum.values()))
        clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12)) \
            if opt["grad_clip"] > 0 else 1.0
        if step == 1:
            grad_raw = {k: float(g.norm()) for k, g in gsum.items()}
            grad_clipped = {k: v * clip for k, v in grad_raw.items()}
        with torch.no_grad():
            for k in names:
                g = gsum[k] * clip
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                delta = (mom[k] / (1 - b1 ** step)) / (
                    torch.sqrt(vel[k] / (1 - b2 ** step)) + eps)
                if p[k].dim() >= 2 and opt["weight_decay"] > 0:
                    delta = delta + opt["weight_decay"] * p[k]
                p[k] -= opt["lr"] * delta
                if precision == "fp8":
                    p[k] = fp8(p[k])
        del gsum
    held = fp8 if precision == "fp8" else torch.Tensor.float
    change = {k: float((p[k] - held(start[k].float())).norm())
              for k in names}
    return {"losses": losses, "grad_raw": grad_raw,
            "grad_clipped": grad_clipped, "change": change}
