"""State-space / recurrent blocks of the port: Mamba (jamba) and xLSTM
(mLSTM / sLSTM).

The reference's ``repro/models/ssm.py`` in PyTorch. A mixer takes
``state=None`` (a forward pass without caches) or a decode state; it
returns ``(x, new_state)``. What changes against the reference, and why:

* The Mamba scan always goes through ``kernels.mamba_scan.ops``: the
  hand-written kernel for tensors on the card, its plain version for
  tensors on the CPU (the reference's ``use_pallas`` is gone, as in
  ``common.py``; its default path, an associative scan, computes the
  same recurrence).
* Prefill. The reference's prefill passes caches, so each mixer took its
  single-token branch, which reads only the first token, for the whole
  prompt (ROADMAP Queue 3, entry 7). Here a state with a prompt of more
  than one token runs the prompt's forward computation and returns the
  state after its last token: Mamba the scan's final state, mLSTM its
  memory and normaliser in closed form from the parallel form's gates,
  sLSTM the carry of its step loop. Mamba and mLSTM start that prompt
  from the zero state (as ``init_caches`` makes it: a prefill, never a
  continuation); sLSTM steps from the state it is given. A single token
  with a state takes the reference's recurrence.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ops as scan_ops
from .common import (ArchConfig, KeyGen, _init, _zeros, gathered,
                     heads_proj, out_proj, product, rmsnorm)


# ---------------------------------------------------------------------------
# Mamba (selective SSM, Mamba-1 style simplified)
# ---------------------------------------------------------------------------

def init_mamba(kg: KeyGen, cfg: ArchConfig) -> Tuple[Dict, Dict]:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    n = cfg.ssm_state
    dev = kg.gen.device
    p = {
        "in_proj": _init(kg(), (d, 2 * inner), cfg.dtype),
        "x_proj": _init(kg(), (inner, 2 * n + 1), cfg.dtype),
        "dt_bias": torch.zeros((inner,), dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=dev)).expand(
                inner, n).contiguous(),
        "d_skip": torch.ones((inner,), dtype=torch.float32, device=dev),
        "out_proj": _init(kg(), (inner, d), cfg.dtype),
        "ln": _zeros(kg, (d,), cfg.dtype),
    }
    s = {
        "in_proj": ("embed", "inner"),
        "x_proj": ("inner", "ssm"),
        "dt_bias": ("inner",),
        "a_log": ("inner", "ssm"),
        "d_skip": ("inner",),
        "out_proj": ("inner", "embed"),
        "ln": ("embed",),
    }
    return p, s


def apply_mamba(p, x, cfg: ArchConfig, state: Optional[Dict] = None):
    """x: (B, S, D). state (decode): {'h': (B, I, N)}."""
    b, s, d = x.shape
    n = cfg.ssm_state
    h0 = rmsnorm(x, p["ln"], cfg.norm_eps)
    proj = product("bsd,di->bsi", h0, p["in_proj"])
    xz, gate = proj.chunk(2, dim=-1)
    xz = F.silu(xz)
    dbc = product("bsi,ik->bsk", xz, p["x_proj"]).float()
    dt = F.softplus(dbc[..., 0:1]
                    + gathered(p["dt_bias"], dbc, (0, 1))[None, None])
    Bm, Cm = dbc[..., 1:1 + n], dbc[..., 1 + n:]
    a = p["a_log"]

    if state is not None and s == 1:
        # single-token decode: the recurrence, one step
        a, d_skip = gathered(a, xz, (0, 1)), gathered(p["d_skip"], xz,
                                                       (0, 1))
        a_bar = torch.exp(dt[:, 0, :, None] * (-torch.exp(a))[None])
        bx = (dt[:, 0] * xz[:, 0].float())[..., None] * Bm[:, 0, None, :]
        h = a_bar * state["h"] + bx                       # (B, I, N)
        y = (h * Cm[:, 0, None, :]).sum(-1)[:, None]      # (B, 1, I)
        y = y + d_skip[None, None] * xz.float()
        new_state = {"h": h}
    else:
        # the scan over the sequence from h = 0; a prefill keeps h_L
        y, h = scan_ops.mamba_scan(
            xz.float().contiguous(), dt.contiguous(), Bm.contiguous(),
            Cm.contiguous(), a, p["d_skip"], return_state=True)
        new_state = None if state is None else {"h": h}

    y = (y * F.silu(gate.float())).to(x.dtype)
    out = product("bsi,id->bsd", y, p["out_proj"])
    return x + out, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, device="cpu") -> Dict:
    inner = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, inner, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------

def init_mlstm(kg: KeyGen, cfg: ArchConfig) -> Tuple[Dict, Dict]:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    p = {
        "wq": _init(kg(), (d, h, hd), cfg.dtype),
        "wk": _init(kg(), (d, h, hd), cfg.dtype),
        "wv": _init(kg(), (d, h, hd), cfg.dtype),
        "wif": _init(kg(), (d, 2 * h), cfg.dtype),  # input+forget gates
        "wo": _init(kg(), (h, hd, d), cfg.dtype),
        "ln": _zeros(kg, (d,), cfg.dtype),
    }
    s = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "heads", "head_dim"),
        "wv": ("embed", "heads", "head_dim"),
        "wif": ("embed", "heads"),
        "wo": ("heads", "head_dim", "embed"),
        "ln": ("embed",),
    }
    return p, s


def apply_mlstm(p, x, cfg: ArchConfig, state: Optional[Dict] = None):
    """Matrix-memory LSTM: per head a (hd × hd) outer-product memory with
    scalar input/forget gates; parallel (attention-like) form over a
    sequence, recurrent form for a single decode token."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xin = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = heads_proj(xin, p["wq"]) / math.sqrt(hd)
    k = heads_proj(xin, p["wk"]) / math.sqrt(hd)
    v = heads_proj(xin, p["wv"])
    gates = product("bsd,dg->bsg", xin, p["wif"]).float()
    i_gate = torch.exp(torch.clamp(gates[..., :h], max=8.0))  # stabilized
    f_gate = torch.sigmoid(gates[..., h:])

    if state is not None and s == 1:
        # recurrent: C_t = f C_{t-1} + i (v ⊗ k); y = C_t q / max(|n·q|,1)
        C, nvec = state["C"], state["n"]
        f1 = f_gate[:, 0, :, None, None]
        i1 = i_gate[:, 0, :, None, None]
        C = f1 * C + i1 * torch.einsum("bhk,bhl->bhkl", v[:, 0].float(),
                                       k[:, 0].float())
        nvec = f_gate[:, 0, :, None] * nvec \
            + i_gate[:, 0, :, None] * k[:, 0].float()
        num = torch.einsum("bhkl,bhl->bhk", C, q[:, 0].float())
        den = torch.clamp(torch.einsum("bhl,bhl->bh", nvec,
                                       q[:, 0].float()).abs(), min=1.0)
        out = (num / den[..., None])[:, None].to(x.dtype)
        new_state = {"C": C, "n": nvec}
    else:
        # parallel form: D[t,τ] = (∏_{j=τ+1..t} f_j) · i_τ  (τ ≤ t)
        logf = torch.log(f_gate + 1e-8)                      # (B,S,H)
        cum = logf.cumsum(1)
        decay = cum[:, :, None, :] - cum[:, None, :, :]      # (B,t,τ,H)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=x.device))
        dmat = torch.where(causal[None, :, :, None],
                           torch.exp(decay) * i_gate[:, None],
                           torch.zeros((), device=x.device))
        scores = torch.einsum("bthk,bshk->bths", q, k).float()
        scores = scores * dmat.movedim(3, 2)                 # (B,t,H,τ)
        norm = torch.clamp(scores.sum(-1).abs(), min=1.0)
        out = torch.einsum("bths,bshk->bthk",
                           (scores / norm[..., None]).to(x.dtype), v)
        new_state = None
        if state is not None:
            # the memory after the prompt, in closed form from zero:
            # C_S = Σ_τ (∏_{j>τ} f_j) i_τ v_τ ⊗ k_τ, n_S likewise with k_τ.
            # The weights are products of f, as the recurrence takes
            # them (the parallel form's log(f + 1e-8) is not its f).
            tail = torch.cat([f_gate.flip(1).cumprod(1).flip(1)[:, 1:],
                              torch.ones_like(f_gate[:, :1])], dim=1)
            w = tail * i_gate                                # (B,S,H)
            new_state = {
                "C": torch.einsum("bsh,bshk,bshl->bhkl", w, v.float(),
                                  k.float()),
                "n": torch.einsum("bsh,bshl->bhl", w, k.float())}

    # head-wise normalization (xLSTM applies GroupNorm before out-proj)
    out32 = out.float()
    var = out32.square().mean(dim=-1, keepdim=True)
    out = (out32 * torch.rsqrt(var + 1e-6)).to(x.dtype)
    y = out_proj(out, p["wo"])
    return x + y.to(x.dtype), new_state


def init_slstm(kg: KeyGen, cfg: ArchConfig) -> Tuple[Dict, Dict]:
    d = cfg.d_model
    p = {
        "wx": _init(kg(), (d, 4 * d), cfg.dtype),   # i, f, z, o pre-acts
        "wh": _init(kg(), (d, 4 * d), cfg.dtype),
        "ln": _zeros(kg, (d,), cfg.dtype),
    }
    s = {"wx": ("embed", "inner"), "wh": ("embed", "inner"),
         "ln": ("embed",)}
    return p, s


def apply_slstm(p, x, cfg: ArchConfig, state: Optional[Dict] = None):
    """Scalar-memory LSTM with exponential gating; a step loop over the
    sequence (the reference's ``lax.scan``), from the state when one is
    given (whose carry after the last token is the new state)."""
    b, s, d = x.shape
    xin = rmsnorm(x, p["ln"], cfg.norm_eps)
    pre_x = product("bsd,dg->bsg", xin, p["wx"]).float()
    wh = gathered(p["wh"], xin).float()

    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, torch.ones_like(zeros))
    else:
        carry = (state["h"], state["c"], state["n"])
    hs = []
    for t in range(s):
        h_prev, c_prev, n_prev = carry
        pre = pre_x[:, t] + h_prev @ wh
        i, f, z, o = pre.chunk(4, dim=-1)
        i = torch.exp(torch.clamp(i, max=8.0))
        f = torch.sigmoid(f)
        c = f * c_prev + i * torch.tanh(z)
        n = f * n_prev + i
        h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
        carry = (h, c, n)
        hs.append(h)
    y = torch.stack(hs, dim=1)
    new_state = None if state is None else dict(zip("hcn", carry))

    # feature-wise normalization (GroupNorm analogue)
    var = y.square().mean(dim=-1, keepdim=True)
    out = (y * torch.rsqrt(var + 1e-6)).to(x.dtype)
    return x + out, new_state


def init_xlstm_state(cfg: ArchConfig, kind: str, batch: int,
                     device="cpu") -> Dict:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        return {"C": torch.zeros((batch, h, hd, hd), **z),
                "n": torch.zeros((batch, h, hd), **z)}
    return {"h": torch.zeros((batch, d), **z),
            "c": torch.zeros((batch, d), **z),
            "n": torch.ones((batch, d), **z)}
