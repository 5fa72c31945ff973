"""Plain torch versions of the selective-scan kernel (its oracles, and
the path CPU tensors take).

h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t ;  y_t = h_t · C_t
x/dt: (B, L, I);  Bm/Cm: (B, L, N);  a: (I, N) log-decay;  d: (I,) skip.

* :func:`mamba_scan_ref` — the sequential recurrence of
  ``repro/kernels/mamba_scan/ref.py``. As the reference's oracle, it
  returns the promoted dtype (the state is carried in
  ``promote(dtype, float32)``) while the kernel casts to ``x``'s dtype:
  compare after casting. With bf16 inputs it computes the decays in
  bf16, as that oracle does.
* :func:`mamba_scan_promoted_ref` — exactly what the kernel computes
  (and the reference's Pallas kernel): the same recurrence on the
  inputs cast to ``promote(dtype, float32)``, cast to ``x``'s dtype.
"""

from __future__ import annotations

import torch


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, a: torch.Tensor,
                   d_skip: torch.Tensor) -> torch.Tensor:
    b, l, inner = x.shape
    n = Bm.shape[-1]
    decay = -torch.exp(a)                                  # (I, N)
    h = torch.zeros((b, inner, n), dtype=torch.promote_types(
        x.dtype, torch.float32), device=x.device)
    ys = []
    for t in range(l):
        a_bar = torch.exp(dt[:, t, :, None] * decay[None])  # (B, I, N)
        h = a_bar * h + (dt[:, t] * x[:, t])[..., None] \
            * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))          # (B, I)
    y = torch.stack(ys, dim=1) if ys else h.new_zeros((b, 0, inner))
    return y + d_skip[None, None] * x


def mamba_scan_promoted_ref(x: torch.Tensor, dt: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            a: torch.Tensor,
                            d_skip: torch.Tensor) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    return mamba_scan_ref(*(t.to(acc) for t in (x, dt, Bm, Cm, a,
                                                 d_skip))).to(x.dtype)
