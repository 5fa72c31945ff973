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

With ``return_state`` both return (y, h_L): the state after the last
step, (B, I, N) in ``promote(dtype, float32)`` (zeros for L = 0), which
a prompt's prefill hands to decode.
* :func:`mamba_scan_chunked_ref` — the kernel's decomposition of the same
  function: walks of ``chunk`` steps from a zero state, the carry passed
  between them by the associative combine (a chunk maps h to
  ``exp(decay * S) h + h_end``, S its sum of dt), and a second walk of
  each chunk from its carry. It holds the carry algebra to the oracles
  on the CPU (the tests use it; nothing else does).
"""

from __future__ import annotations

import torch


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   return_state: bool = False):
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
    y = y + d_skip[None, None] * x
    return (y, h) if return_state else y


def mamba_scan_promoted_ref(x: torch.Tensor, dt: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            a: torch.Tensor, d_skip: torch.Tensor,
                            return_state: bool = False):
    acc = torch.promote_types(x.dtype, torch.float32)
    y, h = mamba_scan_ref(*(t.to(acc) for t in (x, dt, Bm, Cm, a, d_skip)),
                          return_state=True)
    return (y.to(x.dtype), h) if return_state else y.to(x.dtype)


def mamba_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                           Bm: torch.Tensor, Cm: torch.Tensor,
                           a: torch.Tensor, d_skip: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    xs, dts, bs, cs, a_, d = (t.to(acc) for t in (x, dt, Bm, Cm, a,
                                                   d_skip))
    b, l, inner = x.shape
    decay = -torch.exp(a_)                                 # (I, N)
    carry = torch.zeros((b, inner, Bm.shape[-1]), dtype=acc,
                        device=x.device)

    def walk(h, t0, t1, out=None):
        for t in range(t0, t1):
            a_bar = torch.exp(dts[:, t, :, None] * decay[None])
            h = a_bar * h + (dts[:, t] * xs[:, t])[..., None] \
                * bs[:, t, None, :]
            if out is not None:
                out.append((h * cs[:, t, None, :]).sum(-1))
        return h

    ys = []
    for t0 in range(0, l, chunk):
        t1 = min(t0 + chunk, l)
        h_end = walk(torch.zeros_like(carry), t0, t1)    # from h = 0
        s = dts[:, t0:t1].sum(1)                          # (B, I)
        walk(carry, t0, t1, ys)                           # from the carry
        carry = torch.exp(s[..., None] * decay[None]) * carry + h_end
    y = torch.stack(ys, dim=1) if ys else carry.new_zeros((b, 0, inner))
    return (y + d[None, None] * xs).to(x.dtype)
