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

The gradient (``csrc/mamba_scan_bwd.cu`` computes it on the card), with
A = -exp(a), dA_t = exp(dt_t ⊙ A) and the adjoint g_t = ∂L/∂h_t:

    g_t = dy_t ⊗ C_t + dA_{t+1} ⊙ g_{t+1},  g_L = dy_L ⊗ C_L + dh_L
    dx_t  = d_skip ⊙ dy_t + dt_t ⊙ Σ_n g_t B_t
    ddt_t = x_t ⊙ Σ_n g_t B_t + Σ_n g_t ⊙ h_{t-1} ⊙ A ⊙ dA_t
    dB_t = Σ_i g_t (dt_t x_t),  dC_t = Σ_i dy_t h_t
    da = Σ_{b,t} g_t ⊙ h_{t-1} ⊙ dA_t ⊙ dt_t ⊙ A
    dd_skip = Σ_{b,t} dy_t x_t

(dh_L: the gradient of the final state, where ``return_state`` handed
it out; none is 0), accumulated in ``promote(dtype, float32)``, each
gradient cast to its operand's dtype.

* :func:`mamba_scan_bwd_ref` — that, step by step: h recomputed
  forward, then the adjoint walked back.
* :func:`mamba_scan_bwd_chunked_ref` — the backward kernel's
  decomposition, all chunks at once: each chunk's entry state (the
  forward's carry), each chunk's adjoint walked back from 0, the
  adjoint's carry between chunks passed from the last chunk back by the
  same combine (a chunk maps g to ``exp(decay * S) g + g_local``), the
  final walks of each chunk from its entry state and its carry, and dB
  and dC summed over each tile of channels (a block's), then over the
  tiles in order. ``carry=False`` drops the carry between chunks (a
  negative control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def _grads_out(x, dt, Bm, Cm, a, d_skip, grads):
    """The gradients cast to their operands' dtypes."""
    return tuple(g.to(t.dtype) for g, t in zip(
        grads, (x, dt, Bm, Cm, a, d_skip)))


def mamba_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       a: torch.Tensor, d_skip: torch.Tensor,
                       dy: torch.Tensor, dh_last=None):
    """(dx, ddt, dB, dC, da, dd_skip) of :func:`mamba_scan_promoted_ref`
    from the output's gradient ``dy`` (B, L, I) and, where given, the
    final state's ``dh_last`` (B, I, N)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xs, dts, bs, cs, a_, d, dys = (t.to(acc) for t in (
        x, dt, Bm, Cm, a, d_skip, dy))
    b, l, inner = x.shape
    n = Bm.shape[-1]
    decay = -torch.exp(a_)                                 # A, (I, N)
    # h_{t-1} for every t, and h_L
    hs = [torch.zeros((b, inner, n), dtype=acc, device=x.device)]
    for t in range(l):
        hs.append(torch.exp(dts[:, t, :, None] * decay[None]) * hs[-1]
                  + (dts[:, t] * xs[:, t])[..., None] * bs[:, t, None, :])
    g = torch.zeros_like(hs[0]) if dh_last is None else dh_last.to(acc)
    dx, ddt = torch.zeros_like(xs), torch.zeros_like(xs)
    dbm, dcm = torch.zeros_like(bs), torch.zeros_like(cs)
    da = torch.zeros_like(a_)
    for t in range(l - 1, -1, -1):
        a_bar = torch.exp(dts[:, t, :, None] * decay[None])
        g = g + dys[:, t, :, None] * cs[:, t, None, :]        # g_t
        gb = (g * bs[:, t, None, :]).sum(-1)                 # (B, I)
        z = g * hs[t] * a_bar                                # g h_{t-1} dA
        dx[:, t] = dts[:, t] * gb
        ddt[:, t] = xs[:, t] * gb + (z * decay[None]).sum(-1)
        dbm[:, t] = (g * (dts[:, t] * xs[:, t])[..., None]).sum(1)
        dcm[:, t] = (dys[:, t, :, None] * hs[t + 1]).sum(1)
        da = da + (z * dts[:, t, :, None]).sum(0)
        g = a_bar * g                                        # to t - 1
    dx = dx + d[None, None] * dys
    return _grads_out(x, dt, Bm, Cm, a, d_skip, (
        dx, ddt, dbm, dcm, da * decay, (dys * xs).sum((0, 1))))


def mamba_scan_bwd_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                               Bm: torch.Tensor, Cm: torch.Tensor,
                               a: torch.Tensor, d_skip: torch.Tensor,
                               dy: torch.Tensor, dh_last=None, *,
                               chunk: int = 64, tile: int = 128,
                               carry: bool = True):
    """:func:`mamba_scan_bwd_ref` as the backward kernel decomposes it,
    every chunk of ``chunk`` steps at once (L zero-padded to whole
    chunks: a step with dt = x = dy = 0 and B = C = 0 leaves the state
    and the adjoint as they are), dB and dC summed over tiles of ``tile``
    channels (I zero-padded to whole tiles) and then over the tiles in
    order. ``carry=False``: each chunk but the last starts its adjoint
    from 0."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b, l, inner = x.shape
    n = Bm.shape[-1]
    nc = max(1, math.ceil(l / chunk))

    def split(t):                         # (B, L, K) -> (B, nc, chunk, K)
        t = F.pad(t.to(acc), (0, 0, 0, nc * chunk - l))
        return t.reshape(b, nc, chunk, t.shape[-1])

    xs, dts, dys, bs, cs = (split(t) for t in (x, dt, dy, Bm, Cm))
    dtx = dts * xs
    decay = -torch.exp(a.to(acc))                          # (I, N)

    def a_bar(j):                                          # (B, nc, I, N)
        return torch.exp(dts[:, :, j, :, None] * decay)

    def step(h, j):
        return a_bar(j) * h + dtx[:, :, j, :, None] * bs[:, :, j, None, :]

    nt = max(1, math.ceil(inner / tile))

    def tile_sum(t):                      # (B, nc, I, N) -> (B, nc, N)
        t = F.pad(t, (0, 0, 0, nt * tile - inner))
        t = t.reshape(b, nc, nt, tile, n).sum(3)
        out = t[:, :, 0]
        for k in range(1, nt):
            out = out + t[:, :, k]
        return out

    s = dts.sum(2)                                         # (B, nc, I)
    span = torch.exp(s[..., None] * decay)                 # exp(A S)
    zero = torch.zeros((b, nc, inner, n), dtype=acc, device=x.device)
    # each chunk's entry state: walks from 0, the carry from the left
    h_end = zero
    for j in range(chunk):
        h_end = step(h_end, j)
    entry, h = [], zero[:, 0]
    for c in range(nc):
        entry.append(h)
        h = span[:, c] * h + h_end[:, c]
    # each chunk's adjoint walked back from 0, the carry from the right
    g_end = zero
    for j in range(chunk - 1, -1, -1):
        g_end = a_bar(j) * (g_end + dys[:, :, j, :, None]
                            * cs[:, :, j, None, :])
    u = zero[:, 0] if dh_last is None else dh_last.to(acc)
    into = []
    for c in range(nc - 1, -1, -1):
        into.append(u)
        u = span[:, c] * u + g_end[:, c] if carry else zero[:, 0]
    # the final walks: h from the entry state, the adjoint from the carry
    hs = [torch.stack(entry, 1)]
    for j in range(chunk):
        hs.append(step(hs[-1], j))
    g = torch.stack(into[::-1], 1)
    dx, ddt, dbm, dcm = (torch.zeros_like(t) for t in (xs, xs, bs, cs))
    da = torch.zeros((b, nc, inner, n), dtype=acc, device=x.device)
    for j in range(chunk - 1, -1, -1):
        ab = a_bar(j)
        g = g + dys[:, :, j, :, None] * cs[:, :, j, None, :]
        gb = (g * bs[:, :, j, None, :]).sum(-1)
        z = g * hs[j] * ab
        dx[:, :, j] = dts[:, :, j] * gb
        ddt[:, :, j] = xs[:, :, j] * gb + (z * decay).sum(-1)
        dbm[:, :, j] = tile_sum(g * dtx[:, :, j, :, None])
        dcm[:, :, j] = tile_sum(dys[:, :, j, :, None] * hs[j + 1])
        da = da + z * dts[:, :, j, :, None]
        g = ab * g

    def whole(t):                                          # back to (B, L, K)
        return t.reshape(b, nc * chunk, t.shape[-1])[:, :l]

    dys_l = whole(dys)
    dx = whole(dx) + d_skip.to(acc)[None, None] * dys_l
    return _grads_out(x, dt, Bm, Cm, a, d_skip, (
        dx, whole(ddt), whole(dbm), whole(dcm), da.sum((0, 1)) * decay,
        (dys_l * whole(xs)).sum((0, 1))))
