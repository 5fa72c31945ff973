"""Worker-side task functions for cluster LM serving.

The reference's ``repro/serve/remote_lm.py`` in PyTorch. The cluster
ships task functions with :func:`repro_torch.distrib.serial.dumps_fn`,
which pickles a function's non-module globals **by value**. A bare
module-level dict referenced from a shipped function would therefore
arrive as a private copy per task — a cache that never hits. The rule
this module is built around: shipped entry points
(``lm_boot``/``lm_prefill``/``lm_decode``/``lm_out``/``lm_anchor``)
reference only module-level *functions* (pickle serializes those by
reference, so the worker imports this module and resolves the real
objects). All mutable state — the per-config cache of model callables
``_CALLS`` — lives behind those by-reference functions and persists
across tasks inside each worker process.

State travels as a :class:`Resident`: a wrapper whose ``nbytes``
reports at least 64 KiB so the worker's result-residency rule
(``repro_torch.distrib.worker.INLINE_MAX``, 32 KiB) keeps the params+KV
state in the worker's object store instead of inlining it back to the
head every tick. Only ``lm_out``'s token vector — a few bytes — rides
the wire per decode step. Pickling (lineage anchors, head fetches for
re-anchoring) turns every tensor into a host array (:func:`tree_np`):
numpy has no bfloat16, so a bf16 leaf travels as its 16-bit pattern
(:class:`Bits`, a ``uint16`` view and the dtype's name), never widened
— widening would double the bytes a boot ships. A Resident that arrives
as host arrays moves to the worker's device
(:func:`repro_torch.kernels.api.device`, which the worker binds at
start) on its first op and stays there as tensors.

The decode math is :class:`repro_torch.serve.engine.ServeEngine`'s
(same prefill → argmax → insert → batched decode ordering, the same
model calls under ``torch.inference_mode()``, its own insert), which is
what makes the cluster engine's token streams **bitwise-identical** to
the single-process engine's.

Aliasing. Where the reference's functional jax arrays never alias, the
port's model writes its caches in place (``models.common.apply_attn``,
``ServeEngine._insert``): an op's result shares its caches with the
state it consumed, so the superseded state in the head's chain no
longer holds its own caches. Copying instead would keep up to
``trim_every`` copies of the caches (~1 GB for gemma2_2b at 4 slots ×
2048 positions) on the card. No copy is needed, because no op ever
reads a superseded state: the head advances the chain one op at a time,
each state is consumed once, and a replay after a worker's death
rebuilds the chain from its root (the boot or the last anchor, whose
value the head keeps in the task's lineage) on a survivor, where each
replayed op again consumes only its predecessor's fresh result. That is
checked at run time: the Residents of one chain in one process share a
``live`` token that names the newest state's sequence number; an op
claims its input (raising :class:`SupersededState` on a state an op
already consumed, or one caught mid-op by a failure, whose caches may
be half written) and hands the token to its result.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import api

__all__ = ["Bits", "Resident", "SupersededState", "lm_boot", "lm_prefill",
           "lm_decode", "lm_out", "lm_anchor", "tree_np", "tree_torch"]

# worker residency floor: anything reporting more bytes than
# repro_torch.distrib.worker.INLINE_MAX stays in the worker object store
_RESIDENT_FLOOR = 1 << 16

_CALLS: dict = {}   # (cfg.name, dtype, max_seq) → (prefill, decode, insert)

# the prefill and decode ops this process has run, replays included
ops = {"prefill": 0, "decode": 0}


class SupersededState(RuntimeError):
    """An op was handed a state whose caches a later op already wrote."""


@dataclass
class Bits:
    """A host copy of a tensor whose dtype numpy lacks (bfloat16): its
    bit pattern as ``uint16`` and the torch dtype's name."""

    bits: np.ndarray
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes)


def _host(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return Bits(t.view(torch.int16).numpy().view(np.uint16),
                    "bfloat16")
    return t.numpy()


def tree_np(tree):
    """Recursively turn tensor leaves into host arrays (bf16 as
    :class:`Bits`); numpy leaves and everything else pass through."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _host(tree)
    return tree


def tree_torch(tree, device):
    """:func:`tree_np`'s inverse: host arrays (and :class:`Bits`) become
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_torch(v, device) for v in tree)
    if isinstance(tree, Bits):
        t = torch.from_numpy(tree.bits.view(np.int16)).view(
            getattr(torch, tree.dtype))
        return t.to(device, copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device, copy=True)
    return tree


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray, Bits)):
        return int(tree.nbytes)
    return 0


class Resident:
    """Worker-resident serving state (+ the small per-step output that
    :func:`lm_out` extracts for the head). ``seq`` numbers the state in
    its chain; ``live`` is the chain's token (module docstring)."""

    def __init__(self, value, out=None, seq: int = 0, live=None):
        self.value = value
        self.out = out
        self.seq = seq
        self.live = [seq] if live is None else live
        self.nbytes = max(_tree_nbytes(value), _RESIDENT_FLOOR)

    def __getstate__(self):
        # a copy of a superseded state (seq None) can never be claimed
        seq = self.seq if self.live[0] == self.seq else None
        return {"value": tree_np(self.value), "out": tree_np(self.out),
                "seq": seq, "nbytes": self.nbytes}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.live = [self.seq]


def _claim(res: Resident) -> dict:
    """The state's value, on the worker's device, for an op that writes
    its caches in place; the state can be claimed no more."""
    if res.seq is None or res.live[0] != res.seq:
        raise SupersededState(
            f"state {res.seq} of its chain was already consumed (the "
            f"newest is {res.live[0]}): its caches are no longer its own")
    res.live[0] = None          # mid-op: a failure leaves it unclaimable
    st = res.value
    if not isinstance(st["params"]["embed"], torch.Tensor):
        # arrived as host arrays (an anchor): onto the device once, in
        # place, so that the host copy is freed
        res.value = st = tree_torch(st, torch.device(api.device()))
    return st


def _successor(res: Resident, value: dict, out: np.ndarray) -> Resident:
    new = Resident(value, out=out, seq=res.seq + 1, live=res.live)
    res.live[0] = new.seq
    return new


def _calls_for(cfg, max_seq: int):
    """Per-(config, max_seq) prefill/decode/insert, cached for the life
    of the worker process: ServeEngine's calls, eager (no compile)."""
    key = (cfg.name, str(getattr(cfg, "dtype", "")), int(max_seq))
    entry = _CALLS.get(key)
    if entry is None:
        from repro_torch.models import transformer as T
        from repro_torch.serve.engine import ServeEngine

        @torch.inference_mode()
        def _prefill(params, tokens):
            return T.prefill(params, {"tokens": tokens}, cfg, max_seq)

        @torch.inference_mode()
        def _decode(params, tokens, caches):
            return T.decode_step(params, tokens, caches, cfg)

        entry = (_prefill, _decode, ServeEngine._insert)
        _CALLS[key] = entry
    return entry


def _boot_impl(params, cfg, n_slots: int, max_seq: int) -> Resident:
    from repro_torch.models import transformer as T

    dev = torch.device(api.device())
    state = {"params": tree_torch(params, dev),
             "caches": T.init_caches(cfg, n_slots, max_seq, device=dev),
             "cfg": cfg, "n_slots": int(n_slots), "max_seq": int(max_seq)}
    return Resident(state, out=np.zeros(0, np.int32))


def _prefill_impl(res: Resident, prompt, slot: int) -> Resident:
    st = _claim(res)
    prefill, _, insert = _calls_for(st["cfg"], st["max_seq"])
    dev = st["params"]["embed"].device
    tokens = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    one_cache, logits = prefill(st["params"], tokens)
    tok = int(torch.argmax(logits[0]))
    caches = insert(st["caches"], one_cache, int(slot))
    ops["prefill"] += 1
    return _successor(res, dict(st, caches=caches),
                      np.asarray([tok], np.int32))


def _decode_impl(res: Resident, tokens) -> Resident:
    st = _claim(res)
    _, decode, _ = _calls_for(st["cfg"], st["max_seq"])
    dev = st["params"]["embed"].device
    logits, caches = decode(st["params"],
                            torch.as_tensor(np.asarray(tokens), device=dev),
                            st["caches"])
    next_tokens = torch.argmax(logits, dim=-1).cpu().numpy().astype(
        np.int32)
    ops["decode"] += 1
    return _successor(res, dict(st, caches=caches), next_tokens)


# -- shipped entry points (reference only module-level functions) -----------

def lm_boot(params, cfg, n_slots, max_seq):
    """Materialize fresh serving state (params + empty KV caches)."""
    return _boot_impl(params, cfg, n_slots, max_seq)


def lm_prefill(state, prompt, slot):
    """Prefill one prompt into ``slot``; out = its first greedy token."""
    return _prefill_impl(state, prompt, slot)


def lm_decode(state, tokens):
    """One batched decode tick; out = next token per slot."""
    return _decode_impl(state, tokens)


def lm_out(state):
    """Extract the small per-step output (inlined back to the head)."""
    return np.asarray(state.out)


def lm_anchor(state):
    """Re-root lineage: the head attaches the full state value to this
    task's spec, so replay after a worker loss restarts here instead of
    walking the whole decode history."""
    return state
