"""Batched serving engine with continuous batching, on one device.

The reference's ``repro/serve/engine.py`` in PyTorch. Requests are
admitted into free cache slots (prefill), then all active slots advance
together through one batched decode step per tick — new requests join
between ticks with no change of shape. Greedy sampling; per-request
max_tokens / eos termination. Where the reference jits its prefill,
decode and insert, the port runs them eagerly under
``torch.inference_mode()`` on ``device``: the card by default, where
every attention layer runs the hand-written flash kernel; with
``device="cpu"`` the kernel's plain version. The caches are written in
place (``models.common.apply_attn``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import obs

from repro_torch.core.txp import DeviceUnavailable
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig

from .kvcache import SlotMap
from .request import Request

__all__ = ["Request", "ServeEngine", "serving_device"]


def serving_device(device) -> torch.device:
    """``device`` as a torch device to serve on; raises
    :class:`DeviceUnavailable` for a card this host does not have."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ServeEngine serves on 'cuda' or 'cpu', got "
                         f"{device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"ServeEngine(device={device!r}) serves on a CUDA device and "
            f"torch sees none; pass device='cpu' to serve on the CPU "
            f"through the attention kernel's plain version")
    return dev


class ServeEngine:
    """Continuous-batching engine.

    ``params`` must lie on ``device``.

    Serving counters are registry-backed (``serve#N`` scope of
    ``obs.metrics``) via MetricAttr descriptors — attribute semantics
    unchanged, values readable alongside cluster/kernel metrics."""

    ticks = obs.MetricAttr("ticks")
    prefills = obs.MetricAttr("prefills")
    tokens_generated = obs.MetricAttr("tokens_generated")

    def __init__(self, params, cfg: ArchConfig, *, n_slots: int = 4,
                 max_seq: int = 256, device="cuda"):
        self.device = serving_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"ServeEngine on {self.device} needs its "
                             f"params there, got them on "
                             f"{params['embed'].device}")
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.slots = SlotMap(n_slots)
        self.caches = T.init_caches(cfg, n_slots, max_seq,
                                    device=self.device)
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self._tenant_of: Dict[str, str] = {}
        self._mscope = obs.metrics.unique_scope("serve")
        self.ticks = 0
        self.prefills = 0
        self.tokens_generated = 0

    @torch.inference_mode()
    def _prefill(self, params, tokens):
        return T.prefill(params, {"tokens": tokens}, self.cfg, self.max_seq)

    @torch.inference_mode()
    def _decode(self, params, tokens, caches):
        return T.decode_step(params, tokens, caches, self.cfg)

    @staticmethod
    @torch.inference_mode()
    def _insert(caches, one, slot: int):
        """Write a batch-1 cache into batched caches at ``slot``."""
        def ins(big, small):
            for name, leaf in big.items():
                if isinstance(leaf, dict):
                    ins(leaf, small[name])
                else:
                    leaf[:, slot] = small[name][:, 0].to(leaf.dtype)

        for big, small in zip(caches, one):
            ins(big, small)
        return caches

    # latency histograms + per-tenant counters resolve through the
    # instance scope lazily (same contract as MetricAttr: an instance
    # built via __new__ in tests still gets a working telemetry surface)
    @property
    def _h_ttft(self):
        return obs.MetricAttr._scope_of(self).histogram("ttft_ms")

    @property
    def _h_tpot(self):
        return obs.MetricAttr._scope_of(self).histogram("tpot_ms")

    @property
    def _h_e2e(self):
        return obs.MetricAttr._scope_of(self).histogram("e2e_ms")

    @property
    def _t_requests(self):
        return obs.MetricAttr._scope_of(self).dictmetric("tenant_requests")

    @property
    def _t_tokens(self):
        return obs.MetricAttr._scope_of(self).dictmetric("tenant_tokens")

    # -- API ----------------------------------------------------------------
    def add_request(self, req: Request, tenant: str = "default") -> None:
        self._tenant_of[req.request_id] = tenant
        self._t_requests[tenant] = self._t_requests.get(tenant, 0) + 1
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue:
            slot = self.slots.allocate(self.queue[0].request_id)
            if slot is None:
                return
            req = self.queue.pop(0)
            req.slot = slot
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                     device=self.device)[None]
            one_cache, logits = self._prefill(self.params, tokens)
            tok = int(torch.argmax(logits[0]))
            req.generated.append(tok)
            self.prefills += 1
            self._count_token(req)
            req.first_token_s = time.perf_counter()
            self.caches = self._insert(self.caches, one_cache, slot)
            self.slots.lengths[slot] = len(req.prompt) + 1
            self.active[slot] = req

    def step(self) -> int:
        """One engine tick: admit + one batched decode. Returns number of
        active requests after the tick."""
        self._admit()
        self.ticks += 1
        if not self.active:
            return 0
        n_slots = self.slots.n_slots
        tokens = np.zeros((n_slots, 1), np.int32)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.generated[-1]
        logits, self.caches = self._decode(
            self.params, torch.as_tensor(tokens, device=self.device),
            self.caches)
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        done_slots = []
        for slot, req in self.active.items():
            tok = int(next_tokens[slot])
            req.generated.append(tok)
            self._count_token(req)
            self.slots.advance(slot)
            if (len(req.generated) >= req.max_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self.slots.lengths[slot] >= self.max_seq - 1):
                req.finished_s = time.perf_counter()
                done_slots.append(slot)
        for slot in done_slots:
            req = self.active.pop(slot)
            self._observe_finish(req)
            self.finished.append(req)
            self.slots.free(slot)
        return len(self.active)

    def _count_token(self, req: Request) -> None:
        self.tokens_generated += 1
        tenant = self._tenant_of.get(req.request_id, "default")
        self._t_tokens[tenant] = self._t_tokens.get(tenant, 0) + 1

    def _observe_finish(self, req: Request) -> None:
        """Land the request's latency stamps in the ``serve#N``
        histograms (TTFT / per-output-token / end-to-end)."""
        n_gen = max(1, len(req.generated) - 1)
        self._h_ttft.observe((req.first_token_s - req.submitted_s) * 1e3)
        self._h_e2e.observe((req.finished_s - req.submitted_s) * 1e3)
        self._h_tpot.observe(
            (req.finished_s - req.first_token_s) * 1e3 / n_gen)

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and not self.active:
                break
            self.step()
        return self.finished

    # -- telemetry ----------------------------------------------------------
    def telemetry(self) -> Dict[str, object]:
        """Serving counters, latency histograms and per-tenant totals."""
        return {
            "ticks": self.ticks,
            "prefills": self.prefills,
            "tokens_generated": self.tokens_generated,
            "queued": len(self.queue),
            "active": len(self.active),
            "finished": len(self.finished),
            "slot_utilization": self.slots.utilization(),
            "latency": {
                name: {"count": h.count, "mean": round(h.mean, 6),
                       "p50": h.percentile(50), "p95": h.percentile(95),
                       "p99": h.percentile(99)}
                for name, h in (("ttft_ms", self._h_ttft),
                                ("tpot_ms", self._h_tpot),
                                ("e2e_ms", self._h_e2e))},
            "tenants": {"requests": dict(self._t_requests),
                        "tokens": dict(self._t_tokens)},
        }
