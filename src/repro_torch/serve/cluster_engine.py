"""Multi-tenant serving plane over the cluster runtime.

Two engines share one front-door discipline (admission → bounded queue
→ dispatch → per-tenant accounting in the ``serve#N`` metrics scope):

* :class:`ClusterServeEngine` — serves *compiled kernels*. Concurrent
  callers submit ``(tenant, kernel, args)``; a *coalescer* merges
  same-kernel, same-signature requests that arrive within a short
  window into one stacked call — the batch axis is the kernel's pfor
  axis, so N requests of ``k`` rows each become one ``N·k``-row pfor:
  bigger chunks, one ship/dispatch/gather round amortized across
  callers. Results are split back per request by row offsets. When
  coalescing is illegal (shape/shared-arg mismatch, no
  :class:`BatchSpec`) or the window closes empty, the request falls
  through to plain per-request dispatch — never wrong, just unbatched.

* :class:`ClusterLMEngine` — LM serving on the fleet: the
  continuous-batching decode loop of
  :class:`repro_torch.serve.engine.ServeEngine`, with params + KV caches
  living in a *worker's* object store (:mod:`repro_torch.serve.remote_lm`)
  and computed on that worker's device, instead of the head process.
  Each tick ships one small token vector each way; the state chain is
  lineage-tracked, so a worker SIGKILL mid-decode replays from the last
  anchor and every accepted request still gets the exact tokens it
  would have gotten — bitwise equal to the single-process engine.

Queue depth is exported for :class:`repro_torch.runtime.elastic.ElasticController`
(``depth_fn=engine.queue_depth``), closing the loop: load → queue →
fleet size.
"""

from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

from . import remote_lm
from .admission import AdmissionController, AdmissionError
from .kvcache import SlotMap
from .request import Request

__all__ = ["BatchSpec", "ServeTicket", "ClusterServeEngine",
           "ClusterLMEngine", "LMTicket"]


@dataclass(frozen=True)
class BatchSpec:
    """How a kernel's signature stacks across coalesced requests.

    ``stacked`` args concatenate along axis 0 (the pfor axis);
    ``count`` names the scalar that equals their leading dim;
    ``out`` are the written outputs (a subset of ``stacked``) split
    back per request; ``shared`` args must match across requests for a
    merge to be legal (they ride once, from the first request)."""

    stacked: Tuple[str, ...]
    count: str
    out: Tuple[str, ...]
    shared: Tuple[str, ...] = ()


class ServeTicket:
    """Handle returned by :meth:`ClusterServeEngine.submit`."""

    def __init__(self, tenant: str, kernel: str, args: Tuple[Any, ...]):
        self.tenant = tenant
        self.kernel = kernel
        self.args = args
        self.submitted_s = time.perf_counter()
        self.started_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.coalesced = False
        self.batch_size = 1
        self._key: Optional[tuple] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = 60.0):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"serve ticket ({self.kernel}, tenant {self.tenant}) "
                f"not fulfilled after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class _KernelRec:
    __slots__ = ("name", "fn", "batch", "params", "remote")

    def __init__(self, name: str, fn: Callable,
                 batch: Optional[BatchSpec], remote: bool):
        self.name = name
        self.fn = fn
        self.batch = batch
        self.remote = remote
        if hasattr(fn, "params"):          # CompiledKernel
            self.params = [n for n, _ in fn.params]
        else:
            self.params = list(inspect.signature(fn).parameters)
        if batch is not None:
            known = set(self.params)
            for p in (*batch.stacked, batch.count, *batch.out,
                      *batch.shared):
                if p not in known:
                    raise ValueError(
                        f"BatchSpec names unknown param {p!r} of "
                        f"kernel {name!r} (params: {self.params})")
            if remote:
                raise ValueError(
                    "remote kernels use the return-value convention; "
                    "BatchSpec's written-output splitting needs the "
                    "caller's arrays in-process")


def _fingerprint(v: Any):
    """Equality token for a shared arg (content, not identity)."""
    if isinstance(v, np.ndarray):
        return ("nd", v.shape, str(v.dtype), hash(v.tobytes()))
    return ("v", v)


class ClusterServeEngine:
    """Multi-tenant kernel front-end: admission → coalescing window →
    one stacked dispatch (or per-request fall-through).

    ``rt`` (a :class:`repro_torch.distrib.cluster.ClusterRuntime`) is
    optional: compiled kernels carry their own runtime binding via
    ``pfor_config``, and plain callables run in-process unless
    registered ``remote=True`` (then they ship via ``rt.submit`` /
    ``rt.submit_batch``). ``coalesce_window_s=0`` disables merging —
    the naive baseline the benchmark compares against."""

    requests = obs.MetricAttr("requests")
    rejections = obs.MetricAttr("rejections")
    coalesced_batches = obs.MetricAttr("coalesced_batches")
    coalesced_requests = obs.MetricAttr("coalesced_requests")
    fallthrough_dispatches = obs.MetricAttr("fallthrough_dispatches")

    def __init__(self, rt=None, *,
                 admission: Optional[AdmissionController] = None,
                 coalesce_window_s: float = 0.004, max_batch: int = 16,
                 variant: str = "np"):
        self.rt = rt
        self.admission = admission or AdmissionController()
        self.coalesce_window_s = float(coalesce_window_s)
        self.max_batch = int(max_batch)
        self.variant = variant
        self._kernels: Dict[str, _KernelRec] = {}
        self._queue: List[ServeTicket] = []
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._mscope = obs.metrics.unique_scope("serve")
        self._h_e2e = self._mscope.histogram("e2e_ms")
        self._h_queue = self._mscope.histogram("queue_ms")
        self._t_requests = self._mscope.dictmetric("tenant_requests")
        self._t_rejections = self._mscope.dictmetric("tenant_rejections")
        self._t_tokens = self._mscope.dictmetric("tenant_tokens")
        self.requests = 0
        self.rejections = 0
        self.coalesced_batches = 0
        self.coalesced_requests = 0
        self.fallthrough_dispatches = 0

    # -- registration -------------------------------------------------------
    def register(self, name: str, fn: Callable, *,
                 batch: Optional[BatchSpec] = None,
                 remote: bool = False) -> None:
        if remote and self.rt is None:
            raise ValueError(f"kernel {name!r}: remote=True needs rt")
        self._kernels[name] = _KernelRec(name, fn, batch, remote)

    # -- submission ---------------------------------------------------------
    def _coalesce_key(self, rec: _KernelRec,
                      args: Tuple[Any, ...]) -> Optional[tuple]:
        """Signature under which requests may merge; ``None`` marks the
        request per-request-only (no BatchSpec, or stacking illegal)."""
        b = rec.batch
        if b is None or self.coalesce_window_s <= 0:
            return None
        idx = {p: i for i, p in enumerate(rec.params)}
        try:
            count = int(args[idx[b.count]])
        except (TypeError, ValueError):
            return None
        parts: List[tuple] = [("k", rec.name)]
        for p in (*b.stacked, *b.out):
            a = args[idx[p]]
            if not isinstance(a, np.ndarray) or a.ndim < 1 \
                    or a.shape[0] != count:
                return None     # not row-stackable → fall through
            parts.append(("s", p, a.shape[1:], str(a.dtype)))
        for p in b.shared:
            parts.append(("h", p, _fingerprint(args[idx[p]])))
        return tuple(parts)

    def submit(self, tenant: str, kernel: str,
               args: Sequence[Any]) -> ServeTicket:
        """Admit + enqueue one request; raises
        :class:`~repro_torch.serve.admission.AdmissionError` on rejection."""
        rec = self._kernels[kernel]
        try:
            self.admission.admit(tenant)
        except AdmissionError:
            self.rejections += 1
            self._t_rejections[tenant] = \
                self._t_rejections.get(tenant, 0) + 1
            raise
        tk = ServeTicket(tenant, kernel, tuple(args))
        tk._key = self._coalesce_key(rec, tk.args)
        with self._cond:
            self._queue.append(tk)
            self._cond.notify_all()
        self._ensure_dispatcher()
        return tk

    def queue_depth(self) -> int:
        """Requests admitted but not yet dispatched (what the elastic
        controller scales the fleet on)."""
        with self._cond:
            return len(self._queue)

    # -- dispatch loop ------------------------------------------------------
    def _ensure_dispatcher(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            with self._cond:
                if self._thread is None or not self._thread.is_alive():
                    self._stop = False
                    self._thread = threading.Thread(
                        target=self._dispatch_loop, daemon=True,
                        name="serve-dispatch")
                    self._thread.start()

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.05)
                if self._stop and not self._queue:
                    return
                head = self._queue.pop(0)
                self.admission.dequeued()
            group = [head]
            if head._key is not None:
                self._fill_window(head._key, group)
            self._execute(group)

    def _fill_window(self, key: tuple, group: List[ServeTicket]) -> None:
        """Collect same-key requests until the window closes or the
        batch fills; the window is measured from the head pop, so a
        backlogged queue coalesces without adding idle latency."""
        deadline = time.perf_counter() + self.coalesce_window_s
        while len(group) < self.max_batch:
            with self._cond:
                hit = next((i for i, t in enumerate(self._queue)
                            if t._key == key), None)
                if hit is not None:
                    group.append(self._queue.pop(hit))
                    self.admission.dequeued()
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return
                self._cond.wait(remaining)

    # -- execution ----------------------------------------------------------
    def _call(self, rec: _KernelRec, args: Tuple[Any, ...]) -> Any:
        fn = rec.fn
        if hasattr(fn, "call_variant"):
            return fn.call_variant(self.variant, *args)
        return fn(*args)

    def _written(self, rec: _KernelRec, args: Tuple[Any, ...]):
        idx = {p: i for i, p in enumerate(rec.params)}
        outs = tuple(args[idx[p]] for p in rec.batch.out)
        return outs[0] if len(outs) == 1 else outs

    def _execute(self, group: List[ServeTicket]) -> None:
        rec = self._kernels[group[0].kernel]
        now = time.perf_counter()
        for tk in group:
            tk.started_s = now
        try:
            if len(group) > 1:
                self._run_coalesced(rec, group)
            else:
                self._run_single(rec, group[0])
        except BaseException as e:                # noqa: BLE001
            for tk in group:
                tk.error = e
        finally:
            done = time.perf_counter()
            for tk in group:
                tk.finished_s = done
                self.admission.release(tk.tenant)
                self.requests += 1
                self._t_requests[tk.tenant] = \
                    self._t_requests.get(tk.tenant, 0) + 1
                self._h_e2e.observe((done - tk.submitted_s) * 1e3)
                self._h_queue.observe(
                    (tk.started_s - tk.submitted_s) * 1e3)
                tk._event.set()

    def _run_single(self, rec: _KernelRec, tk: ServeTicket) -> None:
        self.fallthrough_dispatches += 1
        if rec.remote:
            ref = self.rt.submit(rec.fn, *tk.args)
            try:
                tk.result = self.rt.get(ref)
            finally:
                self.rt.release(ref)
            return
        ret = self._call(rec, tk.args)
        tk.result = (self._written(rec, tk.args)
                     if rec.batch is not None else ret)

    def _run_coalesced(self, rec: _KernelRec,
                       group: List[ServeTicket]) -> None:
        if rec.remote:      # plain callables batch via submit_batch
            refs = self.rt.submit_batch(rec.fn,
                                        [tk.args for tk in group])
            try:
                for tk, ref in zip(group, refs):
                    tk.result = self.rt.get(ref)
            finally:
                for ref in refs:
                    self.rt.release(ref)
            self._mark_coalesced(group)
            return
        b = rec.batch
        idx = {p: i for i, p in enumerate(rec.params)}
        counts = [int(tk.args[idx[b.count]]) for tk in group]
        offsets = np.concatenate(([0], np.cumsum(counts)))
        total = int(offsets[-1])
        stacked: Dict[str, np.ndarray] = {}
        merged: List[Any] = []
        for p in rec.params:
            if p in b.stacked or p in b.out:
                arr = np.concatenate(
                    [np.asarray(tk.args[idx[p]]) for tk in group],
                    axis=0)
                stacked[p] = arr
                merged.append(arr)
            elif p == b.count:
                merged.append(total)
            else:
                merged.append(group[0].args[idx[p]])
        self._call(rec, tuple(merged))
        for p in b.out:
            big = stacked[p]
            for k, tk in enumerate(group):
                lo, hi = int(offsets[k]), int(offsets[k + 1])
                np.copyto(tk.args[idx[p]], big[lo:hi])
        for tk in group:
            tk.result = self._written(rec, tk.args)
        self._mark_coalesced(group)

    def _mark_coalesced(self, group: List[ServeTicket]) -> None:
        self.coalesced_batches += 1
        self.coalesced_requests += len(group)
        for tk in group:
            tk.coalesced = True
            tk.batch_size = len(group)

    # -- lifecycle / telemetry ----------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, then stop the dispatcher."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _latency(h) -> Dict[str, Any]:
        return {"count": h.count, "mean": round(h.mean, 6),
                "p50": h.percentile(50), "p95": h.percentile(95),
                "p99": h.percentile(99)}

    def telemetry(self) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "rejections": self.rejections,
            "queued": self.queue_depth(),
            "coalesced_batches": self.coalesced_batches,
            "coalesced_requests": self.coalesced_requests,
            "fallthrough_dispatches": self.fallthrough_dispatches,
            "e2e_ms": self._latency(self._h_e2e),
            "queue_ms": self._latency(self._h_queue),
            "tenants": {
                "requests": dict(self._t_requests),
                "rejections": dict(self._t_rejections),
                "tokens": dict(self._t_tokens),
            },
            "admission": self.admission.telemetry(),
        }


class LMTicket:
    """Per-request handle for :class:`ClusterLMEngine` — duck-typed
    against :class:`ServeTicket` so one load generator drives both."""

    def __init__(self, tenant: str, req: Request):
        self.tenant = tenant
        self.request = req
        self.submitted_s = req.submitted_s
        self.started_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = 60.0) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"LM request {self.request.request_id} not finished "
                f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.request.generated


class ClusterLMEngine:
    """The seed continuous-batching LM decode loop, state-on-a-worker.

    Params + KV caches boot once into a worker's object store
    (:func:`repro_torch.serve.remote_lm.lm_boot`) and compute on that
    worker's device; each tick ships one small token vector each way. The state chain is lineage-tracked: every
    ``trim_every`` ticks the engine pulls the state to the head,
    re-anchors it as a fresh lineage root, and releases the old chain —
    head memory stays flat while worker loss anywhere in the window
    replays transitively from the last anchor. Token streams are
    bitwise-identical to :class:`repro_torch.serve.engine.ServeEngine`
    on the same prompts (same ops, same order, explicit model dtypes).

    The cluster must use ``start_method="spawn"``: a head that has used
    the card holds a CUDA context, which a forked child cannot use, and
    a CUDA head is never forked.
    """

    ticks = obs.MetricAttr("ticks")
    prefills = obs.MetricAttr("prefills")
    tokens_generated = obs.MetricAttr("tokens_generated")
    anchors = obs.MetricAttr("anchors")

    def __init__(self, rt, params, cfg, *, n_slots: int = 4,
                 max_seq: int = 256, trim_every: int = 32,
                 admission: Optional[AdmissionController] = None,
                 op_timeout_s: float = 180.0):
        if getattr(rt, "start_method", "spawn") == "fork":
            raise ValueError(
                "ClusterLMEngine needs a spawn-started fleet: a head that "
                "has used the card holds a CUDA context, which forked "
                "workers would inherit and cannot use (pass "
                "start_method='spawn')")
        self.rt = rt
        self.cfg = cfg
        self.max_seq = max_seq
        self.trim_every = int(trim_every)
        self.op_timeout_s = op_timeout_s
        self.admission = admission
        self.slots = SlotMap(n_slots)
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self._mscope = obs.metrics.unique_scope("serve")
        self._h_ttft = self._mscope.histogram("ttft_ms")
        self._h_tpot = self._mscope.histogram("tpot_ms")
        self._h_e2e = self._mscope.histogram("e2e_ms")
        self._t_requests = self._mscope.dictmetric("tenant_requests")
        self._t_rejections = self._mscope.dictmetric("tenant_rejections")
        self._t_tokens = self._mscope.dictmetric("tenant_tokens")
        self.ticks = 0
        self.prefills = 0
        self.tokens_generated = 0
        self.anchors = 0
        self._tenant_of: Dict[str, str] = {}
        self._tickets: Dict[str, LMTicket] = {}
        self._lock = threading.Lock()
        self._pump: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        self._state = rt.submit(remote_lm.lm_boot,
                                remote_lm.tree_np(params), cfg,
                                n_slots, max_seq)
        self._chain: List[Any] = []

    # -- state chain --------------------------------------------------------
    def _roll(self, fn, *args) -> np.ndarray:
        """Advance the worker-resident state by one op and fetch its
        small output. The superseded state ref stays alive (lineage for
        replay) until the next anchor trims the chain."""
        new_ref = self.rt.submit(fn, self._state, *args)
        self._chain.append(self._state)
        self._state = new_ref
        out_ref = self.rt.submit(remote_lm.lm_out, new_ref)
        try:
            return self.rt.get(out_ref, timeout=self.op_timeout_s)
        finally:
            self.rt.release(out_ref)

    def _maybe_trim(self) -> None:
        if len(self._chain) < self.trim_every:
            return
        value = self.rt.get(self._state, timeout=self.op_timeout_s)
        new_root = self.rt.submit(remote_lm.lm_anchor, value)
        old = self._chain + [self._state]
        self._state = new_root
        self._chain = []
        self.anchors += 1
        for ref in old:
            self.rt.release(ref)

    # -- ServeEngine-compatible API -----------------------------------------
    def add_request(self, req: Request, tenant: str = "default") -> None:
        if self.admission is not None:
            try:
                self.admission.admit(tenant)
            except AdmissionError:
                self._t_rejections[tenant] = \
                    self._t_rejections.get(tenant, 0) + 1
                raise
        self._tenant_of[req.request_id] = tenant
        self._t_requests[tenant] = self._t_requests.get(tenant, 0) + 1
        with self._lock:
            self.queue.append(req)

    def _admit(self) -> None:
        while True:
            with self._lock:
                if not self.queue:
                    return
                slot = self.slots.allocate(self.queue[0].request_id)
                if slot is None:
                    return
                req = self.queue.pop(0)
            req.slot = slot
            out = self._roll(remote_lm.lm_prefill,
                             np.asarray(req.prompt, np.int32), slot)
            req.generated.append(int(out[0]))
            self.prefills += 1
            self._count_token(req)
            req.first_token_s = time.perf_counter()
            tk = self._tickets.get(req.request_id)
            if tk is not None:
                tk.started_s = req.first_token_s
            self.slots.lengths[slot] = len(req.prompt) + 1
            self.active[slot] = req
            if self.admission is not None:
                self.admission.dequeued()

    def _count_token(self, req: Request) -> None:
        self.tokens_generated += 1
        tenant = self._tenant_of.get(req.request_id, "default")
        self._t_tokens[tenant] = self._t_tokens.get(tenant, 0) + 1

    def step(self) -> int:
        """One engine tick: admit + one batched decode on the worker-
        resident caches. Same semantics as ``ServeEngine.step``."""
        self._admit()
        self.ticks += 1
        if not self.active:
            return 0
        n_slots = self.slots.n_slots
        tokens = np.zeros((n_slots, 1), np.int32)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.generated[-1]
        next_tokens = self._roll(remote_lm.lm_decode, tokens)
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
            self._finish(self.active.pop(slot))
            self.slots.free(slot)
        self._maybe_trim()
        return len(self.active)

    def _finish(self, req: Request) -> None:
        self.finished.append(req)
        n_gen = max(1, len(req.generated) - 1)
        self._h_ttft.observe((req.first_token_s - req.submitted_s) * 1e3)
        self._h_e2e.observe((req.finished_s - req.submitted_s) * 1e3)
        self._h_tpot.observe(
            (req.finished_s - req.first_token_s) * 1e3 / n_gen)
        tenant = self._tenant_of.get(req.request_id, "default")
        if self.admission is not None:
            self.admission.release(tenant)
        tk = self._tickets.pop(req.request_id, None)
        if tk is not None:
            tk.finished_s = req.finished_s
            tk._event.set()

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            with self._lock:
                idle = not self.queue and not self.active
            if idle:
                break
            self.step()
        return self.finished

    # -- ticketed (threaded) API --------------------------------------------
    def submit(self, tenant: str, prompt: np.ndarray, *,
               max_tokens: int = 16, eos_id: Optional[int] = None,
               request_id: Optional[str] = None) -> LMTicket:
        """Concurrent front door: enqueue one request and return a
        ticket; a background pump thread drives :meth:`step` while work
        remains. Raises :class:`AdmissionError` when rejected."""
        rid = request_id or f"req-{len(self._tenant_of)}"
        req = Request(rid, np.asarray(prompt, np.int32),
                      max_tokens=max_tokens, eos_id=eos_id)
        tk = LMTicket(tenant, req)
        self._tickets[rid] = tk
        try:
            self.add_request(req, tenant)
        except AdmissionError:
            self._tickets.pop(rid, None)
            raise
        self._ensure_pump()
        return tk

    def queue_depth(self) -> int:
        with self._lock:
            return len(self.queue)

    def _ensure_pump(self) -> None:
        if self._pump is None or not self._pump.is_alive():
            self._pump_stop.clear()
            self._pump = threading.Thread(target=self._pump_loop,
                                          daemon=True, name="serve-lm")
            self._pump.start()

    def _pump_loop(self) -> None:
        idle_ticks = 0
        while not self._pump_stop.is_set():
            with self._lock:
                busy = bool(self.queue) or bool(self.active)
            if busy or self.active:
                self.step()
                idle_ticks = 0
            else:
                idle_ticks += 1
                if idle_ticks > 200:    # ~1 s of quiet: park the pump
                    return
                time.sleep(0.005)

    def close(self) -> None:
        self._pump_stop.set()
        if self._pump is not None:
            self._pump.join(5.0)
        for ref in self._chain + [self._state]:
            try:
                self.rt.release(ref)
            except Exception:       # noqa: BLE001 — fleet may be gone
                pass
        self._chain = []

    def telemetry(self) -> Dict[str, Any]:
        out = {
            "ticks": self.ticks,
            "prefills": self.prefills,
            "tokens_generated": self.tokens_generated,
            "anchors": self.anchors,
            "queued": self.queue_depth(),
            "active": len(self.active),
            "finished": len(self.finished),
            "slot_utilization": self.slots.utilization(),
            "latency": {
                "ttft_ms": ClusterServeEngine._latency(self._h_ttft),
                "tpot_ms": ClusterServeEngine._latency(self._h_tpot),
                "e2e_ms": ClusterServeEngine._latency(self._h_e2e),
            },
            "tenants": {
                "requests": dict(self._t_requests),
                "rejections": dict(self._t_rejections),
                "tokens": dict(self._t_tokens),
            },
        }
        if self.admission is not None:
            out["admission"] = self.admission.telemetry()
        return out
