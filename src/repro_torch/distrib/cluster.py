"""ClusterRuntime: head scheduler over spawned worker processes.

The multi-process generalization of the reference package's
:class:`repro.runtime.tasks.TaskRuntime` (raylite, not ported). Same
duck-typed surface the compiled kernels use — ``submit`` / ``get`` /
``wait`` / ``stats`` — plus the ``pfor_shards`` protocol
:mod:`repro_torch.core.pfor` dispatches to when its runtime crosses
process boundaries:

  * workers are real OS processes (``multiprocessing`` transport, fork
    or spawn), each reporting a measured :class:`DeviceProfile`;
  * placement goes through :class:`PlacementScheduler` — capability +
    data-locality − load — and pfor chunks are sized proportional to
    each worker's measured GFLOP/s (heterogeneous fleets get uneven,
    balanced-by-time chunks);
  * the object plane keeps results where they were produced and moves
    them on demand; every task's serialized spec is its lineage record,
    so objects lost to a worker-process death are replayed on the
    survivors (``kill_worker`` + ``get`` is the recovery drill);
  * data movement is slice-aware: arrays the schedule proves are indexed
    only by the pfor var on their leading axis ship as per-chunk row
    slices (``payload / n_workers`` each) instead of broadcasting, and
    pfor bodies persist on the workers under content-addressed blob ids
    so a serving loop re-ships only the cells that changed
    (``sliced_args`` / ``blob_hits`` / ``cells_skipped`` telemetry);
  * ``cache_dir`` points the runtime at a (shareable) variant-cache
    directory so a fleet of runtimes warm-starts compilation from one
    store (:meth:`compile`).

``device`` says where the workers' kernel runtime computes. The default
``"cuda"`` needs a CUDA device: the head raises without one, builds the
hand-written kernel library once (under a file lock) before any worker
starts, and spawns the workers, since a forked child cannot initialise
CUDA. ``device="cpu"`` runs the kernels' plain torch versions instead
(the CPU tests).
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import multiprocessing as mp
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

from repro_torch.core import backends as backends_mod

from .accel import WIRE_STAT_KEYS as accel_wire_stat_keys
from .chaos import ChaosPlan, ChaosWire
from .device import DeviceProfile, measure_profile, sim_gpu_for
from .objects import (HEAD, LOST, REMOTE, ClusterRef, ObjectPlane,
                      TaskSpec)
from .placement import PlacementScheduler, PlacementWeights, WorkerView
from .serial import (ClosureParts, closure_arrays, dumps_fn,
                     split_fn_variants)
from .transport import HeadListener

log = logging.getLogger("repro_torch.distrib")

# worker errors carrying this marker mean "I don't hold that body blob"
# (a dropped/evicted blob message): the head resets its shipped-state
# bookkeeping for the worker so the resubmit re-ships in full
BLOB_MISSING = "blob-missing"

# worker errors carrying this marker mean "I don't hold chunk rows you
# told me to keep" (restarted worker / dropped rows cache): the head
# forgets its shipped-rows records for the worker so retries re-ship
ROWS_MISSING = "rows-missing"

# a cuda chunk error carrying this marker means "the kernel runtime
# refuses this lowering" (kernels/api.py, e.g. integer operands): the
# only cuda error that steps down to the np body on a CUDA fleet. Any
# other one is a kernel build/launch failure and fails the task.
CUDA_INFEASIBLE = "cuda-lowering-infeasible"


class ClusterTaskError(RuntimeError):
    pass


def _check_device(device: str) -> str:
    """The fleet's kernel device: ``"cpu"`` only when asked for, else a
    CUDA device that must exist — never a silent fall back to the CPU."""
    if device == "cpu":
        return device
    import torch

    if not str(device).startswith("cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"ClusterRuntime(device={device!r}) needs a CUDA device and "
            f"torch sees none; pass device='cpu' to run the kernels' "
            f"plain versions on the CPU")
    return device


@dataclass
class _BlobRec:
    """One persistent pfor-body identity: (code hash, cell struct sig) →
    a stable blob id the workers cache under. ``seq`` orders LRU
    eviction; per-worker shipped state lives on the worker handles (it
    must die with them)."""

    bid: int
    key: tuple
    seq: int = 0
    # latest ClosureParts seen for this identity, kept so a joining or
    # respawned worker can be pre-warmed with the serving loop's hot
    # bodies (bounded by the blob cache's LRU cap)
    parts: Optional[ClosureParts] = None


@dataclass
class _TaskErr:
    message: str
    traceback: str = ""

    def __str__(self) -> str:
        return self.message


@dataclass
class _TaskState:
    spec: TaskSpec
    wid: Optional[int] = None
    finished: bool = False
    error: Optional[str] = None
    event: threading.Event = field(default_factory=threading.Event)
    # tracing: the in-flight span begun at dispatch (ended by whichever
    # thread observes completion — obs tokens are end-idempotent, so a
    # resubmit racing its own late "done" records the span once) and
    # the base args stamped onto this chunk's worker-side spans
    token: Any = None
    span_meta: Optional[Dict[str, Any]] = None
    # active liveness: optional wall deadline for each dispatch of this
    # task, monotonic stamp of the last dispatch, and the wids that have
    # already run (or hung on) it — deadline expiry resubmits elsewhere
    deadline_s: Optional[float] = None
    dispatched_at: Optional[float] = None
    tried: List[int] = field(default_factory=list)


class _WorkerHandle:
    def __init__(self, wid: int, proc, conn, sim_gpu: bool = False):
        self.wid = wid
        self.proc = proc          # None for externally-joined workers
        self.conn = conn          # None while a TCP worker is attaching
        self.sim_gpu = sim_gpu   # respawns inherit the GPU pose
        self.profile: Optional[DeviceProfile] = None
        self.hello = threading.Event()
        # head_perf_counter − worker_perf_counter, estimated from the
        # t_mono stamps piggybacked on hello/pong replies (see
        # note_clock); None until the first stamped reply lands
        self.clock_offset: Optional[float] = None
        self.alive = True
        self.draining = False   # clean scale-down, not a failure
        self.drain_sent = False  # monitor sent the drain-shutdown once
        # liveness bookkeeping: monotonic stamp of the last message seen
        # from this worker (any kind — a busy worker's "done" counts as
        # proof of life), and — TCP only — the monotonic instant at
        # which a lost connection stops being "suspect, may reconnect"
        # and becomes a death
        self.last_msg = time.monotonic()
        self.suspect_deadline: Optional[float] = None
        self.no_grace = False   # heartbeat expiry: skip reconnect grace
        self.inflight: set = set()
        self.blobs: set = set()                    # bids with skeleton
        self.blob_cells: Dict[int, Dict[str, str]] = {}  # bid→cell→hash
        # (bid, name, lo, hi) → content hash of the chunk rows last
        # shipped there: a serving loop re-dispatching the same range
        # with unchanged rows sends a ("keep",) marker instead
        self.sliced_rows: Dict[tuple, str] = {}
        # the hello carrying a failed-GPU-probe reason is counted into
        # the faults scope once per worker, not once per re-profile
        self.gpu_probe_fault_counted = False
        # on a CUDA fleet: why this worker's GPU probe failed. Such a
        # worker gets no task (it cannot run a kernel, and running its
        # chunks on the CPU instead would hide the fault)
        self.gpu_error = ""
        self.send_lock = threading.Lock()

    def note_clock(self, t_worker: float) -> None:
        """Refine this worker's clock offset from one stamped reply.
        ``recv_time − t_worker`` over-estimates the true offset by
        exactly the reply's one-way latency, so the *minimum* across
        samples (startup hello, every profile/ping handshake) is the
        tightest estimate — error bounded by the best observed one-way
        trip, well inside the handshake RTT."""
        off = time.perf_counter() - t_worker
        if self.clock_offset is None or off < self.clock_offset:
            self.clock_offset = off

    def send(self, msg) -> None:
        with self.send_lock:
            if self.conn is None:
                raise OSError(f"worker {self.wid} not attached")
            try:
                self.conn.send(msg)
            except TypeError as exc:
                # mp.Connection.close() nulls its handle without a lock;
                # a send racing a concurrent close can reach os.write
                # with handle=None → "TypeError: 'NoneType' object
                # cannot be interpreted as an integer". The connection
                # is dead either way — surface it as the OSError every
                # caller already handles.
                raise OSError(f"connection closed under send: {exc}")

    def close_conn(self) -> None:
        """Close the link without racing an in-flight :meth:`send` (the
        lock serializes us behind it; later sends fail cleanly)."""
        with self.send_lock:
            if self.conn is None:
                return
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def forget_blobs(self) -> None:
        """Reset the shipped-state bookkeeping — the worker told us it
        does not hold a blob we think it has (a chaos-dropped blob
        message, or a reconnect after a worker-side restart). The next
        :meth:`ship_blob` re-sends skeleton + every cell."""
        with self.send_lock:
            self.blobs.clear()
            self.blob_cells.clear()
            self.sliced_rows.clear()

    def ship_blob(self, bid: int, parts: ClosureParts) -> "Tuple[int, int]":
        """Bring this worker's cached copy of blob ``bid`` up to date:
        skeleton if it never saw the body, plus exactly the broadcast
        cells whose content hash changed since the last ship. Atomic
        under the send lock so concurrent dispatchers of the same blob
        don't double-ship (and so the blob always precedes the task
        message that references it on the pipe). Returns
        ``(cells_shipped, bytes_shipped)``."""
        with self.send_lock:
            shipped = self.blob_cells.setdefault(bid, {})
            need_skel = bid not in self.blobs
            delta = {nm: pkl for nm, pkl in parts.cell_pkls.items()
                     if shipped.get(nm) != parts.cell_hashes[nm]}
            if not need_skel and not delta:
                return 0, 0
            if self.conn is None:
                raise OSError(f"worker {self.wid} not attached")
            skel = parts.skeleton if need_skel else None
            self.conn.send(("blob", bid, skel, delta))
            self.blobs.add(bid)
            for nm in delta:
                shipped[nm] = parts.cell_hashes[nm]
            return len(delta), (len(skel or b"")
                                + sum(len(p) for p in delta.values()))


class ClusterRuntime:
    """Head process of the multi-process cluster.

    Telemetry counters below are class-level :class:`obs.MetricAttr`
    descriptors: the attribute reads/writes every existing call site
    (and test) uses are unchanged, but the values live in the unified
    ``obs.metrics`` registry under this instance's ``cluster#N`` scope —
    one store for stats(), bench rows, and traces."""

    replays = obs.MetricAttr("replays")
    resubmits = obs.MetricAttr("resubmits")
    worker_deaths = obs.MetricAttr("worker_deaths")
    pfor_runs = obs.MetricAttr("pfor_runs")
    chunks_dispatched = obs.MetricAttr("chunks_dispatched")
    bytes_shipped = obs.MetricAttr("bytes_shipped")
    gpu_chunks = obs.MetricAttr("gpu_chunks")
    cpu_chunks = obs.MetricAttr("cpu_chunks")
    # chunks shipped with a cuda-lowered body, and chunks that fell
    # off the cuda step of a TaskSpec.alt degradation chain
    cuda_chunks = obs.MetricAttr("cuda_chunks")
    cuda_fallbacks = obs.MetricAttr("cuda_fallbacks")
    sliced_args = obs.MetricAttr("sliced_args")
    bytes_saved_sliced = obs.MetricAttr("bytes_saved_sliced")
    blob_hits = obs.MetricAttr("blob_hits")
    blob_misses = obs.MetricAttr("blob_misses")
    cells_shipped = obs.MetricAttr("cells_shipped")
    cells_skipped = obs.MetricAttr("cells_skipped")
    rows_skipped = obs.MetricAttr("rows_skipped")
    bytes_saved_rows = obs.MetricAttr("bytes_saved_rows")
    # worker-side accel counters, aggregated off chunk "done" messages
    resident_hits = obs.MetricAttr("resident_hits")
    resident_stages = obs.MetricAttr("resident_stages")
    resident_cells = obs.MetricAttr("resident_cells")
    cuda_calls = obs.MetricAttr("cuda_calls")
    cuda_plain_calls = obs.MetricAttr("cuda_plain_calls")
    # launches of each hand-written kernel, counted by its wrapper
    matmul_launches = obs.MetricAttr("matmul_launches")
    flash_attention_launches = obs.MetricAttr("flash_attention_launches")
    mamba_scan_launches = obs.MetricAttr("mamba_scan_launches")

    # keys of the per-chunk accel stats dict the head aggregates
    # (declared by the accel module so worker-side counters — residency,
    # kernel calls — stay a one-place change)
    _ACCEL_KEYS = accel_wire_stat_keys

    def __init__(self, workers: int = 2, *,
                 start_method: Optional[str] = None,
                 max_attempts: int = 3,
                 respawn: bool = True,
                 cache_dir: Optional[str] = None,
                 weights: PlacementWeights = PlacementWeights(),
                 hello_timeout_s: float = 30.0,
                 sim_gpu_workers: Sequence[int] = (),
                 trace=None,
                 transport: str = "pipe",
                 address: Tuple[str, int] = ("127.0.0.1", 0),
                 authkey: Optional[bytes] = None,
                 hb_interval_s: float = 1.0,
                 hb_miss_budget: int = 15,
                 reconnect_grace_s: float = 3.0,
                 task_deadline_s: Optional[float] = None,
                 quorum: int = 1,
                 degrade_local: Optional[bool] = None,
                 pipeline_depth: int = 2,
                 np_only: bool = False,
                 chaos: Optional[ChaosPlan] = None,
                 device: str = "cuda"):
        self.device = _check_device(device)
        if start_method is None:
            # A forked child cannot initialise CUDA, so CUDA fleets spawn
            # fresh interpreters; so do fleets with posing GPU workers,
            # whose twins run torch, which is not fork-safe once the head
            # has used its thread pool. CPU-only fleets keep the fast
            # fork default.
            gpu_possible = (self.device != "cpu" or bool(sim_gpu_workers)
                            or os.environ.get("REPRO_DISTRIB_SIM_GPU"))
            if gpu_possible:
                start_method = "spawn"
            else:
                start_method = ("fork"
                                if "fork" in mp.get_all_start_methods()
                                else "spawn")
        self._ctx = mp.get_context(start_method)
        self.start_method = start_method
        self.max_attempts = max_attempts
        self.respawn = respawn
        if transport not in ("pipe", "tcp"):
            raise ValueError(f"unknown transport {transport!r}")
        self.transport = transport
        self.hb_interval_s = hb_interval_s
        self.hb_miss_budget = hb_miss_budget
        self.reconnect_grace_s = reconnect_grace_s
        self.task_deadline_s = task_deadline_s
        self.quorum = max(1, quorum)
        # a failed chunk (or a fleet below quorum) runs in-process on the
        # head's CPU only on a device="cpu" fleet by default: on a CUDA
        # fleet it raises unless the caller opts in
        self.degrade_local = (self.device == "cpu" if degrade_local is None
                              else bool(degrade_local))
        # pfor pipelining: each worker's iteration share splits into
        # this many sub-chunks, gathered as-completed — ship(k+1) and
        # gather(k-1) overlap compute(k). Depth 1 restores the
        # one-chunk-per-worker synchronous round.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # np_only suppresses twin routing (every chunk runs the np
        # body) — the control arm for hetero speedup comparisons
        self.np_only = bool(np_only)
        self.chaos = chaos
        self.listener: Optional[HeadListener] = None
        self.address: Optional[Tuple[str, int]] = None
        # bounded journal of fault events (death/respawn/rejoin/replay/
        # degrade…) for the chaos-drill artifact beside BENCH_distrib
        self.fault_events: List[Dict[str, Any]] = []
        self._fenced_wids: set = set()
        self.plane = ObjectPlane()
        self.scheduler = PlacementScheduler(weights)
        self._lock = threading.Lock()
        self._handles: Dict[int, _WorkerHandle] = {}
        self._tasks: Dict[int, _TaskState] = {}
        self._producer: Dict[int, int] = {}     # oid → producing task
        self._task_ids = itertools.count(1)
        self._wids = itertools.count(0)
        self._blob_ids = itertools.count(1)
        # persistent body-blob identities: a serving loop calling the
        # same compiled kernel re-ships only changed cells, never the
        # skeleton (LRU-capped; per-worker shipped state is on handles)
        self._blob_cache: Dict[tuple, _BlobRec] = {}
        self._blob_seq = itertools.count(1)
        self.max_cached_blobs = 32
        self._fetch_events: Dict[int, threading.Event] = {}
        self._pongs: Dict[int, "threading.Event"] = {}
        self._shutdown = False
        # tracing: ``trace`` is False/None (off unless REPRO_TRACE=1),
        # True, or a path — a path additionally exports the Chrome
        # trace there at shutdown
        self._trace_path = trace if isinstance(trace, str) else None
        if trace:
            obs.enable()
        self.trace = obs.enabled() if trace is None else bool(trace)
        # unified metrics: this runtime's scope in the obs registry; the
        # MetricAttr class descriptors above resolve against it, so it
        # must exist before the zeroing assignments below
        self._mscope = obs.metrics.unique_scope("cluster")
        self._phase = self._mscope.sub("phase")
        # fault-event counters (cluster#N.faults.*): every recovery path
        # increments here so drills/CI can assert "recovery happened"
        self._faults = self._mscope.sub("faults")
        self._round_seq = itertools.count()
        self._round_busy: Dict[int, float] = {}     # round → worker-busy s
        self._round_compute: Dict[int, float] = {}  # round → Σ run-span s
        # telemetry
        self.replays = 0
        self.resubmits = 0
        self.worker_deaths = 0
        self.pfor_runs = 0
        self.chunks_dispatched = 0
        self.bytes_shipped = 0
        # heterogeneous routing telemetry: chunks dispatched per chosen
        # body backend, per-pfor-body backend mix, and — the ground
        # truth — chunks whose "done" message confirmed execution per
        # backend (dispatch intent can be overtaken by an error-path
        # downgrade)
        self.gpu_chunks = 0            # chunks dispatched on a twin
        self.cpu_chunks = 0            # chunks dispatched on the np body
        self.unit_backend = self._mscope.dictmetric("unit_backend")
        self.chunks_executed = self._mscope.dictmetric("chunks_executed")
        # rebalance visibility: chunks confirmed executed per worker id —
        # a mid-loop join shows up as a new key accumulating its
        # capability-proportional share
        self.chunks_executed_by_worker = \
            self._mscope.dictmetric("chunks_executed_by_worker")
        # data-movement telemetry (chunk slicing + blob cache)
        self.sliced_args = 0           # array args shipped as row slices
        self.bytes_saved_sliced = 0    # vs shipping each chunk the whole
        self.blob_hits = 0             # pfor calls reusing a cached body
        self.blob_misses = 0
        self.cells_shipped = 0         # broadcast cells actually sent
        self.cells_skipped = 0         # unchanged cells NOT re-sent
        self.rows_skipped = 0          # sliced chunk rows NOT re-sent
        self.bytes_saved_rows = 0      # vs re-shipping them every round
        # device-acceleration telemetry (worker accel counters riding
        # back on chunk "done" messages)
        self.resident_hits = 0         # device arrays reused in place
        self.resident_stages = 0       # host→device stagings performed
        self.resident_cells = 0        # distinct arrays made resident
        # head-local capability (the "stay local" side of profitability)
        # (the head runs np bodies only: its profile is the host's)
        self.local_profile = measure_profile(-1, device="cpu")
        self.variant_cache = None
        if cache_dir is not None:
            from repro_torch.profiler.cache import VariantCache
            self.variant_cache = VariantCache(cache_dir)
        if transport == "tcp":
            self.listener = HeadListener(address, authkey=authkey)
            self.address = self.listener.address
            threading.Thread(target=self._accept_loop,
                             name="cluster-accept", daemon=True).start()
        if self.device != "cpu":
            # built here, once, before any worker starts: spawned
            # workers only load the library (two compiling at once
            # would race on the build directory)
            from ..kernels import api as kernel_api
            kernel_api.build()
        sim_set = set(sim_gpu_workers)
        for i in range(workers):
            self._spawn_worker(sim_gpu=i in sim_set)
        self._await_hellos(hello_timeout_s)
        self._reprofile_sequentially()
        self._measure_transport()
        # liveness + deadline monitor (no-op work on an idle pipe fleet)
        threading.Thread(target=self._monitor_loop,
                         name="cluster-monitor", daemon=True).start()

    # -- worker lifecycle -------------------------------------------------
    def _fault_event(self, kind: str, **detail) -> None:
        """Count one fault/recovery event (``cluster#N.faults.<kind>``)
        and journal it (bounded) for the chaos-drill artifact."""
        self._faults.inc(kind, 1)
        ev = {"t": time.monotonic(), "kind": kind}
        ev.update(detail)
        with self._lock:
            self.fault_events.append(ev)
            if len(self.fault_events) > 4096:
                del self.fault_events[:2048]

    def _spawn_worker(self, sim_gpu: bool = False) -> _WorkerHandle:
        from .worker import worker_main
        wid = next(self._wids)
        # resolve the env-var pose here (not in the worker): a respawn
        # gets a fresh wid that would no longer match the env wid list,
        # and the replacement must inherit its predecessor's pose
        sim_gpu = sim_gpu or sim_gpu_for(wid)
        hb_read = hb_write = None
        if self.transport == "tcp":
            # the child dials back in over the socket; its handle has no
            # conn until the accept loop attaches it
            endpoint = ("tcp", self.address, self.listener.authkey)
            head_conn = None
        else:
            head_conn, worker_conn = self._ctx.Pipe(duplex=True)
            endpoint = worker_conn
            if self.hb_interval_s > 0:
                # heartbeats get a pipe of their own: on the task pipe
                # they would queue behind a large result (a full-size
                # chunk's updates take seconds to cross), and the head
                # would count a busy worker's silence as a hang
                hb_read, hb_write = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(
            target=worker_main,
            args=(endpoint, wid, sim_gpu, self.hb_interval_s, self.device,
                  hb_write),
            name=f"cluster-worker-{wid}", daemon=True)
        proc.start()
        if self.transport != "tcp":
            worker_conn.close()  # child's end lives in the child now
            if hb_write is not None:
                hb_write.close()
            head_conn = self._wrap_chaos(head_conn, wid)
        wh = _WorkerHandle(wid, proc, head_conn, sim_gpu=sim_gpu)
        with self._lock:
            self._handles[wid] = wh
        if self.transport == "tcp":
            # give the dial-in the same grace a reconnect would get
            wh.suspect_deadline = time.monotonic() + max(
                self.reconnect_grace_s, 10.0)
        else:
            t = threading.Thread(target=self._recv_loop, args=(wh, head_conn),
                                 name=f"cluster-recv-{wid}", daemon=True)
            t.start()
        if hb_read is not None:
            threading.Thread(target=self._hb_loop, args=(wh, hb_read),
                             name=f"cluster-hb-{wid}", daemon=True).start()
        return wh

    def _wrap_chaos(self, conn, wid: int):
        if self.chaos is not None:
            return ChaosWire(conn, self.chaos, peer=wid)
        return conn

    def _attach_conn(self, wh: _WorkerHandle, conn,
                     rejoin: bool = False) -> None:
        """Bind an authenticated TCP connection to a worker handle and
        start its receiver. The welcome goes out before the handle sees
        the conn, so it is guaranteed to be the first head→worker
        message on the wire."""
        conn.send(("welcome", wh.wid))
        wire = self._wrap_chaos(conn, wh.wid)
        with wh.send_lock:
            old = wh.conn
            wh.conn = wire
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        with self._lock:
            wh.last_msg = time.monotonic()
            wh.suspect_deadline = None
        if rejoin:
            self._fault_event("rejoins", wid=wh.wid)
        threading.Thread(target=self._recv_loop, args=(wh, wire),
                         name=f"cluster-recv-{wh.wid}",
                         daemon=True).start()

    def _accept_loop(self) -> None:
        """TCP transport: authenticate and route every inbound
        connection — spawned workers attaching/reattaching under a known
        wid, or external workers joining for a fresh one."""
        while not self._shutdown:
            try:
                conn = self.listener.accept()
            except OSError:
                if self._shutdown:
                    return
                continue
            except Exception:
                # failed auth (counted by the listener) or a garbled
                # handshake — never the accept thread's death
                self._fault_event("auth_failures")
                continue
            try:
                if not conn.poll(10.0):
                    conn.close()
                    continue
                msg = conn.recv()
            except (EOFError, OSError):
                continue
            try:
                self._route_attach(conn, msg)
            except (EOFError, OSError):
                try:
                    conn.close()
                except OSError:
                    pass

    def _route_attach(self, conn, msg) -> None:
        kind = msg[0]
        if kind == "attach":
            wid = int(msg[1])
            attempts = int(msg[2]) if len(msg) > 2 else 0
            chaos = self.chaos
            with self._lock:
                wh = self._handles.get(wid)
                # a re-attach is any attach from a worker that already
                # completed its hello (a clean socket drop re-dials with
                # zero *failed* attempts, but it is still a rejoin)
                rejoin = (wh is not None
                          and (attempts > 0 or wh.hello.is_set()))
                fenced = (wid in self._fenced_wids
                          or (chaos is not None and rejoin
                              and wid in chaos.refuse_rejoin))
            if wh is None or not wh.alive or fenced:
                self._fault_event("fenced", wid=wid)
                conn.send(("denied", f"worker {wid} is fenced"))
                conn.close()
                return
            if attempts > 0:
                self._faults.inc("reconnect_attempts", attempts)
            self._attach_conn(wh, conn, rejoin=rejoin)
        elif kind == "join":
            sim_gpu = bool(msg[1]) if len(msg) > 1 else False
            wh = _WorkerHandle(next(self._wids), None, None,
                               sim_gpu=sim_gpu)
            with self._lock:
                self._handles[wh.wid] = wh
            self._attach_conn(wh, conn)
            self._fault_event("joins", wid=wh.wid)
            # capability + transport measurement happen on the caller's
            # add-worker path (or lazily via the hello profile for a
            # worker that joined on its own)
        else:
            conn.send(("denied", f"bad handshake {msg!r}"))
            conn.close()

    def _await_hellos(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            handles = list(self._handles.values())
        for wh in handles:
            if not wh.hello.wait(max(0.1, deadline - time.monotonic())):
                raise TimeoutError(
                    f"worker {wh.wid} never said hello")
        failed = [wh for wh in handles if wh.gpu_error]
        if failed:
            self.shutdown()
            raise RuntimeError(
                f"worker {failed[0].wid} on device {self.device!r} failed "
                f"its GPU probe: {failed[0].gpu_error}")

    def _reprofile_sequentially(self) -> None:
        """Startup hellos carry profiles measured while every worker was
        booting at once — on a small host they contend and under-report.
        Re-measure one worker at a time for honest capability weights."""
        with self._lock:
            handles = [wh for wh in self._handles.values() if wh.alive]
        for wh in handles:
            self._reprofile(wh)

    def _reprofile(self, wh: _WorkerHandle) -> None:
        wh.hello.clear()
        try:
            wh.send(("profile",))
        except OSError:
            return
        wh.hello.wait(10.0)

    def _measure_transport(self, nbytes: int = 1 << 20) -> None:
        with self._lock:
            handles = [wh for wh in self._handles.values() if wh.alive]
        for wh in handles:
            self._ping_transport(wh, nbytes)

    def _ping_transport(self, wh: _WorkerHandle,
                        nbytes: int = 1 << 20) -> None:
        payload = b"\0" * nbytes
        ev = threading.Event()
        self._pongs[wh.wid] = ev
        t0 = time.perf_counter()
        try:
            wh.send(("ping", payload))
        except OSError:
            self._pongs.pop(wh.wid, None)
            return
        if ev.wait(5.0) and wh.profile is not None:
            dt = max(1e-9, time.perf_counter() - t0)
            # the payload travels one way (the pong is a few bytes), so
            # dt covers ~nbytes of transfer plus one scheduling round
            # trip — credit nbytes/dt, a slight *under*estimate
            wh.profile.transport_mbs = round(nbytes / dt / 1e6, 1)
        self._pongs.pop(wh.wid, None)

    def _recv_loop(self, wh: _WorkerHandle, conn) -> None:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            except Exception:
                # e.g. TypeError when a concurrent close() nulled the
                # handle mid-read: any recv failure means the connection
                # is unusable — treat it as the worker's death, never as
                # a reason to crash the receiver thread
                break
            wh.last_msg = time.monotonic()
            try:
                self._handle(wh, msg)
            except Exception:
                # a malformed message must not kill the receiver — but
                # protocol corruption has to be visible, not swallowed
                self._faults.inc("malformed_msgs", 1)
                log.warning("malformed message from worker %d: %.120r",
                            wh.wid, msg)
        self._on_conn_lost(wh, conn)

    def _hb_loop(self, wh: _WorkerHandle, conn) -> None:
        """Receive one pipe worker's heartbeats (their own pipe). Only
        stamps liveness: the worker's death is the task pipe's to
        declare, so this loop just ends when the worker's end closes."""
        try:
            while True:
                t_worker = conn.recv()
                wh.last_msg = time.monotonic()
                wh.note_clock(t_worker)
        except (EOFError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _on_conn_lost(self, wh: _WorkerHandle, conn) -> None:
        """One receiver's connection died. On the pipe transport (or at
        shutdown/drain) that *is* the worker's death; on TCP the worker
        gets a reconnect grace window and becomes *suspect* — the
        monitor declares death only if the grace expires un-reattached."""
        with self._lock:
            stale = wh.conn is not None and wh.conn is not conn
        if stale:
            return   # a reattach already replaced this conn; old thread
        if (self.transport == "tcp" and not self._shutdown
                and not wh.draining and not wh.no_grace and wh.alive):
            with wh.send_lock:
                if wh.conn is conn:
                    wh.conn = None
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if wh.suspect_deadline is None:
                    wh.suspect_deadline = (time.monotonic()
                                           + self.reconnect_grace_s)
            self._fault_event("conn_lost", wid=wh.wid)
            return
        self._on_worker_death(wh)

    def _handle(self, wh: _WorkerHandle, msg) -> None:
        kind = msg[0]
        if kind == "hb":
            if len(msg) > 1:
                wh.note_clock(msg[1])
            return   # last_msg already stamped by the recv loop
        if kind == "hello":
            wh.profile = DeviceProfile.from_dict(msg[1])
            if len(msg) > 2:
                wh.note_clock(msg[2])
            reason = getattr(wh.profile, "gpu_probe_error", "")
            if reason and not wh.gpu_probe_fault_counted:
                # the probe failing silently is how the 0.006x hetero
                # regression hid: a "GPU" fleet quietly priced as CPUs
                wh.gpu_probe_fault_counted = True
                self._fault_event("gpu_probe_failures", wid=wh.wid,
                                  reason=reason)
                log.warning("worker %d GPU probe failed: %s",
                            wh.wid, reason)
            # a CUDA worker without a working card fails its hello: it is
            # handed no task until a later probe passes (see _views)
            wh.gpu_error = reason if self.device != "cpu" else ""
            wh.hello.set()
        elif kind == "done":
            _, tid, oid, nbytes, payload = msg[:5]
            ran = msg[5] if len(msg) > 5 else None
            wspans = msg[6] if len(msg) > 6 else None
            wstats = msg[7] if len(msg) > 7 else None
            if wstats:
                # worker accel counter deltas (jit cache, residency)
                # piggybacked on chunk dones — aggregate fleet-wide.
                # Duplicates are harmless here: the deltas were drained
                # on the worker, so a chaos-duplicated done carries {}
                for k in self._ACCEL_KEYS:
                    v = wstats.get(k)
                    if v:
                        setattr(self, k, getattr(self, k) + v)
            with self._lock:
                ts = self._tasks.get(tid)
                wh.inflight.discard(tid)
                # drop duplicates: a chaos-duplicated "done", or a slow
                # worker completing a task a deadline already resubmitted
                # elsewhere — counting (or fulfilling) twice would skew
                # telemetry and resurrect released objects
                if (ts is not None and ts.finished) \
                        or not self.plane.contains(oid):
                    return
                if ran is not None:
                    # what actually *executed* (vs the dispatch-intent
                    # gpu_chunks/cpu_chunks counters, which a mid-flight
                    # backend downgrade can overtake)
                    self.chunks_executed[ran] = \
                        self.chunks_executed.get(ran, 0) + 1
                    self.chunks_executed_by_worker[wh.wid] = \
                        self.chunks_executed_by_worker.get(wh.wid, 0) + 1
            if wspans and ts is not None and self.trace:
                # worker spans land *before* the result fulfills, so a
                # gather that returns has this chunk's busy seconds
                # already accumulated into its round
                self._ingest_worker_spans(wh, ts, ran, wspans)
            if payload is not None:
                self.plane.fulfill_inline(oid, payload[1])
            else:
                self.plane.fulfill_remote(oid, wh.wid, nbytes)
            if ts is not None:
                if ts.token is not None:
                    # park the in-flight span on the worker's track so
                    # the viewer nests the remote phases under it
                    ts.token.tid = obs.worker_tid(wh.wid)
                    obs.end(ts.token, wid=wh.wid, ran=ran)
                ts.finished = True
                ts.event.set()
        elif kind == "err":
            _, tid, message, tb = msg
            with self._lock:
                ts = self._tasks.get(tid)
                wh.inflight.discard(tid)
            if BLOB_MISSING in (message or ""):
                # the worker lacks a body blob we believe it holds (a
                # dropped/evicted blob message): reset its shipped-state
                # so the retry re-ships skeleton + cells in full
                wh.forget_blobs()
                self._fault_event("blob_missing", wid=wh.wid, task=tid)
            if ROWS_MISSING in (message or ""):
                # the worker lacks chunk rows our hash record says it
                # cached (restart/drop): forget the records so retries
                # re-ship rows in full
                with wh.send_lock:
                    wh.sliced_rows.clear()
                self._fault_event("rows_missing", wid=wh.wid, task=tid)
            if ts is None or ts.finished:
                return
            ts.spec.attempts += 1
            kernel_failed = self._kernel_failed(ts.spec, message or "")
            if kernel_failed:
                self._fault_event("cuda_kernel_errors", task=tid,
                                  wid=wh.wid)
                message = (f"cuda chunk failed on worker {wh.wid} of a "
                           f"{self.device!r} fleet (no CPU fallback "
                           f"there): {message}")
            if (ts.spec.attempts < self.max_attempts and not kernel_failed
                    and not self._shutdown):
                self._maybe_downgrade_backend(ts.spec, message or "")
                self.resubmits += 1
                self._fault_event("retries", task=tid, wid=wh.wid)
                threading.Thread(target=self._dispatch, args=(ts,),
                                 daemon=True).start()
            else:
                ts.error = message
                obs.end(ts.token, error=True)
                self.plane.fulfill_inline(ts.spec.out.oid,
                                          _TaskErr(message, tb))
                ts.finished = True
                ts.event.set()
        elif kind == "obj":
            _, oid, payload = msg
            if payload is not None:
                self.plane.promote(oid, payload[1])
                try:
                    # ownership moved here; the worker's copy would
                    # never be read again (the head now serves it)
                    wh.send(("free", oid))
                except OSError:
                    pass
            ev = self._fetch_events.pop(oid, None)
            if ev is not None:
                ev.set()
        elif kind == "pong":
            if len(msg) > 2:
                wh.note_clock(msg[2])
            ev = self._pongs.get(wh.wid)
            if ev is not None:
                ev.set()

    def _ingest_worker_spans(self, wh: _WorkerHandle, ts: _TaskState,
                             ran: Optional[str], wspans) -> None:
        """Land one task's worker-side spans on the head timeline. The
        worker measured them on its own monotonic clock; the handle's
        offset estimate re-bases them, and the per-round busy/compute
        accumulators behind the ``idle_s``/``compute_s`` phase metrics
        pick up their totals."""
        rec = obs.recorder()
        track = obs.worker_tid(wh.wid)
        rec.name_track(0, track, f"worker{wh.wid}")
        base: Dict[str, Any] = {"task": ts.spec.task_id, "wid": wh.wid}
        if ts.span_meta:
            base.update(ts.span_meta)
        if ran is not None:
            base["backend"] = ran
        busy = rec.record_external(wspans,
                                   offset=wh.clock_offset or 0.0,
                                   pid=0, tid=track, base_args=base)
        rid = (ts.span_meta or {}).get("round")
        if rid is None:
            return
        compute = sum(max(0.0, s[2] - s[1]) for s in wspans
                      if s[0] == "run")
        with self._lock:
            self._round_busy[rid] = \
                self._round_busy.get(rid, 0.0) + busy
            self._round_compute[rid] = \
                self._round_compute.get(rid, 0.0) + compute

    def _on_worker_death(self, wh: _WorkerHandle) -> None:
        with self._lock:
            if not wh.alive:
                return
            wh.alive = False
            self._handles.pop(wh.wid, None)
            inflight = list(wh.inflight)
            wh.inflight.clear()
            clean = self._shutdown or wh.draining
            self._fenced_wids.add(wh.wid)   # a dead wid never reattaches
        wh.close_conn()
        if clean:
            if wh.draining and not self._shutdown:
                # a drained worker may still own objects nobody fetched:
                # mark them LOST so lineage replays them on demand (the
                # monitor tries to pull them to the head *before* the
                # drain completes, making this the uncommon path)
                self.plane.mark_worker_lost(wh.wid)
                self._fault_event("drains", wid=wh.wid)
            return
        self.worker_deaths += 1
        self._fault_event("worker_deaths", wid=wh.wid)
        self.plane.mark_worker_lost(wh.wid)
        if self.respawn and wh.proc is not None:
            with obs.span("respawn", cat="fault", wid=wh.wid):
                nw = self._spawn_worker(sim_gpu=wh.sim_gpu)
                if nw.hello.wait(10.0):
                    # the boot-time probe may have contended with
                    # whatever killed its predecessor: re-measure like
                    # at startup so chunk weights and profitability
                    # stay honest
                    self._reprofile(nw)
                    self._ping_transport(nw)
                    self._prewarm_blobs(nw)
            self._fault_event("respawns", wid=nw.wid, replaced=wh.wid)
        # in-flight tasks died with the process: resubmit on survivors
        for tid in inflight:
            with self._lock:
                ts = self._tasks.get(tid)
            if ts is None or ts.finished:
                continue
            ts.spec.attempts += 1
            if ts.spec.attempts >= self.max_attempts:
                ts.error = f"worker {wh.wid} died; attempts exhausted"
                obs.end(ts.token, error=True)
                self.plane.fulfill_inline(ts.spec.out.oid,
                                          _TaskErr(ts.error))
                ts.finished = True
                ts.event.set()
                continue
            self.resubmits += 1
            threading.Thread(target=self._dispatch, args=(ts,),
                             daemon=True).start()

    # -- active liveness ---------------------------------------------------
    def _monitor_loop(self) -> None:
        """Periodic liveness sweep: reap suspects whose reconnect grace
        expired, declare heartbeat-silent workers dead, complete clean
        drains, and enforce per-task deadlines. Replaces the passive
        "recv failed ⇒ dead" model with an active one."""
        while not self._shutdown:
            time.sleep(0.1)
            if self._shutdown:
                return
            now = time.monotonic()
            with self._lock:
                handles = list(self._handles.values())
            hb_limit = (self.hb_interval_s * self.hb_miss_budget
                        if self.hb_interval_s > 0 else None)
            for wh in handles:
                if not wh.alive or self._shutdown:
                    continue
                if wh.suspect_deadline is not None:
                    if now > wh.suspect_deadline:
                        self._fault_event("reconnect_grace_expired",
                                          wid=wh.wid)
                        self._on_worker_death(wh)
                    continue
                if (hb_limit is not None and wh.conn is not None
                        and not wh.draining and wh.hello.is_set()
                        and now - wh.last_msg > hb_limit):
                    # silent past the miss budget: treat as dead even
                    # though the socket looks healthy (hung process) —
                    # no reconnect grace, its state is not trustworthy
                    wh.no_grace = True
                    self._fault_event("hb_expired", wid=wh.wid,
                                      age_s=round(now - wh.last_msg, 3))
                    # declare death here rather than via the recv loop:
                    # closing the fd does not wake a thread blocked in
                    # read() on it, and a hung-but-silent worker sends
                    # nothing that would (_on_worker_death is idempotent,
                    # so the receiver's eventual exit is a no-op)
                    wh.close_conn()
                    self._on_worker_death(wh)
                    continue
                if wh.draining and not wh.inflight and not wh.drain_sent:
                    wh.drain_sent = True
                    # pull its objects home while it is still live so
                    # the drain loses nothing (anything missed goes
                    # LOST and replays via lineage)
                    for oid in list(self.plane.resident_on(wh.wid)):
                        self._fetch(oid)
                    try:
                        wh.send(("shutdown",))
                    except OSError:
                        pass
            self._check_deadlines(now)

    def _forensic(self, ts: _TaskState) -> str:
        """One task's timeout forensics: id, attempt count, placement,
        and how stale its worker's last heartbeat is."""
        wid = ts.wid
        wh = self._handle_for(wid) if wid is not None else None
        if wh is not None:
            age = f"last heartbeat {time.monotonic() - wh.last_msg:.2f}s ago"
        elif wid is not None:
            age = "worker gone"
        else:
            age = "never dispatched"
        return (f"task {ts.spec.task_id} (kind={ts.spec.kind}, "
                f"attempt {ts.spec.attempts + 1}/{self.max_attempts}, "
                f"worker {wid}, {age})")

    def _timeout_forensics(self, ref: ClusterRef) -> str:
        with self._lock:
            tid = self._producer.get(ref.oid)
            ts = self._tasks.get(tid) if tid is not None else None
        if ts is None:
            return f"timed out waiting for {ref}"
        return f"timed out waiting for {ref}: {self._forensic(ts)}"

    def _check_deadlines(self, now: float) -> None:
        with self._lock:
            expired = []
            for ts in self._tasks.values():
                dl = (ts.deadline_s if ts.deadline_s is not None
                      else self.task_deadline_s)
                if dl is None or ts.finished or ts.dispatched_at is None:
                    continue
                if now - ts.dispatched_at > dl:
                    # claim this expiry (one per dispatch; _dispatch
                    # re-stamps on the resubmit). The hung worker keeps
                    # the tid in its inflight set on purpose: the load
                    # penalty steers placement away from it.
                    ts.dispatched_at = None
                    expired.append((ts, dl))
        for ts, dl in expired:
            forensic = self._forensic(ts)
            self._fault_event("deadline_expired", task=ts.spec.task_id,
                              wid=ts.wid, deadline_s=dl)
            log.warning("deadline expired: %s", forensic)
            ts.spec.attempts += 1
            if ts.spec.attempts < self.max_attempts and not self._shutdown:
                self.resubmits += 1
                self._fault_event("retries", task=ts.spec.task_id,
                                  wid=ts.wid)
                threading.Thread(target=self._dispatch, args=(ts,),
                                 daemon=True).start()
            else:
                ts.error = (f"missed its {dl}s deadline and exhausted "
                            f"the retry budget: {forensic}")
                obs.end(ts.token, error=True)
                self.plane.fulfill_inline(ts.spec.out.oid,
                                          _TaskErr(ts.error))
                ts.finished = True
                ts.event.set()

    def _kernel_failed(self, spec: TaskSpec, message: str) -> bool:
        """Did a cuda chunk of a CUDA fleet fail in its kernel (build,
        launch, or the ``REPRO_CUDA_CHAOS`` knob)? Such an error fails
        the task: only a refused lowering (:data:`CUDA_INFEASIBLE`)
        steps down to the np body, and the blob/rows markers are
        transport faults that retry the same body."""
        return (self.device != "cpu" and spec.kind == "chunk"
                and spec.backend == "cuda"
                and CUDA_INFEASIBLE not in message
                and BLOB_MISSING not in message
                and ROWS_MISSING not in message)

    def _maybe_downgrade_backend(self, spec: TaskSpec,
                                 message: str) -> None:
        """A chunk that *errored* on a worker retries one step down its
        ``TaskSpec.alt`` degradation chain (registry-ordered, e.g.
        cuda → np). On a ``device="cpu"`` fleet (the kernels' plain
        versions, posing GPU workers) any error steps down, as in the
        reference; on a CUDA fleet only a lowering the kernel runtime
        refuses does (:meth:`_kernel_failed` fails the rest), so no
        chunk of a card fleet quietly moves to the CPU.

        ``alt`` holds either a tuple of ``(backend, blob_id, parts)``
        steps (registry chains) or a single such triple (pre-registry
        single-step form, still accepted)."""
        if spec.kind != "chunk" or spec.backend == "np" \
                or spec.alt is None:
            return
        if self.device != "cpu" and CUDA_INFEASIBLE not in message:
            return
        if spec.backend == "cuda":
            self.cuda_fallbacks += 1
        steps = spec.alt if isinstance(spec.alt[0], tuple) \
            else (spec.alt,)
        spec.backend, spec.blob_id, spec.parts = steps[0]
        rest = tuple(steps[1:])
        spec.alt = rest if rest else None
        spec.device_pref = backends_mod.get(spec.backend).device_pref \
            if backends_mod.is_registered(spec.backend) else "cpu"

    # -- placement + dispatch ---------------------------------------------
    def _views(self) -> List[WorkerView]:
        with self._lock:
            handles = [wh for wh in self._handles.values()
                       if wh.alive and wh.profile is not None
                       and not wh.draining and wh.conn is not None
                       and wh.suspect_deadline is None
                       and not wh.gpu_error]
            return [WorkerView(wh.wid, wh.profile, len(wh.inflight),
                               self.plane.resident_on(wh.wid))
                    for wh in handles]

    def _live_gpu_errors(self) -> List[str]:
        """The GPU probe errors of the live workers, when every live,
        profiled worker has one (else [])."""
        with self._lock:
            live = [wh for wh in self._handles.values()
                    if wh.alive and wh.profile is not None]
        if live and all(wh.gpu_error for wh in live):
            return [wh.gpu_error for wh in live]
        return []

    def _handle_for(self, wid: int) -> Optional[_WorkerHandle]:
        with self._lock:
            return self._handles.get(wid)

    def _ensure_arg_ready(self, ref: ClusterRef,
                          timeout: Optional[float] = 60.0) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            meta = self.plane.meta(ref.oid)
            if meta.state in (HEAD, REMOTE):
                return
            if meta.state == LOST:
                self._replay(ref.oid)
            self.plane.wait_ready(ref.oid, 0.05)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"arg never became ready: "
                    f"{self._timeout_forensics(ref)}")

    def _dispatch(self, ts: _TaskState) -> None:
        """Place and send one task; blocks until its ref args are ready
        (and replayed, if lost). Retries placement while workers die."""
        spec = ts.spec
        while not self._shutdown:
            # re-resolve on every attempt: an arg can turn LOST between
            # placement retries (its owner died under us) and only this
            # path triggers its replay
            for ref in spec.args:
                if isinstance(ref, ClusterRef):
                    self._ensure_arg_ready(ref)
                    meta = self.plane.meta(ref.oid)
                    if (meta.state == HEAD
                            and isinstance(meta.value, _TaskErr)):
                        # a failed upstream must poison dependents, not
                        # travel to a worker as an argument value
                        ts.error = f"upstream task failed: {meta.value}"
                        obs.end(ts.token, error=True)
                        self.plane.fulfill_inline(spec.out.oid,
                                                  _TaskErr(ts.error))
                        ts.finished = True
                        ts.event.set()
                        return
            views = self._views()
            if not views:
                gpu_errors = self._live_gpu_errors()
                if gpu_errors:
                    # every live worker failed its GPU probe: no chunk
                    # may run, and none may move to the CPU instead
                    ts.error = (f"no worker has a working "
                                f"{self.device!r} device: {gpu_errors[0]}")
                    obs.end(ts.token, error=True)
                    self.plane.fulfill_inline(spec.out.oid,
                                              _TaskErr(ts.error))
                    ts.finished = True
                    ts.event.set()
                    return
                if not self.respawn and self.workers_alive() == 0:
                    # the whole fleet is gone and nothing will replace
                    # it: fail the task so waiters raise instead of
                    # spinning forever
                    ts.error = "no live workers and respawn disabled"
                    obs.end(ts.token, error=True)
                    self.plane.fulfill_inline(spec.out.oid,
                                              _TaskErr(ts.error))
                    ts.finished = True
                    ts.event.set()
                    return
                time.sleep(0.05)
                continue
            if ts.tried:
                # a retry (error, death, or expired deadline) prefers a
                # worker that has not already failed/hung on this task
                fresh = [v for v in views if v.wid not in ts.tried]
                if fresh:
                    views = fresh
            arg_bytes = {a.oid: self.plane.meta(a.oid).nbytes
                         for a in spec.args
                         if isinstance(a, ClusterRef)}
            wid = self.scheduler.place(spec, views, arg_bytes)
            wh = self._handle_for(wid)
            if wh is None or not wh.alive:
                continue
            try:
                wire = self._wire_spec(spec, wh)
                with self._lock:
                    wh.inflight.add(spec.task_id)
                ts.wid = wid
                if wid not in ts.tried:
                    ts.tried.append(wid)
                wh.send(("task", spec.task_id, wire))
                ts.dispatched_at = time.monotonic()
                if spec.kind == "chunk":
                    self._count_chunk_shipment(spec)
                return
            except (OSError, BrokenPipeError, ValueError):
                with self._lock:
                    wh.inflight.discard(spec.task_id)
                time.sleep(0.02)  # worker died under us; replace + retry

    def _count_chunk_shipment(self, spec: TaskSpec) -> None:
        """Backend-routing telemetry for one *delivered* chunk task (a
        worker-death resubmit re-ships for real and re-counts). The
        per-arg sliced counters live in :meth:`_wire_spec`, where the
        ship-vs-keep decision is made."""
        if spec.backend == "np":
            self.cpu_chunks += 1
        else:
            self.gpu_chunks += 1
            if spec.backend == "cuda":
                self.cuda_chunks += 1

    def _wire_spec(self, spec: TaskSpec, wh: _WorkerHandle) -> Dict:
        """Encode a task for the wire, resolving every ref arg so the
        worker never has to fetch mid-task (locality keeps this cheap:
        the scheduler prefers the owner of the biggest inputs)."""
        wire_args = []
        for a in spec.args:
            if not isinstance(a, ClusterRef):
                wire_args.append(("val", a))
                continue
            meta = self.plane.meta(a.oid)
            if meta.state == HEAD:
                wire_args.append(("obj", a.oid, meta.value))
            elif meta.state == REMOTE and meta.owner == wh.wid:
                wire_args.append(("loc", a.oid))
            elif meta.state == REMOTE:
                # transfer on demand, relayed through the head
                got = self._fetch(a.oid)
                if got is None:
                    # owner died mid-fetch: force a dispatch retry,
                    # which re-resolves (and replays) the arg
                    raise ValueError(f"arg {a} fetch failed")
                wire_args.append(("obj", a.oid, got[1]))
            else:
                raise ValueError(f"arg {a} not ready")
        wire = {"kind": spec.kind, "out_oid": spec.out.oid,
                "gather": spec.gather, "args": wire_args}
        if self.trace:
            wire["trace"] = True   # worker measures + returns its spans
        if spec.kind == "chunk":
            parts: ClosureParts = spec.parts
            t0 = time.perf_counter()
            # blob counters update here because ship_blob really sent
            # (or raised); sliced counters wait until the task message
            # itself lands, in _count_chunk_shipment — a placement retry
            # must not inflate them
            cells, nbytes = wh.ship_blob(spec.blob_id, parts)
            self.cells_shipped += cells
            self.cells_skipped += len(parts.cell_pkls) - cells
            self.bytes_shipped += nbytes
            # per-chunk rows of the sliceable arrays: each worker gets
            # payload/n instead of the whole closure (ROADMAP item #1).
            # Content-hashed per (blob, name, range) and per worker: a
            # serving loop re-dispatching unchanged rows to the same
            # worker sends a ("keep",) marker instead of the bytes —
            # the worker reuses the rows it cached last round (its
            # rollback keeps them byte-exact)
            sliced_wire = {}
            for nm in spec.sliced:
                arr = parts.sliced.get(nm)
                if arr is None:
                    # ``spec.sliced`` is the round-level union from the
                    # np body; a twin capturing fewer arrays (a fused
                    # cuda call, a degraded-away backend) has nothing
                    # to ship for the rest
                    continue
                rows = arr[spec.lo:spec.hi]
                rb = int(rows.nbytes)
                h = hashlib.sha256(rows.tobytes()).hexdigest()
                rk = (spec.blob_id, nm, spec.lo, spec.hi)
                self.sliced_args += 1
                self.bytes_saved_sliced += int(arr.nbytes) - rb
                with wh.send_lock:
                    keep = wh.sliced_rows.get(rk) == h
                    if not keep:
                        wh.sliced_rows[rk] = h
                if keep:
                    sliced_wire[nm] = ("keep",)
                    self.rows_skipped += 1
                    self.bytes_saved_rows += rb
                else:
                    sliced_wire[nm] = ("rows", rows)
                    self.bytes_shipped += rb
            t1 = time.perf_counter()
            self._phase.add_time("ship_s", t1 - t0)
            if self.trace:
                obs.recorder().record(
                    "ship", "pfor", t0, t1,
                    args={"task": spec.task_id, "wid": wh.wid,
                          "cells": cells, "bytes": nbytes})
            wire.update(blob_id=spec.blob_id, lo=spec.lo, hi=spec.hi,
                        written=spec.written, sliced=sliced_wire,
                        backend=spec.backend)
        else:
            wire["fn_blob"] = spec.fn_blob
        return wire

    # -- public API --------------------------------------------------------
    def submit(self, fn, *args, device_pref: str = "",
               est_flops: float = 0.0) -> ClusterRef:
        """Asynchronously run ``fn(*args)`` on some worker process.
        Args may be plain picklable values or :class:`ClusterRef`."""
        tid = next(self._task_ids)
        out = self.plane.new_ref(tid)
        spec = TaskSpec(tid, "fn", dumps_fn(fn), tuple(args), out,
                        device_pref=device_pref, est_flops=est_flops)
        ts = _TaskState(spec)
        with self._lock:
            self._tasks[tid] = ts
            self._producer[out.oid] = tid
        pending = any(isinstance(a, ClusterRef)
                      and self.plane.meta(a.oid).state not in (HEAD, REMOTE)
                      for a in args)
        if pending:
            threading.Thread(target=self._dispatch, args=(ts,),
                             daemon=True).start()
        else:
            self._dispatch(ts)
        return out

    def submit_batch(self, fn, arg_tuples: Sequence[Tuple[Any, ...]],
                     device_pref: str = "",
                     est_flops: float = 0.0) -> List[ClusterRef]:
        """Batched submission: one ``fn`` over many argument tuples.
        The function serializes once (every spec shares the blob) and
        all tasks register under one lock before dispatch fans out —
        the serving plane's coalesced fall-through path for plain
        callables."""
        if not arg_tuples:
            return []
        blob = dumps_fn(fn)
        states: List[_TaskState] = []
        refs: List[ClusterRef] = []
        with self._lock:
            for args in arg_tuples:
                tid = next(self._task_ids)
                out = self.plane.new_ref(tid)
                spec = TaskSpec(tid, "fn", blob, tuple(args), out,
                                device_pref=device_pref,
                                est_flops=est_flops)
                ts = _TaskState(spec)
                self._tasks[tid] = ts
                self._producer[out.oid] = tid
                states.append(ts)
                refs.append(out)
        for ts in states:
            pending = any(
                isinstance(a, ClusterRef)
                and self.plane.meta(a.oid).state not in (HEAD, REMOTE)
                for a in ts.spec.args)
            if pending:
                threading.Thread(target=self._dispatch, args=(ts,),
                                 daemon=True).start()
            else:
                self._dispatch(ts)
        return refs

    def put(self, value: Any) -> ClusterRef:
        return self.plane.put_local(value)

    def release(self, ref: ClusterRef) -> None:
        """Drop every head-side record of ``ref``: its lineage (task +
        producer entries), its directory slot, and — when a worker owns
        the value — the worker's copy. After this the object can never
        be fetched or replayed; callers own the ordering (release a
        chain only after anchoring a replacement lineage root).
        Long-lived serving loops call this to hold head memory flat."""
        with self._lock:
            tid = self._producer.pop(ref.oid, None)
            if tid is not None:
                self._tasks.pop(tid, None)
        if not self.plane.contains(ref.oid):
            return
        meta = self.plane.meta(ref.oid)
        if meta.state == REMOTE and meta.owner is not None:
            wh = self._handle_for(meta.owner)
            if wh is not None and wh.alive:
                try:
                    wh.send(("free", ref.oid))
                except OSError:
                    pass
        self.plane.release(ref.oid)

    def get(self, ref_or_refs, timeout: Optional[float] = 60.0):
        if isinstance(ref_or_refs, list):
            return [self.get(r, timeout) for r in ref_or_refs]
        ref: ClusterRef = ref_or_refs
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            meta = self.plane.meta(ref.oid)
            if meta.state == HEAD:
                if isinstance(meta.value, _TaskErr):
                    raise ClusterTaskError(str(meta.value))
                return meta.value
            if meta.state == REMOTE:
                got = self._fetch(ref.oid)
                if got is not None:
                    return got[1]
                time.sleep(0.02)   # owner dying; wait for the LOST mark
            elif meta.state == LOST:
                self._replay(ref.oid)
            self.plane.wait_ready(ref.oid, 0.05)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(self._timeout_forensics(ref))

    def wait(self, refs: Sequence[ClusterRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             on_timeout: str = "return"):
        """ray.wait analogue: (ready, pending). With
        ``on_timeout="raise"``, a timeout raises :class:`TimeoutError`
        naming every still-pending task, its placed worker, and how
        stale that worker's last heartbeat is (the default keeps ray's
        return-what-you-have contract)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ready, pending = [], list(refs)
        while len(ready) < num_returns and pending:
            for r in list(pending):
                if self.plane.meta(r.oid).state in (HEAD, REMOTE):
                    ready.append(r)
                    pending.remove(r)
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() > deadline:
                if on_timeout == "raise" and len(ready) < num_returns:
                    detail = "; ".join(self._timeout_forensics(r)
                                       for r in pending)
                    raise TimeoutError(
                        f"wait: {len(ready)}/{num_returns} ready after "
                        f"{timeout}s — pending: {detail}")
                break
            time.sleep(0.005)
        return ready, pending

    def _fetch(self, oid: int) -> Optional[tuple]:
        """Pull a remote object to the head (transfer on demand).
        Returns ``("v", value)`` on success — the wrapper keeps a stored
        ``None`` distinguishable from failure — or ``None`` when the
        owner is gone (caller falls through to the LOST/replay path)."""
        meta = self.plane.meta(oid)
        if meta.state == HEAD:
            return ("v", meta.value)
        wh = self._handle_for(meta.owner) if meta.owner is not None \
            else None
        if wh is None or not wh.alive:
            return None
        ev = self._fetch_events.setdefault(oid, threading.Event())
        try:
            wh.send(("get", oid))
        except OSError:
            self._fetch_events.pop(oid, None)
            return None
        deadline = time.monotonic() + 30.0
        while not ev.wait(0.05):
            if not wh.alive:      # owner died before replying
                self._fetch_events.pop(oid, None)
                return None
            if time.monotonic() > deadline:
                self._fetch_events.pop(oid, None)
                return None
        meta = self.plane.meta(oid)
        return ("v", meta.value) if meta.state == HEAD else None

    # -- lineage replay ----------------------------------------------------
    def _replay(self, oid: int) -> None:
        """Recompute a LOST object from its serialized task spec; the
        spec's own lost ref args replay transitively via dispatch."""
        with self._lock:
            tid = self._producer.get(oid)
            ts = self._tasks.get(tid) if tid is not None else None
        if ts is None:
            raise ClusterTaskError(
                f"object {oid} lost and has no lineage (direct put?)")
        if not self.plane.try_reset_lost(oid):
            return  # someone else already replayed it
        self.replays += 1
        self._fault_event("lineage_replays", task=ts.spec.task_id,
                          oid=oid)
        ts.finished = False
        ts.event = threading.Event()
        with obs.span("replay", cat="fault", task=ts.spec.task_id,
                      oid=oid):
            self._dispatch(ts)

    # -- pfor sharding (the repro_torch.core.pfor protocol) ----------------------
    def _blob_for(self, parts: ClosureParts) -> int:
        """Stable blob id for a body identity (code hash + cell shapes/
        dtypes). A hit means every worker that already holds the skeleton
        re-receives at most the cells that changed — the serving-loop
        fast path."""
        with self._lock:
            rec = self._blob_cache.get(parts.blob_key)
            if rec is not None:
                rec.seq = next(self._blob_seq)
                rec.parts = parts   # freshest cells win the prewarm
                self.blob_hits += 1
                return rec.bid
            self.blob_misses += 1
            rec = _BlobRec(next(self._blob_ids), parts.blob_key,
                           next(self._blob_seq), parts=parts)
            self._blob_cache[parts.blob_key] = rec
            evict = []
            while len(self._blob_cache) > self.max_cached_blobs:
                victim = min(self._blob_cache.values(),
                             key=lambda r: r.seq)
                del self._blob_cache[victim.key]
                evict.append(victim.bid)
            bid = rec.bid
        for old in evict:
            self._drop_blob(old)
        return bid

    def _drop_blob(self, bid: int) -> None:
        with self._lock:
            handles = [wh for wh in self._handles.values() if wh.alive]
        for wh in handles:
            # under the send lock: ship_blob reads/updates the same
            # bookkeeping under it, so eviction can't interleave with a
            # delta ship and desync what the worker actually holds (a
            # task racing past an eviction still recovers — the worker
            # errors on the missing blob and the resubmit re-ships it)
            with wh.send_lock:
                if bid not in wh.blobs or wh.conn is None:
                    continue
                try:
                    wh.conn.send(("unblob", bid))
                except OSError:
                    pass
                wh.blobs.discard(bid)
                wh.blob_cells.pop(bid, None)
                for k in [k for k in wh.sliced_rows if k[0] == bid]:
                    del wh.sliced_rows[k]

    def _prewarm_blobs(self, wh: _WorkerHandle) -> None:
        """Ship every cached persistent body (skeleton + cells) to a
        worker that just joined or respawned, so its first serving-loop
        chunk starts warm instead of paying the full broadcast."""
        with self._lock:
            recs = [r for r in self._blob_cache.values()
                    if r.parts is not None]
        for rec in recs:
            try:
                cells, nbytes = wh.ship_blob(rec.bid, rec.parts)
                self.cells_shipped += cells
                self.bytes_shipped += nbytes
            except OSError:
                return   # died/unattached mid-warm; dispatch recovers

    @staticmethod
    def _merge_updates(arrays: Dict[str, np.ndarray], updates,
                       spec: TaskSpec) -> None:
        """Apply one chunk's sparse writes to the head's live arrays.
        Sliced arrays report chunk-local flat indices (the worker only
        held rows ``[lo, hi)``): re-base by ``lo`` leading-axis rows.
        An update for an array the head cannot see is a contract
        violation — dropping it would silently lose writes."""
        for name, (idx, vals) in (updates or {}).items():
            arr = arrays.get(name)
            if arr is None:
                raise ClusterTaskError(
                    f"pfor chunk [{spec.lo}, {spec.hi}) returned writes "
                    f"for {name!r}, which is not a captured ndarray of "
                    f"the body — refusing to drop them silently")
            if name in spec.sliced:
                stride = 1
                for d in arr.shape[1:]:
                    stride *= int(d)
                idx = np.asarray(idx, dtype=np.int64) + spec.lo * stride
            arr[np.unravel_index(idx, arr.shape)] = vals

    def _await_quorum(self, views: List[WorkerView],
                      wait_s: float = 5.0) -> List[WorkerView]:
        """Give a collapsing fleet a beat to respawn/rejoin before
        declaring it below quorum."""
        deadline = time.monotonic() + wait_s
        while len(views) < self.quorum and time.monotonic() < deadline:
            if not self.respawn and self.workers_alive() < self.quorum:
                break   # nothing will replace the dead
            time.sleep(0.05)
            views = self._views()
        return views

    def _gather_chunk(self, ref: ClusterRef, spec: TaskSpec,
                      arrays: Dict[str, np.ndarray], body, rid: int,
                      tracing: bool, ph) -> None:
        """Block on one chunk's result and merge its sparse writes.
        No per-chunk gather timeout: a healthy chunk may legitimately
        compute for minutes; hangs surface via heartbeat expiry or
        ``deadline_s`` resubmission, both bounded by max_attempts."""
        g0 = time.perf_counter()
        try:
            updates = self.get(ref, timeout=None)
        except ClusterTaskError:
            if not self.degrade_local:
                raise
            # this chunk terminally failed (retry budget spent, or the
            # fleet died under it): run it in-process — the body's
            # closure writes the head's live arrays directly, so no
            # merge is needed
            self._fault_event("degraded_chunks", task=spec.task_id,
                              lo=spec.lo, hi=spec.hi)
            log.warning("pfor chunk [%d, %d) degraded to "
                        "local execution", spec.lo, spec.hi)
            with obs.span("degraded_chunk", cat="fault",
                          task=spec.task_id):
                body(spec.lo, spec.hi)
            updates = None
        g1 = time.perf_counter()
        self._merge_updates(arrays, updates, spec)
        g2 = time.perf_counter()
        ph.add_time("gather_s", g1 - g0)
        ph.add_time("merge_s", g2 - g1)
        if tracing:
            rec = obs.recorder()
            rec.record("gather", "pfor", g0, g1,
                       args={"round": rid, "task": spec.task_id})
            rec.record("merge", "pfor", g1, g2,
                       args={"round": rid, "task": spec.task_id})

    def _gather_pipelined(self, chunks, arrays: Dict[str, np.ndarray],
                          body, rid: int, tracing: bool, ph) -> None:
        """As-completed gather: merge each sub-chunk the moment its
        result lands, while the rest of the round is still computing.
        pfor chunks write disjoint regions, so merges commute — the
        result is bitwise-identical to the in-order gather. The
        ``overlap_s`` phase metric accumulates head-side gather/merge
        seconds spent while at least one chunk was still in flight —
        exactly the wall time the synchronous round serialized."""
        with self._lock:
            pend = [(ref, spec, self._tasks.get(spec.task_id))
                    for ref, spec in chunks]
        overlap = 0.0
        while pend:
            ready = [p for p in pend
                     if p[2] is None or p[2].event.is_set()]
            if not ready:
                # head blocked on in-flight results: this is *overlapped*
                # wall (workers are computing under it), so it reports
                # as wait_s, distinct from the gather_s fetch/merge work
                w0 = time.perf_counter()
                pend[0][2].event.wait(0.005)
                ph.add_time("wait_s", time.perf_counter() - w0)
                continue
            for p in ready:
                pend.remove(p)
                g0 = time.perf_counter()
                self._gather_chunk(p[0], p[1], arrays, body, rid,
                                   tracing, ph)
                if pend:
                    overlap += time.perf_counter() - g0
        ph.add_time("overlap_s", overlap)

    def pfor_shards(self, body, lo: int, hi: int,
                    tile: Optional[int] = None,
                    written: Sequence[str] = (),
                    sliceable: Sequence[str] = (),
                    est_flops: float = 0.0,
                    deadline_s: Optional[float] = None) -> None:
        """Execute a generated pfor body across worker processes.

        The body skeleton + broadcast cells persist on the workers under
        a content-addressed blob id (re-shipped cell-by-cell only when
        their hashes change); arrays in ``sliceable`` — proven by the
        schedule to be indexed only by the pfor var on their leading
        axis — ship as per-chunk row slices, so their total traffic is
        ``payload`` instead of ``payload × n_workers``. Chunk tasks
        return sparse updates for the written arrays, which merge into
        the head's live arrays — pfor iterations write disjoint regions,
        so the merge needs no conflict resolution.

        Heterogeneous routing: when the body carries registered-backend
        twins (``body.__cuda__``/…, emitted per pfor
        unit by codegen), each worker's backend is priced from its
        device profile (:func:`repro_torch.core.cost.pick_chunk_backend` over
        ``est_flops`` and the payload bytes, candidates = the twins
        that actually exist), chunks are sized by the *chosen-backend*
        throughput, and placement routes them via the backend's
        ``device_pref`` — so a mixed fleet runs GPU workers on an
        accelerator body and CPU workers on the np body of the same
        pfor, gathered into one result. All bodies share the
        content-addressed cell store, so serving-loop blob reuse
        survives backend tagging."""
        n = hi - lo
        if n <= 0:
            return
        tracing = self.trace
        rid = next(self._round_seq)
        ph = self._phase
        rt0 = time.perf_counter()
        arrays = {n_: v for n_, v in closure_arrays(body).items()
                  if isinstance(v, np.ndarray)}
        # trust-but-verify the analysis against the live values: slicing
        # needs a real ndarray whose leading axis covers the iteration
        # range (anything else degrades to broadcast, never to an error)
        slice_names = tuple(
            nm for nm in dict.fromkeys(sliceable)
            if nm in arrays and arrays[nm].ndim >= 1
            and lo >= 0 and arrays[nm].shape[0] >= hi)
        bodies = {"np": body}
        if not self.np_only:
            # codegen stamps each registered backend's twin onto the np
            # body under the backend's attr (__cuda__, …)
            for bk_obj in backends_mod.twin_backends():
                twin = getattr(body, bk_obj.attr, None)
                if twin is not None:
                    bodies[bk_obj.name] = twin
        candidates = tuple(b for b in bodies if b != "np")
        t_split0 = time.perf_counter()
        parts_by = split_fn_variants(bodies, slice_names)
        t_split1 = time.perf_counter()
        views = self._views()
        if len(views) < self.quorum:
            views = self._await_quorum(views)
        if len(views) < self.quorum or not views:
            if not self.degrade_local:
                gpu_errors = self._live_gpu_errors()
                raise ClusterTaskError(
                    f"no quorum for pfor: {len(views)} live workers "
                    f"< quorum {self.quorum}"
                    + (f"; GPU probe failed: {gpu_errors[0]}"
                       if gpu_errors else ""))
            # fleet collapsed and nothing will replace it: degrade to
            # local in-process execution — the body's closure holds the
            # head's live arrays, so calling it directly is the
            # single-process semantics of the same loop
            self._fault_event("degraded_local_runs",
                              name=body.__name__, lo=lo, hi=hi)
            log.warning("pfor %s degraded to local execution "
                        "(%d live workers < quorum %d)",
                        body.__name__, len(views), self.quorum)
            with obs.span("degraded_local", cat="fault",
                          body=body.__name__):
                body(lo, hi)
            self.pfor_runs += 1
            ph.add_time("round_s", time.perf_counter() - rt0)
            return
        # price the (unit, backend, worker) cells: each view gets the
        # backend whose roofline+transport estimate is cheaper for its
        # expected share of the iteration space
        from repro_torch.core import cost as cost_model
        per_bytes = (sum(int(a.nbytes) for a in
                         parts_by["np"].sliced.values()) / len(views)
                     + parts_by["np"].broadcast_nbytes())
        backends = cost_model.unit_backend_table(
            est_flops / len(views), per_bytes,
            [v.profile for v in views],
            allow_jnp=bool(candidates), candidates=candidates)
        hetero = any(b != "np" for b in backends)
        # register every blob this run may use: the chosen backends
        # plus each one's degradation-chain members ("np" always — it
        # is the terminal fallback); workers receive a blob only when a
        # chunk referencing it is dispatched to them
        need = set(backends) | {"np"}
        for bk in tuple(need):
            need.update(b for b in backends_mod.degradation_chain(bk)
                        if b in bodies)
        bids = {bk: self._blob_for(parts_by[bk]) for bk in sorted(need)}
        if tile:
            ranges = [range(t, min(t + tile, hi))
                      for t in range(lo, hi, tile)]
            # explicit tiling decouples chunks from views: approximate
            # the fleet's backend mix by cycling the per-view choices
            chunk_backends = [backends[i % len(backends)]
                              for i in range(len(ranges))]
            chunk_prefs: List[Optional[int]] = [None] * len(ranges)
        else:
            # chosen-backend throughput, with skew clamped to 4x: a
            # probe that mis-measured on a throttled host must not
            # starve the run (genuine heterogeneity up to 4x shows)
            rates = [cost_model.backend_effective_gflops(v.profile, bk)
                     for v, bk in zip(views, backends)]
            top = max(rates)
            weights = [max(r, 0.25 * top) for r in rates]
            # drop_empty=False: ranges stay index-aligned with views so
            # each chunk pairs with the backend priced for *its* view
            # even when some worker's share rounds to zero
            ranges = self.scheduler.proportional_chunks(
                lo, hi, weights, drop_empty=False)
            chunk_backends = list(backends)
            # ranges stay index-aligned with views: chunk i was sized
            # for view i's throughput, so placement gets a soft
            # affinity to that worker
            chunk_prefs = [v.wid for v in views]
        depth = self.pipeline_depth
        if not tile and depth > 1:
            # pipelining: each worker share splits into `depth`
            # contiguous sub-chunks (backend + affinity preserved),
            # gathered as-completed below — the head ships sub-chunk
            # k+1 and merges k-1 while the worker computes k, instead
            # of the whole fleet idling through one synchronous barrier
            sub_r: List[range] = []
            sub_b: List[str] = []
            sub_p: List[Optional[int]] = []
            for r, bk, pw in zip(ranges, chunk_backends, chunk_prefs):
                d = max(1, min(depth, len(r)))
                edges = np.linspace(r.start, r.stop, d + 1).astype(int)
                for c in range(d):
                    sub_r.append(range(int(edges[c]),
                                       int(edges[c + 1])))
                    sub_b.append(bk)
                    sub_p.append(pw)
            ranges, chunk_backends, chunk_prefs = sub_r, sub_b, sub_p
        ub = self.unit_backend.setdefault(
            f"{body.__name__}@{parts_by['np'].code_hash[:8]}", {})
        # plan phase = everything so far except the split (body
        # serialization), which reports on its own — the two segments
        # around it both count as planning
        t_plan1 = time.perf_counter()
        ph.add_time("plan_s", (t_split0 - rt0) + (t_plan1 - t_split1))
        ph.add_time("split_s", t_split1 - t_split0)
        if tracing:
            rec = obs.recorder()
            rec.record("plan", "pfor", rt0, t_split0,
                       args={"round": rid})
            rec.record("split", "pfor", t_split0, t_split1,
                       args={"round": rid})
            rec.record("plan", "pfor", t_split1, t_plan1,
                       args={"round": rid})
        chunks = []
        for r, bk, pw in zip(ranges, chunk_backends, chunk_prefs):
            if len(r) == 0:
                continue
            tid = next(self._task_ids)
            out = self.plane.new_ref(tid)
            alt = None
            if bk != "np":
                # registry-ordered degradation chain (cuda → np): each
                # erroring attempt pops one step off
                chain = [b for b in backends_mod.degradation_chain(bk)
                         if b in bodies]
                alt = tuple((b, bids[b], parts_by[b]) for b in chain)
            spec = TaskSpec(tid, "chunk", None, (), out,
                            blob_id=bids[bk],
                            lo=r.start, hi=r.stop,
                            written=tuple(written),
                            sliced=slice_names, parts=parts_by[bk],
                            gather=True, backend=bk, alt=alt,
                            pref_wid=pw,
                            device_pref=(
                                backends_mod.get(bk).device_pref
                                if hetero else ""))
            ts = _TaskState(spec, deadline_s=deadline_s)
            if tracing:
                ts.span_meta = {"round": rid, "lo": r.start,
                                "hi": r.stop}
                ts.token = obs.begin("chunk_inflight", cat="pfor",
                                     round=rid, task=tid, lo=r.start,
                                     hi=r.stop, backend=bk)
            with self._lock:
                self._tasks[tid] = ts
                self._producer[out.oid] = tid
            self._dispatch(ts)
            chunks.append((out, spec))
            self.chunks_dispatched += 1
            ub[bk] = ub.get(bk, 0) + 1
        t_disp1 = time.perf_counter()
        # dispatch wall includes the per-chunk shipping done inside
        # _wire_spec — ship_s (accumulated there) is its subset
        ph.add_time("dispatch_s", t_disp1 - t_plan1)
        if tracing:
            obs.recorder().record("dispatch", "pfor", t_plan1, t_disp1,
                                  args={"round": rid,
                                        "chunks": len(chunks)})
        self.pfor_runs += 1
        try:
            if depth > 1 and len(chunks) > 1:
                self._gather_pipelined(chunks, arrays, body, rid,
                                       tracing, ph)
            else:
                # depth-1 synchronous round: gather in dispatch order
                for ref, spec in chunks:
                    self._gather_chunk(ref, spec, arrays, body, rid,
                                       tracing, ph)
        finally:
            # chunk updates are consumed; their lineage window is over.
            # Drop every per-chunk record so a serving loop calling the
            # kernel forever holds the head's memory flat. The blob
            # stays resident on the workers — that persistence is what
            # the next call's blob_hit re-uses.
            with self._lock:
                for ref, _ in chunks:
                    tid = self._producer.pop(ref.oid, None)
                    if tid is not None:
                        self._tasks.pop(tid, None)
            for ref, _ in chunks:
                self.plane.release(ref.oid)
            # if another caller's LRU churn evicted a blob of this run
            # while our chunks were in flight, a dispatch/resubmit may
            # have resurrected it on some worker after the unblob —
            # with no head-side record left, nothing would ever free
            # it. Drop each used blob again now that the run is over.
            for bk, bid in bids.items():
                with self._lock:
                    rec = self._blob_cache.get(parts_by[bk].blob_key)
                    evicted = rec is None or rec.bid != bid
                if evicted:
                    self._drop_blob(bid)
            rt1 = time.perf_counter()
            wall = rt1 - rt0
            ph.add_time("round_s", wall)
            with self._lock:
                busy = self._round_busy.pop(rid, 0.0)
                compute = self._round_compute.pop(rid, 0.0)
            if tracing:
                # compute = Σ worker "run" spans; idle = fleet capacity
                # the round left on the table (round wall × workers −
                # everything the workers spent on our chunks)
                nw = max(1, len(views))
                ph.add_time("compute_s", compute)
                ph.add_time("idle_s", max(0.0, wall * nw - busy))
                obs.recorder().record(
                    "pfor_round", "pfor", rt0, rt1,
                    args={"round": rid, "name": body.__name__,
                          "unit": getattr(body, "__unit__", None),
                          "chunks": len(chunks), "workers": nw,
                          "depth": depth})

    def distribute_profitable(self, flops: float, payload_bytes: int,
                              n_chunks: int,
                              sliced_bytes: float = 0.0) -> bool:
        """Local-vs-distributed decision from the measured device
        profiles (consumed by :mod:`repro_torch.core.pfor`).
        ``payload_bytes`` is the broadcast part of the closure (rides to
        every worker); ``sliced_bytes`` is the chunk-sliceable part
        (ships once total, split across workers)."""
        from repro_torch.core import cost
        profiles = self.profiles()
        return cost.cluster_distribute_profitable(
            flops, payload_bytes, profiles,
            max(1, n_chunks),
            local_gflops=self.local_profile.gflops,
            sliced_bytes=sliced_bytes)

    # -- compilation against the shared variant store ----------------------
    def compile(self, fn, **kw):
        """Compile a kernel bound to this runtime, warm-starting from the
        shared variant cache when ``cache_dir`` was given (a fleet of
        runtimes pointed at one directory compiles each kernel once)."""
        from repro_torch.core.compiler import compile_kernel
        kw.setdefault("cache", self.variant_cache)
        kw.setdefault("workers", max(1, len(self._views())))
        return compile_kernel(fn, runtime=self, **kw)

    # -- fault injection / ops --------------------------------------------
    def kill_worker(self, wid: Optional[int] = None) -> Optional[int]:
        """SIGKILL a worker process (fault-injection drill). Lineage +
        resubmission recover its objects and in-flight tasks."""
        with self._lock:
            live = [wh for wh in self._handles.values()
                    if wh.alive and wh.proc is not None]
            if not live:
                return None
            victim = live[0]
            if wid is not None:
                for wh in live:
                    if wh.wid == wid:
                        victim = wh
                        break
        try:
            os.kill(victim.proc.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            return None
        return victim.wid

    # -- elastic membership ------------------------------------------------
    def add_worker(self, sim_gpu: bool = False,
                   timeout_s: float = 30.0) -> Optional[int]:
        """Grow the fleet by one mid-serving-loop: spawn, wait for its
        hello, re-measure capability + transport, and pre-warm it with
        the cached persistent bodies so the very next pfor round gives
        it its capability-proportional chunk share."""
        wh = self._spawn_worker(sim_gpu=sim_gpu)
        if not wh.hello.wait(timeout_s):
            return None
        self._reprofile(wh)
        self._ping_transport(wh)
        self._prewarm_blobs(wh)
        self._fault_event("joins", wid=wh.wid)
        return wh.wid

    def drain_worker(self, wid: Optional[int] = None) -> Optional[int]:
        """Shrink the fleet by one, cleanly: the worker takes no new
        chunks, finishes its in-flight tasks, hands its objects back to
        the head, then exits (all driven by the monitor)."""
        with self._lock:
            live = [wh for wh in self._handles.values()
                    if wh.alive and not wh.draining]
            if wid is not None:
                live = [wh for wh in live if wh.wid == wid]
            if not live:
                return None
            victim = live[-1]
            victim.draining = True
        return victim.wid

    def scale_to(self, n: int) -> None:
        """Elastic resize to ``n`` live workers: grows via
        :meth:`add_worker` (profiled + pre-warmed), shrinks by marking
        workers draining — they finish in-flight work and exit cleanly
        once the monitor sees them idle."""
        with self._lock:
            live = [wh for wh in self._handles.values()
                    if wh.alive and not wh.draining]
        delta = n - len(live)
        if delta > 0:
            for _ in range(delta):
                self.add_worker()
        elif delta < 0:
            for wh in live[:-delta]:
                self.drain_worker(wh.wid)

    def rotate_authkey(self, new: Optional[bytes] = None) -> bytes:
        """Swap the TCP transport's authkey. Connected workers learn
        the new key in-band (``rekey``) so their future reconnects keep
        working; anything holding the old key fails the challenge."""
        if self.listener is None:
            raise RuntimeError("authkey rotation needs transport='tcp'")
        key = self.listener.rotate(new)
        with self._lock:
            handles = [wh for wh in self._handles.values() if wh.alive]
        for wh in handles:
            try:
                wh.send(("rekey", key))
            except OSError:
                pass
        self._fault_event("rekeys")
        return key

    def queue_depth(self) -> int:
        """Unfinished tasks (duck-typed parity with TaskRuntime's pool
        depth — what the elastic controller scales on)."""
        with self._lock:
            return sum(1 for t in self._tasks.values() if not t.finished)

    def profiles(self) -> List[DeviceProfile]:
        with self._lock:
            return [wh.profile for wh in self._handles.values()
                    if wh.alive and wh.profile is not None]

    def workers_alive(self) -> int:
        with self._lock:
            return sum(1 for wh in self._handles.values() if wh.alive)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            tasks = len(self._tasks)
            done = sum(1 for t in self._tasks.values() if t.finished)
        out = {
            "workers": self.workers_alive(),
            "tasks": tasks,
            "completed": done,
            "replays": self.replays,
            "lineage_replays": self.replays,
            "resubmits": self.resubmits,
            "worker_deaths": self.worker_deaths,
            "pfor_runs": self.pfor_runs,
            "chunks_dispatched": self.chunks_dispatched,
            "bytes_shipped": self.bytes_shipped,
            "gpu_chunks": self.gpu_chunks,
            "cpu_chunks": self.cpu_chunks,
            "cuda_chunks": self.cuda_chunks,
            "cuda_fallbacks": self.cuda_fallbacks,
            "unit_backend": {k: dict(v)
                             for k, v in self.unit_backend.items()},
            "chunks_executed": dict(self.chunks_executed),
            "sliced_args": self.sliced_args,
            "bytes_saved_sliced": self.bytes_saved_sliced,
            "blob_hits": self.blob_hits,
            "blob_misses": self.blob_misses,
            "cells_shipped": self.cells_shipped,
            "cells_skipped": self.cells_skipped,
            "rows_skipped": self.rows_skipped,
            "bytes_saved_rows": self.bytes_saved_rows,
            "resident_hits": self.resident_hits,
            "resident_stages": self.resident_stages,
            "resident_cells": self.resident_cells,
            "cuda_calls": self.cuda_calls,
            "cuda_plain_calls": self.cuda_plain_calls,
            "matmul_launches": self.matmul_launches,
            "flash_attention_launches": self.flash_attention_launches,
            "mamba_scan_launches": self.mamba_scan_launches,
            "device": self.device,
            "pipeline_depth": self.pipeline_depth,
            "cached_blobs": len(self._blob_cache),
            "chunks_executed_by_worker":
                dict(self.chunks_executed_by_worker),
            "faults": self._faults.snapshot(),
            "fault_events": len(self.fault_events),
            "transport": self.transport,
            "plane": self.plane.stats(),
        }
        if self.chaos is not None:
            out["chaos"] = self.chaos.stats()
        return out

    def phase_breakdown(self) -> Dict[str, float]:
        """Measured per-phase seconds for this runtime's pfor rounds
        (``plan/split/ship/dispatch/gather/merge/round``, plus
        ``overlap``/``wait`` for pipelined rounds — ``wait`` is head
        time blocked on in-flight results, i.e. wall overlapped with
        worker compute — and ``compute``/``idle`` when tracing is on),
        straight from the ``cluster#N.phase`` scope of the unified
        metrics registry."""
        return self._phase.snapshot()

    def telemetry(self) -> Dict[str, Any]:
        out = self.stats()
        out["profiles"] = [p.as_dict() for p in self.profiles()]
        out["local_gflops"] = self.local_profile.gflops
        out["phases"] = self.phase_breakdown()
        if self.variant_cache is not None:
            out["cache"] = self.variant_cache.telemetry()
        return out

    def shutdown(self) -> None:
        self._shutdown = True
        if self.listener is not None:
            self.listener.close()
        with self._lock:
            handles = list(self._handles.values())
        for wh in handles:
            try:
                wh.send(("shutdown",))
            except OSError:
                pass
        deadline = time.monotonic() + 2.0
        for wh in handles:
            if wh.proc is None:
                continue   # external worker: the shutdown message (or
                           # its closed socket) is all we owe it
            wh.proc.join(max(0.05, deadline - time.monotonic()))
            if wh.proc.is_alive():
                wh.proc.terminate()
                wh.proc.join(1.0)
        for wh in handles:
            wh.close_conn()
        if self._trace_path and self.trace:
            try:
                obs.export_chrome_trace(self._trace_path)
            except OSError:
                pass

    def __enter__(self) -> "ClusterRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
