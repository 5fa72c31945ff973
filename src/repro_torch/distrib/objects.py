"""The serialized object plane: ownership directory + lineage records.

Objects produced by cluster tasks live **where they were produced** (the
owning worker's in-process cache); the head keeps only a directory entry
(owner, size) unless the value was small enough to inline. ``get`` pulls
on demand; a dead owner turns the entry LOST and the lineage record —
the serialized task spec — is replayed on a surviving worker, exactly
the recovery contract :mod:`repro_torch.runtime.lineage` implements inside one
process.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# object states
HEAD = "head"          # value held by the head (inlined / put())
REMOTE = "remote"      # value held by the owning worker
PENDING = "pending"    # producing task not finished yet
LOST = "lost"          # owner died before the value reached the head


@dataclass(frozen=True)
class ClusterRef:
    """Future-like handle to an object in the cluster plane."""

    oid: int
    task_id: Optional[int] = None   # producing task (lineage edge)

    def __repr__(self) -> str:
        return f"ClusterRef(oid={self.oid}, task={self.task_id})"


@dataclass
class ObjectMeta:
    oid: int
    state: str = PENDING
    owner: Optional[int] = None     # wid when state == REMOTE
    nbytes: int = 0
    value: Any = None               # when state == HEAD


@dataclass
class TaskSpec:
    """Serialized, replayable description of one cluster task.

    ``fn_blob`` is a :func:`repro_torch.distrib.serial.dumps_fn` payload;
    ``args`` holds plain values and :class:`ClusterRef` placeholders.
    Chunk tasks reference a broadcast body blob instead and carry the
    iteration range. Both forms are self-contained enough to re-dispatch
    to any worker — that property *is* the lineage guarantee."""

    task_id: int
    kind: str                       # 'fn' | 'chunk'
    fn_blob: Optional[bytes]
    args: Tuple[Any, ...]
    out: ClusterRef
    blob_id: Optional[int] = None   # chunk: broadcast body
    lo: int = 0
    hi: int = 0
    written: Tuple[str, ...] = ()
    # chunk: arrays shipped as row slices [lo, hi) instead of riding in
    # the broadcast blob; their gathered updates arrive in chunk-local
    # coordinates and are re-based by the head
    sliced: Tuple[str, ...] = ()
    # chunk: the head-side ClosureParts this spec slices from — a live
    # reference (never pickled; the wire form is built in _wire_spec),
    # which is exactly what makes a mid-run replay self-contained
    parts: Any = None
    gather: bool = False            # force the result inline to the head
    device_pref: str = ""           # '' | 'cpu' | 'gpu'
    est_flops: float = 0.0
    attempts: int = 0
    # chunk: which body variant this spec executes (a registered
    # backend name — "np" | "jnp" | "pallas" | …); the hetero sharder
    # prices the choice per worker profile
    backend: str = "np"
    # chunk: the degradation chain — a tuple of (backend, blob_id,
    # parts) steps ordered by the registry (pallas → jnp → np). A chunk
    # that *errors* on a worker (jax missing there, a pallas lowering
    # failing at run time) pops one step on resubmit instead of burning
    # all its attempts. A bare (backend, blob_id, parts) triple (the
    # pre-registry single-step form) is still accepted.
    alt: Optional[Tuple[Any, ...]] = None
    # chunk: the worker whose measured throughput this range was sized
    # for — a soft placement affinity, so proportional chunking stays
    # meaningful (without it, small pipelined sub-chunks all drain to
    # whichever worker finishes fastest and the sizing is moot)
    pref_wid: Optional[int] = None


class ObjectPlane:
    """Head-side directory of every cluster object. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._meta: Dict[int, ObjectMeta] = {}
        self._ids = itertools.count(1)
        self._events: Dict[int, threading.Event] = {}
        self.inlined = 0
        self.lost_marks = 0

    def new_ref(self, task_id: Optional[int] = None) -> ClusterRef:
        with self._lock:
            oid = next(self._ids)
            self._meta[oid] = ObjectMeta(oid)
            self._events[oid] = threading.Event()
        return ClusterRef(oid, task_id)

    def put_local(self, value: Any) -> ClusterRef:
        ref = self.new_ref()
        self.fulfill_inline(ref.oid, value)
        return ref

    # -- state transitions ------------------------------------------------
    def fulfill_inline(self, oid: int, value: Any) -> None:
        with self._lock:
            m = self._meta[oid]
            # value before state: readers access ObjectMeta fields
            # without the lock, and a HEAD state must imply the value
            # is already there
            m.value = value
            m.nbytes = int(getattr(value, "nbytes", 0) or 0)
            m.state = HEAD
            self.inlined += 1
            ev = self._events[oid]
        ev.set()

    def fulfill_remote(self, oid: int, owner: int, nbytes: int) -> None:
        with self._lock:
            m = self._meta[oid]
            # an inlined value never downgrades to a remote pointer
            if m.state != HEAD:
                m.state = REMOTE
                m.owner = owner
                m.nbytes = nbytes
            ev = self._events[oid]
        ev.set()

    def promote(self, oid: int, value: Any) -> None:
        """A remote value just arrived at the head: cache it."""
        with self._lock:
            m = self._meta[oid]
            m.value = value     # value before state (unlocked readers)
            m.state = HEAD

    def mark_worker_lost(self, wid: int) -> List[int]:
        """Owner died: every object it held becomes LOST (and un-ready
        so waiters fall through to lineage replay). Returns the oids."""
        lost = []
        with self._lock:
            for m in self._meta.values():
                if m.state == REMOTE and m.owner == wid:
                    m.state = LOST
                    m.owner = None
                    self._events[m.oid] = threading.Event()
                    lost.append(m.oid)
                    self.lost_marks += 1
        return lost

    def reset_pending(self, oid: int) -> None:
        """Replay is about to re-produce this object."""
        with self._lock:
            m = self._meta[oid]
            m.state = PENDING
            m.value = None
            self._events[oid] = threading.Event()

    def try_reset_lost(self, oid: int) -> bool:
        """Atomically claim a LOST object for replay. Exactly one of any
        number of concurrent getters wins; the rest keep waiting."""
        with self._lock:
            m = self._meta[oid]
            if m.state != LOST:
                return False
            m.state = PENDING
            m.value = None
            self._events[oid] = threading.Event()
            return True

    def release(self, oid: int) -> None:
        """Forget an object entirely (directory entry + value + event).
        For consumed intermediates — pfor chunk updates — whose lineage
        window closed with the run that gathered them."""
        with self._lock:
            self._meta.pop(oid, None)
            self._events.pop(oid, None)

    # -- queries ----------------------------------------------------------
    def contains(self, oid: int) -> bool:
        """Whether the directory still tracks ``oid`` (False once
        :meth:`release` consumed it — e.g. a duplicate/late "done" for a
        chunk whose pfor round already gathered and dropped it)."""
        with self._lock:
            return oid in self._meta

    def meta(self, oid: int) -> ObjectMeta:
        with self._lock:
            return self._meta[oid]

    def wait_ready(self, oid: int, timeout: Optional[float]) -> bool:
        with self._lock:
            ev = self._events.get(oid)
        if ev is None:
            return True  # released (consumed): nothing left to wait on
        return ev.wait(timeout)

    def resident_on(self, wid: int) -> Dict[int, int]:
        """oid → nbytes of every object currently owned by ``wid``."""
        with self._lock:
            return {m.oid: m.nbytes for m in self._meta.values()
                    if m.state == REMOTE and m.owner == wid}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            states: Dict[str, int] = {}
            for m in self._meta.values():
                states[m.state] = states.get(m.state, 0) + 1
        return {"objects": sum(states.values()), **states,
                "inlined": self.inlined, "lost_marks": self.lost_marks}
