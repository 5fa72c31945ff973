"""Deterministic fault-injection harness for the cluster runtime.

Every recovery path the runtime claims — worker death, hang, slowdown,
transient socket loss, message delay/duplication/drop, refused rejoin —
is exercisable on demand and **seeded**, so a chaos drill that fails in
CI replays bit-identically on a laptop.

Two injection planes:

  * **process/behavior faults** — helpers that tell a live worker to
    misbehave via a ``("chaos", op, arg)`` control message:
    :func:`hang` (stop making progress, optionally silencing heartbeats
    so liveness monitoring fires), :func:`slow` (fixed latency before
    every task), :func:`drop_conn` (sever the socket → reconnect/backoff
    drill), :func:`babble` (emit a malformed protocol message),
    :func:`exit` (clean self-termination). :func:`kill` SIGKILLs from
    the head side (the pre-existing drill). :func:`refuse_reconnect`
    fences a wid so its next rejoin is denied.

  * **message faults** — :class:`ChaosPlan` + :class:`ChaosWire`: the
    head wraps each worker connection's *send* side; messages may be
    dropped, duplicated, or delayed by a seeded RNG. Delay preserves
    FIFO order (one sender thread drains a due-time queue), because the
    wire protocol's blob-before-task ordering must hold even under
    chaos — chaos models a slow/lossy network, not a reordering one.
    ``drop_kinds``/``delay_kinds``/``dup_kinds`` narrow injection to
    specific message kinds and ``max_drops``/``max_dups`` bound the
    blast radius so drills terminate.

Pass a plan to the runtime: ``ClusterRuntime(chaos=ChaosPlan(seed=7,
delay_s=0.005))``. Counters on the plan (``dropped``/``duplicated``/
``delayed``) plus the runtime's ``faults`` metrics scope tell the drill
what actually fired.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Set, Tuple

from .transport import recv

__all__ = ["ChaosPlan", "ChaosWire", "kill", "hang", "slow",
           "drop_conn", "babble", "exit_worker", "refuse_reconnect"]


@dataclass
class ChaosPlan:
    """Seeded message-fault schedule, shared by every wire the runtime
    wraps with it (each wire derives its own RNG from ``(seed, wid)``,
    so per-worker decisions stay deterministic regardless of thread
    interleaving)."""

    seed: int = 0
    drop_p: float = 0.0
    dup_p: float = 0.0
    delay_s: float = 0.0
    # restrict injection to these message kinds (first tuple element);
    # empty = all kinds
    drop_kinds: Tuple[str, ...] = ()
    dup_kinds: Tuple[str, ...] = ()
    delay_kinds: Tuple[str, ...] = ()
    # hard budgets so a drill with p=1.0 still terminates/recovers
    max_drops: Optional[int] = None
    max_dups: Optional[int] = None
    # wids whose rejoin the head must deny (exercises the fenced path)
    refuse_rejoin: Set[int] = field(default_factory=set)
    # observed injections
    dropped: int = 0
    duplicated: int = 0
    delayed: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def _kind(self, msg) -> str:
        try:
            return str(msg[0])
        except (TypeError, IndexError):
            return "?"

    def _may(self, kinds: Tuple[str, ...], kind: str) -> bool:
        return not kinds or kind in kinds

    def take_drop(self, rng: random.Random, msg) -> bool:
        kind = self._kind(msg)
        if not self._may(self.drop_kinds, kind) or self.drop_p <= 0:
            return False
        if rng.random() >= self.drop_p:
            return False
        with self._lock:
            if self.max_drops is not None and \
                    self.dropped >= self.max_drops:
                return False
            self.dropped += 1
        return True

    def take_dup(self, rng: random.Random, msg) -> bool:
        kind = self._kind(msg)
        if not self._may(self.dup_kinds, kind) or self.dup_p <= 0:
            return False
        if rng.random() >= self.dup_p:
            return False
        with self._lock:
            if self.max_dups is not None and \
                    self.duplicated >= self.max_dups:
                return False
            self.duplicated += 1
        return True

    def take_delay(self, rng: random.Random, msg) -> float:
        kind = self._kind(msg)
        if not self._may(self.delay_kinds, kind) or self.delay_s <= 0:
            return 0.0
        with self._lock:
            self.delayed += 1
        return self.delay_s

    def stats(self) -> dict:
        return {"seed": self.seed, "dropped": self.dropped,
                "duplicated": self.duplicated, "delayed": self.delayed}


class ChaosWire:
    """Connection wrapper injecting the plan's message faults on the
    **send** path (receive passes through untouched). Delayed sends are
    drained FIFO by one background thread, so relative order — the
    protocol's only ordering requirement — is preserved; drops and
    duplicates happen at enqueue time.

    Failure semantics shift under delay: a send that would have raised
    synchronously (dead peer) now fails on the drain thread and the
    loss surfaces via the receiver's connection-lost path instead —
    exactly how a real buffered network behaves."""

    def __init__(self, conn, plan: ChaosPlan, peer: int = 0):
        self._conn = conn
        self.plan = plan
        self.peer = peer
        # str seeding hashes via sha512 — deterministic across processes
        self._rng = random.Random(f"{plan.seed}:{peer}")
        self._cv = threading.Condition()
        self._queue = []          # [(due, seq, msg)] FIFO by seq
        self._seq = 0
        self._closed = False
        self._sender: Optional[threading.Thread] = None

    # -- sender thread (lazy: only when a delay is actually injected) ----
    def _ensure_sender(self) -> None:
        if self._sender is None:
            self._sender = threading.Thread(
                target=self._drain, name=f"chaos-wire-{self.peer}",
                daemon=True)
            self._sender.start()

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(0.5)
                if self._closed and not self._queue:
                    return
                due, _, msg = self._queue[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(due - now)
                    continue
                self._queue.pop(0)
            try:
                self._conn.send(msg)
            except (OSError, BrokenPipeError, ValueError, TypeError):
                with self._cv:
                    self._queue.clear()
                    self._closed = True
                return

    def send(self, msg) -> None:
        if self.plan.take_drop(self._rng, msg):
            return
        copies = 2 if self.plan.take_dup(self._rng, msg) else 1
        delay = self.plan.take_delay(self._rng, msg)
        with self._cv:
            queued = bool(self._queue)
        if delay <= 0 and not queued:
            for _ in range(copies):
                self._conn.send(msg)
            return
        # FIFO through the drain thread (even zero-delay messages must
        # queue behind an in-flight delayed one to keep order)
        self._ensure_sender()
        with self._cv:
            if self._closed:
                raise OSError("chaos wire closed")
            due = time.monotonic() + delay
            for _ in range(copies):
                self._queue.append((due, self._seq, msg))
                self._seq += 1
            self._cv.notify_all()

    def recv(self):
        return recv(self._conn)

    def poll(self, timeout=0.0):
        return self._conn.poll(timeout)

    def fileno(self):
        return self._conn.fileno()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        try:
            self._conn.close()
        except OSError:
            pass


# -- behavior-fault helpers (head-side API) -------------------------------

def _send_op(rt, wid: Optional[int], op: str, arg=None) -> Optional[int]:
    """Deliver one chaos control message; returns the targeted wid or
    None when no live worker matched."""
    with rt._lock:
        live = [wh for wh in rt._handles.values() if wh.alive]
        if wid is not None:
            live = [wh for wh in live if wh.wid == wid]
    if not live:
        return None
    wh = live[0]
    try:
        wh.send(("chaos", op, arg))
    except OSError:
        return None
    return wh.wid


def kill(rt, wid: Optional[int] = None) -> Optional[int]:
    """SIGKILL a worker process (hard crash)."""
    return rt.kill_worker(wid)


def hang(rt, wid: Optional[int] = None,
         seconds: Optional[float] = None,
         silence_heartbeat: bool = True) -> Optional[int]:
    """Make a worker stop making progress for ``seconds`` (forever when
    None). With ``silence_heartbeat`` the hang looks like a dead process
    to the liveness monitor; without it, heartbeats keep flowing and
    only per-task deadlines can catch the wedge."""
    return _send_op(rt, wid, "hang",
                    {"seconds": seconds, "silence_hb": silence_heartbeat})


def slow(rt, wid: Optional[int] = None,
         per_task_s: float = 0.1) -> Optional[int]:
    """Inject fixed latency before every subsequent task on a worker."""
    return _send_op(rt, wid, "slow", per_task_s)


def drop_conn(rt, wid: Optional[int] = None) -> Optional[int]:
    """Sever a worker's socket (transient network failure). TCP workers
    reconnect with exponential backoff; pipe workers die."""
    return _send_op(rt, wid, "drop_conn")


def babble(rt, wid: Optional[int] = None) -> Optional[int]:
    """Make a worker emit one malformed protocol message (exercises the
    head's malformed-message accounting)."""
    return _send_op(rt, wid, "babble")


def exit_worker(rt, wid: Optional[int] = None) -> Optional[int]:
    """Clean self-termination (vs :func:`kill`'s SIGKILL)."""
    return _send_op(rt, wid, "exit")


def refuse_reconnect(rt, wid: int, plan: Optional[ChaosPlan] = None
                     ) -> None:
    """Deny this wid's next rejoin attempt — the worker is fenced and
    must exit; the head declares it dead when the reconnect grace
    expires."""
    plan = plan if plan is not None else getattr(rt, "chaos", None)
    if plan is None:
        plan = rt.chaos = ChaosPlan()
    plan.refuse_rejoin.add(wid)
