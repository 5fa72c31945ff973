"""Fault-tolerant multi-host transport for the cluster runtime.

The wire protocol (framed pickled tuples, see :mod:`.worker`) is
transport-agnostic; this module supplies the two link flavors the head
and workers ride on:

  * **pipe** — the original single-host ``multiprocessing.Pipe``
    transport, wrapped in :class:`PipeLink` so concurrent senders (the
    worker's main loop + its heartbeat thread) serialize on one lock;
  * **tcp** — a :class:`HeadListener` accepts socket connections from
    workers on *any* host, authenticating each with the
    ``multiprocessing.connection`` HMAC challenge protocol. The authkey
    is held by this module (not baked into the listener), so it can be
    **rotated** mid-flight: connected workers learn the new key via a
    ``("rekey", key)`` message and use it on their next reconnect, while
    a stale client fails the challenge and is counted, not served.

Workers connect through :class:`ReconnectingClient`: a transient socket
failure triggers reconnect with exponential backoff (bounded tries)
before the link is declared dead, and non-droppable outbound messages
("done"/"err"/"obj" results) are buffered in an outbox and flushed after
the rejoin handshake — so a blip mid-serving-loop loses no results.
Heartbeats are sent ``droppable=True`` and simply skip a dead window.

Handshake (first message on every authenticated connection):

  worker → head: ("attach", wid, reconnect_attempts)   # known worker
               | ("join", sim_gpu)                     # new external worker
  head → worker: ("welcome", wid) | ("denied", reason)

A ``denied`` reply fences the worker permanently: the head has already
declared it dead (its objects were marked LOST and replayed), so letting
it resume under its old wid would corrupt ownership bookkeeping. The
fenced worker exits instead.

The one change from the reference's copy: every message is received
with :func:`recv`, which reads each one into a single buffer of its
size (CPython's ``Connection.recv`` allocates the whole remainder of the
message for every read of the pipe's few kilobytes).
"""

from __future__ import annotations

import os
import pickle
import secrets
import struct
import threading
import time
from collections import deque
from multiprocessing.connection import (AuthenticationError, Client,
                                        Listener, answer_challenge,
                                        deliver_challenge)
from typing import Any, Optional, Tuple

__all__ = ["AuthenticationError", "HeadListener", "PipeLink",
           "ReconnectingClient", "WorkerFencedError", "authed_connect",
           "new_authkey", "recv"]


def _read_exact(fd: int, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = os.read(fd, n - len(out))
        if not chunk:
            if not out:
                raise EOFError
            raise OSError("got end of file during message")
        out += chunk
    return out


def recv(conn, on_start=None):
    """``conn.recv()``, with the message read into one buffer of its
    size. ``Connection.recv`` asks ``os.read`` for every byte still
    missing, so each read of a pipe's (or socket's) few kilobytes
    allocates the whole remainder: O(n²) for a message of n bytes. Under
    a gVisor kernel (``runsc``) that held a 0.2 GB object to 11 MB/s
    each way between the head and a worker, and 5 GB moved at 377–403
    MB/s read this way (``PERF.md`` §6). The framing is
    ``Connection``'s: a 4-byte big-endian size, or -1 and an 8-byte
    size. ``conn`` is anything with the ``fileno()`` of such a
    connection (a chaos wrapper too); ``on_start``, where given, is
    called with the message's size once its header has arrived, before
    its body is read."""
    fd = conn.fileno()
    size, = struct.unpack("!i", _read_exact(fd, 4))
    if size == -1:
        size, = struct.unpack("!Q", _read_exact(fd, 8))
    if on_start is not None:
        on_start(size)
    buf = bytearray(size)
    view = memoryview(buf)
    got = 0
    while got < size:
        n = os.readv(fd, [view[got:]])
        if n == 0:
            raise OSError("got end of file during message")
        got += n
    del view
    return pickle.loads(buf)


def new_authkey() -> bytes:
    return secrets.token_bytes(24)


def _as_key(authkey) -> bytes:
    if authkey is None:
        return new_authkey()
    if isinstance(authkey, str):
        return authkey.encode("utf-8")
    return bytes(authkey)


class WorkerFencedError(ConnectionError):
    """The head refused this worker's (re)join — it was already declared
    dead (or chaos told the head to refuse). The worker must exit."""


class HeadListener:
    """Accept-side of the TCP transport, with a rotatable authkey.

    ``multiprocessing.connection.Listener`` bakes its authkey in at
    construction; we bind the listener *without* one and run the same
    mutual HMAC challenge manually per accept against ``self.authkey``,
    which :meth:`rotate` can swap at any time. A client holding a stale
    key fails the challenge — counted in ``auth_failures``, never
    served."""

    def __init__(self, address: Tuple[str, int] = ("127.0.0.1", 0),
                 authkey: Optional[bytes] = None, backlog: int = 16):
        self._listener = Listener(tuple(address), backlog=backlog)
        self.authkey = _as_key(authkey)
        self.address: Tuple[str, int] = self._listener.address
        self.auth_failures = 0
        self.rotations = 0

    def accept(self):
        """Accept + mutually authenticate one connection. Raises
        :class:`AuthenticationError` (counted) on a bad key, ``OSError``
        when the listener is closed."""
        conn = self._listener.accept()
        key = self.authkey   # snapshot: a rotation racing the handshake
        try:                 # judges this client by one consistent key
            deliver_challenge(conn, key)
            answer_challenge(conn, key)
        except (AuthenticationError, EOFError, OSError) as exc:
            self.auth_failures += 1
            try:
                conn.close()
            except OSError:
                pass
            raise AuthenticationError(f"client failed auth: {exc}")
        return conn

    def rotate(self, new: Optional[bytes] = None) -> bytes:
        """Swap the authkey (callers broadcast ``("rekey", key)`` to
        connected workers so their reconnects keep working)."""
        self.authkey = _as_key(new)
        self.rotations += 1
        return self.authkey

    def close(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass


def authed_connect(address: Tuple[str, int], authkey: bytes):
    """Client-side connect + mutual HMAC challenge (the inverse order of
    :meth:`HeadListener.accept`)."""
    conn = Client(tuple(address))
    try:
        answer_challenge(conn, authkey)
        deliver_challenge(conn, authkey)
    except (AuthenticationError, EOFError, OSError):
        try:
            conn.close()
        except OSError:
            pass
        raise
    return conn


class PipeLink:
    """Single-host link over an inherited ``multiprocessing``
    connection. The lock serializes the worker's concurrent senders
    (main loop + heartbeat thread); a pipe cannot reconnect, so any
    failure is terminal for the link."""

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()
        self.reconnect_attempts = 0

    def send(self, msg, droppable: bool = False) -> None:
        with self._lock:
            try:
                self._conn.send(msg)
            except (OSError, BrokenPipeError, ValueError, TypeError):
                if not droppable:
                    raise

    def recv(self):
        return recv(self._conn)

    def drop(self) -> None:
        """Sever the link (chaos drill). Pipes cannot reconnect, so this
        is equivalent to the head losing the worker."""
        self.close()

    def set_authkey(self, key: bytes) -> None:   # protocol parity
        pass

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


class ReconnectingClient:
    """Worker-side TCP link: authed connect, attach/join handshake,
    reconnect-with-exponential-backoff on transient failure, and an
    outbox so results produced while disconnected are delivered after
    the rejoin instead of lost.

    Thread contract: ``recv`` is called from exactly one thread (the
    worker main loop) and drives reconnection; ``send`` may be called
    from any thread and never blocks on a reconnect — on a dead link a
    non-droppable message parks in the outbox (flushed post-rejoin) and
    a droppable one (heartbeats) is discarded."""

    def __init__(self, address: Tuple[str, int], authkey: bytes,
                 wid: Optional[int] = None, sim_gpu: bool = False,
                 max_tries: int = 8, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 welcome_timeout_s: float = 10.0):
        self.address = tuple(address)
        self.authkey = _as_key(authkey)
        self.wid = wid
        self.sim_gpu = sim_gpu
        self.max_tries = max_tries
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.welcome_timeout_s = welcome_timeout_s
        self._conn = None
        self._lock = threading.RLock()
        self._outbox: deque = deque()
        self._connected_once = False
        self.reconnect_attempts = 0   # failed connect attempts, total
        self.reconnects = 0           # successful re-attaches
        self.fenced = False

    # -- connection management -------------------------------------------
    def connect(self) -> None:
        """Initial connect + handshake; raises if the head is
        unreachable within the retry budget or the join is denied."""
        if not self._reconnect():
            raise WorkerFencedError(
                f"could not attach to head at {self.address}")

    def _handshake(self, conn) -> None:
        if self.wid is None:
            conn.send(("join", self.sim_gpu))
        else:
            conn.send(("attach", self.wid, self.reconnect_attempts))
        if not conn.poll(self.welcome_timeout_s):
            raise OSError("no handshake reply from head")
        reply = recv(conn)
        if reply[0] == "denied":
            raise WorkerFencedError(str(reply[1:]))
        self.wid = reply[1]

    def _reconnect(self) -> bool:
        """(Re)establish the link. Returns False once fenced — by a
        denial or by exhausting the retry budget."""
        with self._lock:
            if self.fenced:
                return False
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
            first = not self._connected_once
            delay = self.base_delay_s
            for _ in range(self.max_tries):
                try:
                    conn = authed_connect(self.address, self.authkey)
                except (AuthenticationError, OSError, EOFError):
                    self.reconnect_attempts += 1
                    time.sleep(delay)
                    delay = min(self.max_delay_s, delay * 2)
                    continue
                try:
                    self._handshake(conn)
                except WorkerFencedError:
                    self.fenced = True
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return False
                except (OSError, EOFError):
                    self.reconnect_attempts += 1
                    try:
                        conn.close()
                    except OSError:
                        pass
                    time.sleep(delay)
                    delay = min(self.max_delay_s, delay * 2)
                    continue
                self._conn = conn
                self._connected_once = True
                if not first:
                    self.reconnects += 1
                self._flush_locked()
                return True
            self.fenced = True
            return False

    def _flush_locked(self) -> None:
        while self._outbox and self._conn is not None:
            try:
                self._conn.send(self._outbox[0])
                self._outbox.popleft()
            except (OSError, BrokenPipeError, ValueError, TypeError):
                self._mark_broken(self._conn)
                break

    def _mark_broken(self, conn) -> None:
        if self._conn is conn:
            try:
                conn.close()
            except OSError:
                pass
            self._conn = None

    # -- link protocol ----------------------------------------------------
    def send(self, msg, droppable: bool = False) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.send(msg)
                    return
                except (OSError, BrokenPipeError, ValueError, TypeError):
                    self._mark_broken(self._conn)
            if not droppable:
                self._outbox.append(msg)
            # the recv thread (which notices the same dead socket
            # promptly — the peer closed it) drives the reconnect and
            # flushes the outbox after the rejoin handshake

    def recv(self):
        """Blocking receive; transparently reconnects on transient
        failure. Raises ``EOFError`` once the link is fenced or the
        retry budget is spent — the worker's signal to exit."""
        while True:
            with self._lock:
                conn = self._conn
            if conn is None:
                if not self._reconnect():
                    raise EOFError("transport fenced / retries exhausted")
                continue
            try:
                return recv(conn)
            except (EOFError, OSError):
                with self._lock:
                    self._mark_broken(conn)

    def drop(self) -> None:
        """Sever the current socket (chaos drill: transient failure).
        The next ``recv`` reconnects with backoff."""
        with self._lock:
            if self._conn is not None:
                self._mark_broken(self._conn)

    def set_authkey(self, key: bytes) -> None:
        """Adopt a rotated authkey for future reconnects."""
        with self._lock:
            self.authkey = _as_key(key)

    def close(self) -> None:
        with self._lock:
            self.fenced = True
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
