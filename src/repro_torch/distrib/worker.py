"""Worker-process main loop.

One worker = one OS process holding: a pipe back to the head, a local
object cache (its shard of the object plane), a cache of pfor body
blobs (skeleton + broadcast cells, assembled lazily), and the device
profile it measured at startup.

The loop is deliberately single-threaded: the head resolves every
object transfer *before* dispatching a task, so a worker never needs to
service a fetch while computing — no cross-worker deadlock is possible
by construction.

Wire protocol (pickled tuples over a ``multiprocessing`` connection —
the same framing a TCP transport would use):

  head → worker: ("task", tid, spec)
                 | ("blob", bid, skeleton_or_None, {cell: value})
                 | ("unblob", bid) | ("get", oid) | ("free", oid)
                 | ("ping", payload) | ("profile",) | ("shutdown",)
                 | ("rekey", authkey) | ("chaos", op, arg)
                 | ("welcome", wid) | ("denied", reason)   # handshake
  worker → head: ("hello", profile, t_mono)
                 | ("done", tid, oid, nbytes, payload, ran_backend,
                    spans_or_None, accel_stats_or_None)
                 | ("err", tid, message, traceback)
                 | ("obj", oid, payload) | ("pong", nbytes, t_mono)
                 | ("hb", t_mono)   # TCP; a pipe worker sends a bare
                                    # t_mono on its heartbeat pipe
                 | ("attach", wid, attempts) | ("join", sim_gpu)

where ``payload`` is ``("v", value)`` when the value travels with the
message and ``None`` when it stayed (or was not found) on the worker —
the wrapper keeps a task that legitimately *returns* ``None``
distinguishable from a result that was kept remote.

A "blob" message with ``skeleton=None`` is a *delta*: the worker already
holds the body's skeleton and receives only the cells whose content hash
changed on the head (the serving-loop path). Blob bodies persist across
pfor calls; after every chunk the written broadcast cells are rolled
back to pristine, so the head's record of what each worker holds stays
content-exact.

Tracing (``repro_torch.obs``): when a task spec carries ``trace=True`` the
worker measures its execution phases — deserialize (body assembly),
restore (sliced-cell rebase), run, diff — as ``(name, t0, t1, args)``
tuples on its own ``time.perf_counter()`` clock and piggybacks them on
the "done" message; no extra round-trips. The ``t_mono`` stamp on
"hello"/"pong" replies is what lets the head estimate this worker's
clock offset and land the spans on one aligned timeline.
"""

from __future__ import annotations

import pickle
import threading
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import accel
from ..core import txp
from ..kernels import api as kernel_api
from .device import measure_profile
from .serial import assemble_fn, closure_arrays, loads_fn, rebase_chunk

# results at or below this many bytes ride back inline with "done"
INLINE_MAX = 32 * 1024


def _chunk_updates(body, lo: int, hi: int, written: Tuple[str, ...],
                   spans=None) -> Dict[str, tuple]:
    """Run a pfor chunk and extract its disjoint-region writes.

    The chunk writes in place into the *worker's* copies of the captured
    arrays; the head needs (indices, values) per written array to merge
    into the real ones. ``written`` (from the kernel's schedule) narrows
    the diff to arrays the pfor body can write; when empty we
    conservatively diff every captured array. Sliced arrays hold only
    the chunk's rows, so their update indices are chunk-local — the head
    re-bases them during the gather.

    Written arrays are rolled back to their pre-run contents afterwards
    (success *or* failure): cached broadcast cells must stay equal to
    what the head last shipped for the changed-cells-only protocol to be
    sound, and a retried chunk must never diff against a previous
    attempt's partial writes."""
    arrays = {n: v for n, v in closure_arrays(body).items()
              if isinstance(v, np.ndarray)}
    targets = {n: a for n, a in arrays.items()
               if not written or n in written}
    snaps = {n: a.copy() for n, a in targets.items()}
    try:
        t0 = time.perf_counter()
        body(lo, hi)
        t1 = time.perf_counter()
        if spans is not None:
            spans.append(("run", t0, t1, None))
        updates: Dict[str, tuple] = {}
        for name, arr in targets.items():
            mask = np.asarray(arr != snaps[name])
            if mask.any():
                idx = np.flatnonzero(mask.ravel())
                updates[name] = (idx, np.asarray(arr.ravel()[idx]))
        if spans is not None:
            spans.append(("diff", t1, time.perf_counter(), None))
        return updates
    finally:
        for name, arr in targets.items():
            np.copyto(np.asarray(arr), snaps[name])


class WorkerState:
    def __init__(self, wid: int, sim_gpu: bool = False,
                 device: str = "cuda"):
        self.wid = wid
        self.sim_gpu = sim_gpu    # pose as a GPU worker (hetero CI/demo)
        self.device = device      # where the kernel runtime computes
        self.objects: Dict[int, Any] = {}     # local object-plane shard
        self.blob_skel: Dict[int, bytes] = {}
        self.blob_cells: Dict[int, Dict[str, Any]] = {}
        self.bodies: Dict[int, tuple] = {}    # bid → (fn, name→cell)
        # (bid, name, lo, hi) → cached chunk rows: the head skips
        # re-shipping rows whose content hash it already sent here
        self.sliced_rows: Dict[tuple, np.ndarray] = {}
        self.tasks_run = 0
        self.chunks_run = 0

    # -- blob cache --------------------------------------------------------
    def update_blob(self, bid: int, skeleton, delta: Dict[str, bytes]
                    ) -> None:
        """Install a blob skeleton and/or changed broadcast cells. The
        delta carries the head's per-cell pickles (the exact bytes it
        content-hashed), so what this worker holds is byte-equal to the
        head's bookkeeping."""
        if skeleton is not None:
            self.blob_skel[bid] = skeleton
            self.bodies.pop(bid, None)   # re-assemble with the new code
            self.blob_cells[bid] = {}
        cells = self.blob_cells.setdefault(bid, {})
        entry = self.bodies.get(bid)
        for name, pkl in delta.items():
            val = pickle.loads(pkl)
            cells[name] = val
            if isinstance(val, np.ndarray):
                # broadcast cells persist across chunk tasks (rollback
                # keeps them pristine), so their device copies can too
                accel.remember(val)
            if entry is not None and name in entry[1]:
                # live body: swap the changed cell in place
                entry[1][name].cell_contents = val

    def drop_blob(self, bid: int) -> None:
        self.blob_skel.pop(bid, None)
        self.blob_cells.pop(bid, None)
        self.bodies.pop(bid, None)
        for key in [k for k in self.sliced_rows if k[0] == bid]:
            del self.sliced_rows[key]

    def _body_for(self, bid: int) -> tuple:
        entry = self.bodies.get(bid)
        if entry is None:
            skel = self.blob_skel.get(bid)
            if skel is None:
                # the marker tells the head its shipped-state record for
                # us is stale (dropped blob message / restarted worker):
                # it resets the record so the retry re-ships in full
                raise KeyError(f"blob-missing:{bid}")
            entry = assemble_fn(skel, self.blob_cells[bid])
            self.bodies[bid] = entry
        return entry

    # -- task execution ---------------------------------------------------
    def resolve_args(self, wire_args) -> list:
        out = []
        for entry in wire_args:
            kind = entry[0]
            if kind == "val":
                out.append(entry[1])
            elif kind == "obj":            # value attached by the head
                # deliberately NOT cached: the head only ever resolves
                # ("loc", oid) against objects this worker *produced*,
                # so retaining relayed args would only leak memory
                out.append(entry[2])
            elif kind == "loc":            # resident here already
                out.append(self.objects[entry[1]])
            else:  # pragma: no cover
                raise ValueError(f"bad arg entry {kind!r}")
        return out

    def run_task(self, spec, spans=None) -> Any:
        if spec["kind"] == "chunk":
            lo, hi = spec["lo"], spec["hi"]
            bid = spec["blob_id"]
            t0 = time.perf_counter()
            body, cellmap = self._body_for(bid)
            t1 = time.perf_counter()
            for name, wire in (spec.get("sliced") or {}).items():
                # per-chunk rows, re-based so the body's global leading-
                # axis indices resolve. ("rows", arr) carries fresh rows
                # (cached for next time); ("keep",) means the head's
                # content hash matched what it last shipped for this
                # exact range — rollback keeps the cached copy pristine,
                # so reuse is byte-exact
                if wire[0] == "keep":
                    rows = self.sliced_rows.get((bid, name, lo, hi))
                    if rows is None:
                        # stale head record (restart/drop): the marker
                        # makes the head reset it and re-ship in full
                        raise KeyError(f"rows-missing:{bid}")
                else:
                    rows = wire[1]
                    self.sliced_rows[(bid, name, lo, hi)] = rows
                    accel.remember(rows)
                cellmap[name].cell_contents = rebase_chunk(rows, lo)
            if spans is not None:
                spans.append(("deserialize", t0, t1, None))
                spans.append(("restore", t1, time.perf_counter(), None))
            self.chunks_run += 1
            return _chunk_updates(body, lo, hi,
                                  tuple(spec.get("written") or ()),
                                  spans)
        fn = loads_fn(spec["fn_blob"])
        args = self.resolve_args(spec["args"])
        self.tasks_run += 1
        t0 = time.perf_counter()
        result = fn(*args)
        if spans is not None:
            spans.append(("run", t0, time.perf_counter(), None))
        return result


def _make_link(conn, wid: Optional[int], sim_gpu: bool):
    """Build the transport link: an inherited pipe connection, or a
    ``("tcp", address, authkey)`` endpoint the worker dials (and
    re-dials, with exponential backoff) itself."""
    from .transport import PipeLink, ReconnectingClient
    if isinstance(conn, tuple) and conn and conn[0] == "tcp":
        _, address, authkey = conn
        link = ReconnectingClient(address, authkey, wid=wid,
                                  sim_gpu=sim_gpu)
        link.connect()   # attach/join handshake resolves our wid
        return link
    return PipeLink(conn)


def worker_main(conn, wid: Optional[int] = None, sim_gpu: bool = False,
                hb_interval_s: float = 0.0, device: str = "cuda",
                hb_conn=None) -> None:
    """Entry point of the worker process. ``conn`` is an inherited pipe
    connection or a ``("tcp", (host, port), authkey)`` endpoint (the
    multi-host path — also reachable via ``python -m
    repro_torch.distrib.worker --connect host:port --authkey <hex>`` from any
    machine). ``device`` is where this worker's twins compute — torch
    twins through :mod:`repro_torch.core.txp` (``__txp``), cuda twins
    through the kernel runtime :mod:`repro_torch.kernels.api`
    (``__cuk``): ``"cuda"`` (the default) runs them on the card and
    raises on a host without CUDA, ``"cpu"`` runs the torch twins and
    the kernels' plain torch versions on the CPU. The kernel library is
    built by the head before any worker starts; a worker only loads it.
    ``sim_gpu`` makes
    the profile pose as a GPU worker (CPU execution) so heterogeneous
    routing is exercisable on GPU-less hosts; the env var
    ``REPRO_DISTRIB_SIM_GPU`` (see :mod:`.device`) does the same by wid.

    With ``hb_interval_s > 0`` a daemon thread sends liveness beacons:
    a bare ``t_mono`` on ``hb_conn`` when the head gave the worker a
    heartbeat pipe of its own (pipe fleets: a beat never waits behind a
    large result), else ``("hb", t_mono)`` on the link, ``droppable`` —
    a disconnected TCP window simply skips beats rather than queueing a
    burst for later."""
    from .transport import WorkerFencedError
    # both twin runtimes compute on this worker's device; binding raises
    # when the device is absent
    kernel_api.set_device(device)
    txp.set_device(device)
    try:
        link = _make_link(conn, wid, sim_gpu)
    except (WorkerFencedError, OSError, EOFError):
        return   # head unreachable or this wid is fenced: nothing to do
    wid = getattr(link, "wid", wid) if wid is None else wid
    state = WorkerState(wid, sim_gpu=sim_gpu, device=device)
    stop = threading.Event()
    hb_silenced = threading.Event()   # chaos: hang with silent beacons

    def _heartbeat() -> None:
        while not stop.wait(hb_interval_s):
            if hb_silenced.is_set():
                continue
            if hb_conn is None:
                link.send(("hb", time.perf_counter()), droppable=True)
                continue
            try:
                hb_conn.send(time.perf_counter())
            except (OSError, ValueError):
                return   # the head is gone: the task pipe ends the loop

    if hb_interval_s and hb_interval_s > 0:
        threading.Thread(target=_heartbeat, name=f"worker-hb-{wid}",
                         daemon=True).start()
    try:
        # the perf_counter stamp rides right next to the send so the
        # head's receive-time-minus-stamp offset estimate is bounded by
        # one one-way pipe latency, not by profile-measurement time
        link.send(("hello",
                   measure_profile(wid, sim_gpu=sim_gpu or None,
                                   device=device)
                   .as_dict(), time.perf_counter()))
    except (EOFError, OSError, BrokenPipeError):
        stop.set()
        return
    slow_s = 0.0   # chaos: injected per-task latency
    while True:
        try:
            msg = link.recv()
        except (EOFError, OSError):
            break  # head is gone (or this link is fenced)
        kind = msg[0]
        try:
            if kind == "task":
                _, tid, spec = msg
                if slow_s > 0:
                    time.sleep(slow_s)
                spans = [] if spec.get("trace") else None
                try:
                    result = state.run_task(spec, spans)
                except BaseException as exc:  # noqa: BLE001
                    link.send(("err", tid, repr(exc),
                               traceback.format_exc()))
                    continue
                oid = spec["out_oid"]
                nbytes = int(getattr(result, "nbytes", 0) or 0)
                # chunk dones echo which body backend actually *ran* —
                # the head's executed-chunk telemetry must not trust
                # dispatch intent (a cuda chunk may have been downgraded
                # and re-run as torch)
                ran = (spec.get("backend", "np")
                       if spec["kind"] == "chunk" else None)
                # chunk dones also carry the accel counter deltas
                # (batched path, residency, plus the kernel runtime's
                # call counters)
                # for head aggregation
                wstats = (accel.take_stats()
                          if spec["kind"] == "chunk" else None)
                if wstats is not None:
                    wstats.update(kernel_api.take_stats())
                if spec.get("gather") or nbytes <= INLINE_MAX:
                    link.send(("done", tid, oid, nbytes, ("v", result),
                               ran, spans, wstats))
                else:
                    state.objects[oid] = result
                    link.send(("done", tid, oid, nbytes, None, ran,
                               spans, wstats))
            elif kind == "blob":
                _, bid, skeleton, delta = msg
                state.update_blob(bid, skeleton, delta)
            elif kind == "unblob":
                state.drop_blob(msg[1])
            elif kind == "free":
                # ownership moved to the head (post-fetch): drop our copy
                state.objects.pop(msg[1], None)
            elif kind == "get":
                oid = msg[1]
                if oid in state.objects:
                    link.send(("obj", oid, ("v", state.objects[oid])))
                else:
                    link.send(("obj", oid, None))
            elif kind == "ping":
                link.send(("pong", len(msg[1]), time.perf_counter()))
            elif kind == "profile":
                # re-measure on request: the head serializes these so
                # fleet micro-benchmarks never contend with each other
                link.send(("hello",
                           measure_profile(state.wid,
                                           sim_gpu=state.sim_gpu or None,
                                           device=state.device)
                           .as_dict(), time.perf_counter()))
            elif kind == "rekey":
                # the head rotated the transport authkey; future
                # reconnects must present the new one
                link.set_authkey(msg[1])
            elif kind == "chaos":
                _, op, arg = msg
                if op == "hang":
                    arg = arg or {}
                    if arg.get("silence_hb", True):
                        hb_silenced.set()
                    secs = arg.get("seconds")
                    time.sleep(secs if secs is not None else 1e9)
                    hb_silenced.clear()
                elif op == "slow":
                    slow_s = float(arg or 0.0)
                elif op == "drop_conn":
                    link.drop()
                elif op == "babble":
                    # deliberately malformed: too short to unpack
                    link.send(("done",), droppable=True)
                elif op == "exit":
                    break
            elif kind == "shutdown":
                break
        except (EOFError, OSError, BrokenPipeError):
            break
    stop.set()
    link.close()
    if hb_conn is not None:
        hb_conn.close()


def _main() -> None:   # pragma: no cover - exercised via subprocess
    """CLI for joining a worker to a remote head over TCP:

        python -m repro_torch.distrib.worker \\
            --connect HOST:PORT --authkey HEX [--device cuda] [--sim-gpu]
            [--hb 1.0]
    """
    import argparse
    ap = argparse.ArgumentParser(description="join a cluster head")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--authkey", required=True,
                    help="hex-encoded transport authkey")
    ap.add_argument("--device", default="cuda",
                    help="where the kernel runtime computes (cuda|cpu)")
    ap.add_argument("--sim-gpu", action="store_true")
    ap.add_argument("--hb", type=float, default=1.0,
                    help="heartbeat interval seconds (0 disables)")
    ns = ap.parse_args()
    host, _, port = ns.connect.rpartition(":")
    worker_main(("tcp", (host, int(port)), bytes.fromhex(ns.authkey)),
                wid=None, sim_gpu=ns.sim_gpu, hb_interval_s=ns.hb,
                device=ns.device)


if __name__ == "__main__":   # pragma: no cover
    _main()
