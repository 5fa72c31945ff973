"""The port's worker process entry point.

``worker_main`` runs on the card unless told ``device="cpu"``: on a host
without CUDA it raises before it does anything. A pipe worker sends its
heartbeats on a pipe of their own, so they keep arriving while a large
result is still crossing the task pipe (a head reading only the task
pipe would see a busy worker fall silent and declare it dead).
"""

import inspect
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from repro_torch.distrib.device import measure_profile
from repro_torch.distrib.serial import dumps_fn
from repro_torch.distrib.worker import WorkerState, worker_main

HB_S = 0.05


def _big_result(n):
    return np.ones(n)


def test_worker_main_defaults_to_the_card():
    assert inspect.signature(worker_main).parameters["device"].default \
        == "cuda"
    assert inspect.signature(WorkerState).parameters["device"].default \
        == "cuda"
    with pytest.raises(TypeError):
        measure_profile(0)          # the caller names its device
    if torch.cuda.is_available():
        return
    head, child = mp.Pipe()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            worker_main(child)
        assert not head.poll(0.1)   # it said nothing, not even hello
    finally:
        head.close()
        child.close()


def test_heartbeats_arrive_while_a_large_result_is_blocked():
    ctx = mp.get_context("spawn")
    head, child = ctx.Pipe(duplex=True)
    hb_read, hb_write = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=worker_main,
                       args=(child, 0, False, HB_S, "cpu", hb_write),
                       daemon=True)
    proc.start()
    child.close()
    hb_write.close()
    try:
        assert head.poll(120), "worker never said hello"
        assert head.recv()[0] == "hello"
        n = 1 << 21                 # 16 MB: far more than a pipe buffers
        spec = {"kind": "fn", "fn_blob": dumps_fn(_big_result),
                "args": [("val", n)], "out_oid": 1, "gather": True}
        head.send(("task", 7, spec))
        # nobody reads the task pipe now, so the worker's main thread
        # stays blocked in the result's send; its beats must go on
        time.sleep(10 * HB_S)
        while hb_read.poll(0):
            hb_read.recv()
        beats, end = 0, time.monotonic() + 20 * HB_S
        while time.monotonic() < end:
            if hb_read.poll(HB_S):
                hb_read.recv()
                beats += 1
        assert beats >= 5, f"{beats} heartbeats in {20 * HB_S:.1f} s"
        msg = head.recv()
        assert msg[0] == "done" and msg[1] == 7
        np.testing.assert_array_equal(msg[4][1], np.ones(n))
        head.send(("shutdown",))
        proc.join(30)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(5)
        head.close()
        hb_read.close()
