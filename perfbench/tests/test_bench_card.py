"""A tiny cell of each kind run on the card, traced: the device time,
the idle share and the breakdown come from the profiler's trace. Runs
with ``python3 -m pytest -m cuda perfbench/tests``; skips without a
card."""

import json

import pytest

from perfbench import run
from tiny import tiny_root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_dense.tiny_train",
                                  "tiny_moe.tiny_serve"])
def test_traced_cell_on_the_card(card, cell, tmp_path, capsys):
    root = tiny_root(tmp_path)
    rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "2",
                   "--trace", "1"], device="cuda", root=root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["busy_s"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert line["breakdown"]["device_ops"]
