"""A whole sharded step on four real ranks: the smoke configs' decode
and train steps (stablelm_3b, jamba_1_5_large_398b cut to one period
for its Mamba scan and MoE, and olmoe_1b_7b) under FSDP×TP and FSDP
forced, built by the dry run's cell builders on a (2, 2) ``gloo`` mesh,
against the same step on plain tensors (``torch_sharded_step.py``, one
process a rank). This is what shows that the sharded step's gathers
keep each rank's values, and that each rank's routing of its own
tokens gives every assignment the position one routing of the whole
batch gives it: the MoE layers drop the same assignments (and some).
Tolerance: 1e-5 relative in float32 (of the logits, and of the loss and
gradient norm). About 40 s.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_sharded_step import cases

ROOT = Path(__file__).resolve().parents[1]
CASES = cases()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_step")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_step.py"),
         str(rank), "4", str(tmp / "store"), str(tmp / "out.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_equals_the_plain_step(results, case):
    assert results[case]["err"] <= 1e-5


@pytest.mark.parametrize("case", [c for c in CASES if "/decode/" in c])
def test_decode_keeps_batch_shards(results, case):
    """No flash input a partial sum; every cache leaf after the step on
    its ``cache_sharding`` placements."""
    assert results[case]["flash_ok"] and results[case]["caches_kept"]


MOE_CASES = [c for c in CASES if not c.startswith("stablelm_3b/")]


@pytest.mark.parametrize("case", MOE_CASES)
def test_sharded_routing_drops_the_plain_steps_assignments(results, case):
    """Every MoE layer's routing drops exactly the assignments the plain
    step's drops (the global flat order of positions within an
    expert)."""
    assert results[case]["dropped"] and results[case]["same_drops"]


def test_some_routing_drops_assignments(results):
    assert any(sum(results[c]["dropped"]) > 0 for c in MOE_CASES)
