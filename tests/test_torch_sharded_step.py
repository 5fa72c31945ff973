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

On six ranks, a (3, 2) mesh, Jamba's FSDP train step with no mesh axis
for its experts (on (2, 2) the plan gives them one): each rank runs the
expert products on its own shard of the weights
(``moe._experts_on_shards``); its loss and each MoE leaf's gradient
within 1e-5 relative of the plain step's, with many rows a step (the
weights move to F by all-to-alls) and with few (the partial sums move
instead). About 15 s.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_sharded_step import FEW_ROWS, NO_EXPERT_AXIS, cases

ROOT = Path(__file__).resolve().parents[1]
CASES = cases()


def _run(tmp_path_factory, world: int) -> dict:
    tmp = tmp_path_factory.mktemp("sharded_step")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_step.py"),
         str(rank), str(world), str(tmp / "store"), str(tmp / "out.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _run(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def six_ranks(tmp_path_factory):
    return _run(tmp_path_factory, 6)


WIDE_CASES = [NO_EXPERT_AXIS, FEW_ROWS]


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


@pytest.mark.parametrize("case", MOE_CASES)
def test_the_square_mesh_gives_the_experts_an_axis(results, case):
    """On (2, 2) every MoE case's 16 padded experts split over a mesh
    axis, so the no-expert-axis path needs the (3, 2) mesh."""
    assert results[case]["moe_expert_axes"]


@pytest.mark.parametrize("case", WIDE_CASES)
def test_jamba_fsdp_train_on_3x2_takes_the_no_expert_axis_path(
        six_ranks, case):
    """The plan gives the experts no axis, and each of the step's MoE
    layers ran its products on the weights' shards."""
    res = six_ranks[case]
    assert res["moe_expert_axes"] is None
    assert res["shard_calls"] == res["moe_layers"] == 2


def test_many_rows_move_the_weights_and_few_the_sums(six_ranks):
    """12 x 32 tokens: ``wi`` and ``wg`` go to F by an all-to-all each
    way (2 MoE layers, forward and backward); 6 x 8: none moves, their
    partial sums are reduce-scattered."""
    assert six_ranks[NO_EXPERT_AXIS]["all_to_all"] == 2 * 2 * 2
    assert six_ranks[FEW_ROWS]["all_to_all"] == 0


@pytest.mark.parametrize("case", WIDE_CASES)
def test_no_expert_axis_step_equals_the_plain_step(six_ranks, case):
    """The loss and each MoE layer's ``wi``, ``wg``, ``wo`` and
    ``router`` gradient within 1e-5 relative of the plain step's."""
    errs = six_ranks[case]["errs"]
    assert sorted(k.rsplit("/", 1)[1] for k in errs if k != "loss") \
        == sorted(["router", "wg", "wi", "wo"] * 2)
    assert all(e <= 1e-5 for e in errs.values()), errs


@pytest.mark.parametrize("case", WIDE_CASES)
def test_no_expert_axis_step_drops_the_plain_steps_assignments(
        six_ranks, case):
    assert sum(six_ranks[case]["dropped"]) > 0
    assert six_ranks[case]["same_drops"]
