"""Same-mesh parity of the dry run on a fake (2, 2) mesh: the port's
per-chip op count of each smoke cell (stablelm_3b, olmoe_1b_7b and
jamba_1_5_large_398b × train and decode × FSDP×TP and FSDP forced; seq
64, batch 8) against the reference's on a ``jax.make_mesh`` of the same
shape (``torch_dryrun_parity.py``). The (2, 2, 2) set is
``test_torch_dryrun_parity_3d.py``.

The bounds are one-sided (a port that counts less is not at fault):

  * per-chip FLOPs at most 1.25x the reference's, counted over all its
    dots (``flops_all_dots``: its ``hlo_analysis`` skips the dots XLA
    fused, every one of a step whose rows are one a chip);
  * per-chip collective bytes at most 3x the reference's;
  * the same strategy and microbatch as the reference's plan;
  * no flash op input a partial sum over one of the plan's batch axes,
    and every cache leaf after a decode step on its ``cache_sharding``
    placements.

Wall time: about 80 s alone, about 135 s beside the suite's other
workers (the reference's subprocess, about 75 s of it compiling the 12
cells, runs while this process counts the port's).
"""

import pytest

from torch_dryrun_parity import both_counts, smoke_cells

MESH = (2, 2)
CELLS = smoke_cells()
IDS = [f"{c['arch']}-{c['shape'][3]}-{c['strategy']}" for c in CELLS]
FLOPS_BOUND, COLLECTIVE_BOUND = 1.25, 3.0


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    return both_counts(CELLS, MESH, tmp_path_factory.mktemp("parity"))


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_flops_within_bound_of_the_reference(counts, i):
    ref, port = counts[0][i], counts[1][i]
    assert port["flops"] <= FLOPS_BOUND * ref["flops_all_dots"], (
        port["flops"], ref["flops_all_dots"], ref["flops"])


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_collective_bytes_within_bound_of_the_reference(counts, i):
    ref, port = counts[0][i], counts[1][i]
    assert port["collective_bytes"] <= COLLECTIVE_BOUND \
        * ref["collective_bytes"], (port["per_kind"], ref["per_kind"])


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_plan_and_placements(counts, i):
    ref, port = counts[0][i], counts[1][i]
    assert (port["strategy"], port["microbatch"]) == (ref["strategy"],
                                                      ref["microbatch"])
    assert port["flash_calls"] > 0
    assert port["flash_partial_batch"] == 0
    assert port["caches_moved"] == []
