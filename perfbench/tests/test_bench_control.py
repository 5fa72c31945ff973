"""The control, at a size a test can hold: the reference computed in
fp8 (the precision below the configurations' bf16) put in the
program's place fails the cell's check, on three seeds."""

import pytest

from perfbench import calibrate
from perfbench.harness import bench
from perfbench.harness.check import judge
from tiny import tiny_root

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    return bench.Catalog(root, root / "perfbench")


def make_run(cat, cell, seed, seconds=0.5):
    return bench.Run(cat, cell, seed, seconds, False, "cpu", 0.0,
                     {"precisions": ("float32", "fp8")})


@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails(catalog, seed):
    r = make_run(catalog, "tiny_dense.tiny_train", seed)
    out = calibrate.train_readings(r, control=True, fault=True)
    assert judge(out["program"], r.limits["limits"])[0] is True
    assert judge(out["control"], r.limits["limits"])[0] is False
    assert judge(out["fault_half_batch"], r.limits["limits"])[0] is False


@pytest.mark.parametrize("cell", ["tiny_dense.tiny_serve",
                                  "tiny_moe.tiny_serve"])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(catalog, seed, cell):
    # a window long enough that a dozen requests or more finish
    r = make_run(catalog, cell, seed, seconds=3.0)
    res = catalog.module("kinds", "serve").run(r)
    assert res["requests"]["finished"] >= 12
    program = {k: v for k, v in res["readings"].items()
               if not k.endswith(".fp8")}
    verdict = calibrate.judged(
        {"program": program,
         "control": calibrate.control_readings(res["readings"])},
        r.limits["limits"])
    assert verdict == {"program": True, "control": False}
