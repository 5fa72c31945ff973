"""The port's auto-sharding planner (``repro_torch.core.planner``) against
the reference's (``repro.core.planner``), and the reference's planner
tests on the port.

The reference side runs in a subprocess (``tests/torch_reference.py``)
with 512 placeholder XLA host devices, on jax meshes of the production
shapes: the TPU pod's (16, 16) and (2, 16, 16), and the port's H100
meshes, (32, 8) and (2, 32, 8). The port plans the same cells on
stand-in meshes of those shapes (the planner reads axis names and sizes
only) with ``chip=`` built from the reference's chip, as the subprocess
reads it, so that both price a cell alike. Tolerances: integers,
strategies, legality and specs exactly; the estimate's terms to 1e-12
relative.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core import planner as PL
from repro_torch.core.cost import H100_SXM, ChipSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T

from torch_reference import run_reference

REL = 1e-12

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "32x8": ((32, 8), ("data", "model")),
    "2x32x8": ((2, 32, 8), ("pod", "data", "model")),
}

REFERENCE_CODE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, json, math
jax.config.update("jax_enable_x64", False)
from jax.sharding import Mesh
from repro.configs import ARCHS, SHAPES, get_config
from repro.core import planner as PL
from repro.core.cost import TPU_V5E
from repro.models import transformer as T

MESHES = json.loads(str(inputs["meshes"]))
devs = np.array(jax.devices())
meshes = {k: Mesh(devs[:math.prod(s)].reshape(s), tuple(n))
          for k, (s, n) in MESHES.items()}


def spec(sh):
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def batch_shapes(cfg, kind, B, S):
    if kind == "decode":
        return {"tokens": (B, 1)}
    out = {"embeds": (B, S, cfg.d_model)} if cfg.embeds_input \\
        else {"tokens": (B, S)}
    if kind == "train":
        out["labels"] = (B, S)
    if cfg.is_encdec:
        out["src_embeds"] = (B, S, cfg.d_model)
    return out


res = {"chip": dataclasses.asdict(TPU_V5E), "cells": {}, "counts": {}}
for arch in ARCHS:
    cfg = get_config(arch)
    res["counts"][arch] = [cfg.param_count(), cfg.active_param_count()]
    holder = {}

    def cap():
        params, specs = T.init_params(cfg, jax.random.key(0))
        holder["specs"] = specs
        return params

    p_shapes = jax.eval_shape(cap)
    for sname, shape in SHAPES.items():
        B, S = shape.global_batch, shape.seq_len
        cross = S if cfg.is_encdec else 0
        c_shapes = jax.eval_shape(lambda: T.init_caches(
            cfg, B, S, cross_len=cross, uniform_index=True))
        for mname, mesh in meshes.items():
            plan = PL.plan(cfg, holder["specs"], p_shapes, mesh, seq=S,
                           batch=B, kind=shape.kind)
            e = plan.estimate
            leaves = jax.tree_util.tree_flatten_with_path(
                plan.param_shardings)[0]
            caches = jax.tree_util.tree_flatten_with_path(c_shapes)[0]
            res["cells"][f"{arch}|{sname}|{mname}"] = {
                "strategy": plan.strategy.name, "microbatch": e.microbatch,
                "terms": [e.hbm_bytes_per_chip, e.compute_s, e.memory_s,
                          e.collective_s],
                "legal": bool(e.legal),
                "alternatives": [[a.strategy, a.hbm_bytes_per_chip,
                                  a.compute_s, a.memory_s, a.collective_s,
                                  bool(a.legal)] for a in plan.alternatives],
                "params": {path_str(p): spec(s) for p, s in leaves},
                "batch": {k: spec(PL.batch_sharding(
                    mesh, plan.strategy, B, extra_dims=len(v) - 1))
                    for k, v in batch_shapes(cfg, shape.kind, B, S).items()},
                "caches": {path_str(p): [list(s.shape), spec(
                    PL.cache_sharding(mesh, plan.strategy, cfg, B,
                                      tuple(s.shape)))]
                    for p, s in caches},
            }
outputs["plans"] = np.asarray(json.dumps(res))
"""


class StandIn:
    """The reference's plain mesh stand-in: axis names, a shape dict and
    a size."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.size = int(np.prod(shape))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = run_reference(REFERENCE_CODE,
                        {"meshes": np.asarray(json.dumps(MESHES))},
                        tmp_path_factory.mktemp("planner"),
                        timeout_s=900.0)
    return json.loads(str(out["plans"]))


_PORT_PARAMS: dict = {}


def port_params(arch):
    """(config, fake params at full size, specs) of ``arch``."""
    if arch not in _PORT_PARAMS:
        cfg = get_config(arch)
        with FakeTensorMode():
            params, specs = T.init_params(cfg,
                                          torch.Generator().manual_seed(0))
        _PORT_PARAMS[arch] = (cfg, params, specs)
    return _PORT_PARAMS[arch]


def _spec_json(sh):
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) \
            and not isinstance(tree, PL.MeshSharding):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _batch_shapes(cfg, kind, B, S):
    if kind == "decode":
        return {"tokens": (B, 1)}
    out = {"embeds": (B, S, cfg.d_model)} if cfg.embeds_input \
        else {"tokens": (B, S)}
    if kind == "train":
        out["labels"] = (B, S)
    if cfg.is_encdec:
        out["src_embeds"] = (B, S, cfg.d_model)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(reference, arch):
    cfg = get_config(arch)
    assert [cfg.param_count(), cfg.active_param_count()] \
        == reference["counts"][arch]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_the_reference(reference, arch, shape_name, mesh_name):
    """Strategy, microbatch, the estimate's terms (1e-12 relative) and
    legality, every alternative's, every parameter leaf's spec, and the
    batch and cache specs at the cell's shapes."""
    want = reference["cells"][f"{arch}|{shape_name}|{mesh_name}"]
    chip = ChipSpec(**reference["chip"])
    cfg, params, specs = port_params(arch)
    shape = SHAPES[shape_name]
    mesh = StandIn(*MESHES[mesh_name])
    B, S = shape.global_batch, shape.seq_len
    plan = PL.plan(cfg, specs, params, mesh, seq=S, batch=B,
                   kind=shape.kind, chip=chip)
    e = plan.estimate
    assert plan.strategy.name == want["strategy"]
    assert e.microbatch == want["microbatch"]
    assert e.legal == want["legal"]
    got = [e.hbm_bytes_per_chip, e.compute_s, e.memory_s, e.collective_s]
    assert all(_close(a, b) for a, b in zip(got, want["terms"])), \
        (got, want["terms"])
    alts = [[a.strategy, a.hbm_bytes_per_chip, a.compute_s, a.memory_s,
             a.collective_s, a.legal] for a in plan.alternatives]
    assert [a[0] for a in alts] == [a[0] for a in want["alternatives"]]
    for a, b in zip(alts, want["alternatives"]):
        assert a[5] == b[5] and all(_close(x, y)
                                    for x, y in zip(a[1:5], b[1:5]))
    port_specs = {k: _spec_json(v)
                  for k, v in _flat(plan.param_shardings).items()}
    assert port_specs == want["params"]
    batch = {k: _spec_json(PL.batch_sharding(mesh, plan.strategy, B,
                                             extra_dims=len(v) - 1))
             for k, v in _batch_shapes(cfg, shape.kind, B, S).items()}
    assert batch == want["batch"]
    cross = S if cfg.is_encdec else 0
    with FakeTensorMode():
        caches = T.init_caches(cfg, B, S, cross_len=cross,
                               uniform_index=True)
    got_caches = {k: [list(t.shape), _spec_json(PL.cache_sharding(
        mesh, plan.strategy, cfg, B, tuple(t.shape)))]
        for k, t in _flat(caches).items()}
    assert got_caches == want["caches"]


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandIn((2, 4, 8), ("pod", "data", "model"))
    sh = PL.MeshSharding(mesh, ((("pod", "data")), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert PL.MeshSharding(mesh, (None, None)).placements \
        == (Replicate(),) * 3
    with pytest.raises(AssertionError):
        PL.MeshSharding(mesh, (("data", "pod"), None))


def test_a_device_mesh_plans_as_its_stand_in():
    cfg, params, specs = port_params("stablelm_3b")
    mesh = mesh_mod.make_production_mesh()
    try:
        for kind, (S, B) in (("train", (4096, 256)),
                             ("decode", (32768, 128))):
            a = PL.plan(cfg, specs, params, mesh, seq=S, batch=B,
                        kind=kind)
            b = PL.plan(cfg, specs, params, StandIn(*MESHES["32x8"]),
                        seq=S, batch=B, kind=kind)
            assert dataclasses.asdict(a.estimate) \
                == dataclasses.asdict(b.estimate)
            assert {k: v.spec for k, v in _flat(a.param_shardings).items()} \
                == {k: v.spec for k, v in _flat(b.param_shardings).items()}
            assert a.describe() == b.describe()
    finally:
        mesh_mod.release()


# ---------------------------------------------------------------------------
# The reference's tests/test_planner.py on the port (a fake (2, 2) mesh)
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh22():
    mesh = mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
    yield mesh
    mesh_mod.release()


def _fsdp_tp(mesh):
    return [s for s in PL.make_strategies(mesh) if s.name == "fsdp_tp"][0]


def test_resolve_leaf_divisible(mesh22):
    spec = PL.resolve_leaf_spec((64, 16, 8), ("embed", "heads",
                                              "head_dim"),
                                _fsdp_tp(mesh22), mesh22)
    assert spec == ("data", "model", None)


def test_resolve_leaf_indivisible_falls_back(mesh22):
    """gemma2 pattern: heads=3 indivisible by model → try head_dim."""
    spec = PL.resolve_leaf_spec((64, 3, 8), ("embed", "heads",
                                             "head_dim"),
                                _fsdp_tp(mesh22), mesh22)
    # heads (3) not divisible by 2 → head_dim picks up the model axis
    assert spec[1] is None
    assert spec[2] == "model"


def test_mesh_axis_used_once_per_leaf(mesh22):
    spec = PL.resolve_leaf_spec((64, 16, 16, 8),
                                ("embed", "heads", "kv_heads",
                                 "head_dim"), _fsdp_tp(mesh22), mesh22)
    used = []
    for part in spec:
        if part is None:
            continue
        used.extend(part if isinstance(part, tuple) else (part,))
    assert len(used) == len(set(used)), spec


def test_effective_dp_replication_guard(mesh22):
    axes = PL.axis_names(mesh22)
    total = PL.mesh_chips(mesh22)
    assert PL.effective_dp(mesh22, axes, total) == total
    assert PL.effective_dp(mesh22, axes, 1) == 1


def test_adapt_microbatch_prefers_full_dp(mesh22):
    cfg = get_config("stablelm_3b")  # cfg.microbatch = 2
    mb, eff = PL.adapt_microbatch(cfg, 256, mesh22, PL.axis_names(mesh22))
    assert 256 % mb == 0
    assert (256 // mb) % eff == 0
    assert eff == PL.mesh_chips(mesh22)  # always achievable at batch 256


def test_plan_picks_legal_strategy_small(mesh22):
    cfg, params, specs = port_params("xlstm_125m")
    plan = PL.plan(cfg, specs, params, mesh22, seq=128, batch=8,
                   kind="train")
    assert plan.estimate.legal or plan.strategy.name == "dp"
    # shardings tree mirrors params tree
    assert len(_flat(plan.param_shardings)) == len(_flat(params))
    for sh, p in zip(_flat(plan.param_shardings).values(),
                     _flat(params).values()):
        assert len(sh.spec) == p.dim() and len(sh.placements) == 2


@pytest.mark.parametrize("chip_name,mesh_shape", [("reference", (16, 16)),
                                                  ("h100", (8, 8))])
def test_estimate_memory_legality_340b(reference, chip_name, mesh_shape):
    """fp32 Adam for nemotron-340B does not fit where the 8-bit variant
    does: on the reference's chip at its 256-chip pod, and on the H100
    (80 GB, datasheet) at 64 cards, where fp32 moments outgrow 92 % of
    its memory."""
    chip = ChipSpec(**reference["chip"]) if chip_name == "reference" \
        else H100_SXM
    mesh = StandIn(mesh_shape, ("data", "model"))
    cfg8 = get_config("nemotron_4_340b")
    assert cfg8.opt_8bit
    st = _fsdp_tp(mesh)
    est8 = PL.estimate_plan(cfg8, st, mesh, 4096, 256, "train", chip)
    assert est8.legal, est8
    cfg32 = dataclasses.replace(cfg8, opt_8bit=False)
    est32 = PL.estimate_plan(cfg32, st, mesh, 4096, 256, "train", chip)
    assert not est32.legal
