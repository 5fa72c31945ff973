"""Auto-sharding planner demo on the port: the paper's inter-node
parallelization at LM scale. Prints the legality/profitability decision
tree outcome for each assigned architecture on the port's production
mesh (a ``DeviceMesh`` of 256 H100s, (data=32, model=8), over a fake
process group) priced on ``H100_SXM`` (datasheet figures) — abstract, no
device allocation. The reference's ``examples/autoshard_demo.py`` on
the port.

    PYTHONPATH=src python examples/torch_autoshard_demo.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main():
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core import planner as PL
    from repro_torch.core.cost import H100_SXM
    from repro_torch.launch.mesh import make_production_mesh, release

    mesh = make_production_mesh()
    try:
        for arch in ARCHS:
            cfg = get_config(arch)
            cands = []
            for st in PL.make_strategies(mesh):
                est = PL.estimate_plan(cfg, st, mesh, 4096, 256, "train",
                                       H100_SXM)
                cands.append(est)
            best = min([e for e in cands if e.legal] or cands,
                       key=lambda e: e.step_s)
            fits = " ".join(f"{e.strategy}:{'ok' if e.legal else 'OOM'}"
                            for e in cands)
            print(f"{arch:24s} → {best.strategy:8s} mb={best.microbatch:<3d}"
                  f" hbm={best.hbm_bytes_per_chip / 2**30:6.2f}GiB "
                  f"step≈{best.step_s * 1e3:8.1f}ms  [{fits}]")
    finally:
        release()


if __name__ == "__main__":
    main()
