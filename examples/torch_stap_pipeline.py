"""STAP radar pipeline on the port's raylite runtime (the paper's §5.3
scenario): auto-parallelized cube processing with fault injection and
elastic scale-up while the stream runs.

The text of the reference package's ``examples/stap_pipeline.py`` with
its imports taken from ``repro_torch``, and a ``--device`` option.
raylite (:mod:`repro_torch.runtime`) is the paper's in-process runtime:
its workers are host threads. On the default ``--device cuda`` each cube
chunk runs the kernel's torch twin on the card (the runtime's
``pfor_chunks`` counts them); ``--device cpu`` runs the numpy body in
the host threads instead, as the reference does.

    PYTHONPATH=src:. python examples/torch_stap_pipeline.py [--device cpu]
"""

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "src"))
sys.path.insert(0, str(_ROOT))

import argparse  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from benchmarks.stap import FFT_SIZE, make_data, stap_kernel, stap_ref  # noqa: E402
from repro_torch.core.compiler import compile_kernel  # noqa: E402
from repro_torch.runtime import (ElasticController, ElasticPolicy,  # noqa: E402
                                 TaskRuntime)


def main(device: str = "cuda") -> dict:
    """Run the pipeline and the drill; returns the runtime's stats."""
    n_cubes = 16
    cubes, sv, mf, out = make_data(n_cubes=n_cubes)
    out_ref = out.copy()
    stap_ref(cubes, sv, mf, out_ref, n_cubes, FFT_SIZE)

    rt = TaskRuntime(workers=2, speculation=True, device=device)
    ctrl = ElasticController(rt, ElasticPolicy(min_workers=2,
                                               max_workers=6))
    ctrl.start()
    try:
        ck = compile_kernel(stap_kernel, runtime=rt, tile=2)
        ck.pfor_config.distribute_threshold = 0
        print("[stap] generated distributed code:")
        print(ck.source("np"))

        t0 = time.perf_counter()
        out_got = out.copy()
        ck.call_variant("np", cubes, sv, mf, out_got, n_cubes, FFT_SIZE)
        wall = time.perf_counter() - t0
        assert np.allclose(out_got, out_ref), "pipeline mismatch"
        print(f"[stap] {n_cubes} cubes in {wall:.3f}s "
              f"({n_cubes / wall:.1f} cubes/s)")
        stats = rt.stats()
        print(f"[stap] runtime stats: {stats}")

        # fault-tolerance drill: evict a finished result and recover it
        ref = rt.submit(lambda a: a.sum(), out_got)
        rt.get(ref)            # ensure it completed
        rt.store.evict(ref)    # simulate node loss
        val = rt.get(ref)      # lineage replay
        print(f"[stap] lineage recovery OK (checksum {abs(val):.3e}); "
              f"replays={rt.lineage.replays}")
    finally:
        ctrl.stop()
        rt.shutdown()
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cube chunks compute (default: the card)")
    main(ap.parse_args().device)
