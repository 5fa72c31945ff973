"""Space-Time Adaptive Processing on the PyTorch/CUDA port — the paper's
flagship workload (§5.3) carried through ``repro_torch``:

  sequential Python  →  repro_torch optimize()  →  pfor over range gates
                     →  repro_torch ClusterRuntime: chunks on worker
                        processes, each running the gate loop's torch
                        twin on its device, batched over the chunk's
                        gates with torch.func.vmap.

The kernel, its data and its sequential check are those of
``examples/stap.py`` (the reference package's flagship), copied here so
this example loads nothing of JAX or of the reference package. Per range
gate: the sample covariance of K training snapshots (``R = TᵀT / K``),
the MVDR weights by a fixed-iteration Richardson solve with diagonal
loading, and the beamformed output ``y[g] = wᵀ x[g]``.

By default the fleet runs on the card (``ClusterRuntime(device="cuda")``):
every worker runs the torch twin on the GPU. ``--cpu`` runs a CPU fleet
whose last worker poses as a GPU (it runs the torch twin on the CPU, the
others the numpy body), for a host without a card. Either way the result
must match the sequential numpy kernel within atol 1e-8, the torch twin
must have run, and a worker killed mid-run must be replaced without
changing the answer.

    PYTHONPATH=src python examples/torch_stap.py [workers] [--cpu]
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.compiler import optimize  # noqa: E402
from repro_torch.distrib import ClusterRuntime  # noqa: E402

# Scaled-down problem (the paper's full size is 24 GB/cube), as in
# examples/stap.py
GATES = 96
K_TRAIN = 64         # training snapshots per gate
DOF = 64             # adaptive degrees of freedom (channels × taps)
ITERS = 800          # Richardson steps (fixed count keeps it affine)
ALPHA = 0.15         # Richardson step size (< 2/λmax after loading)
LOADING = 2.0        # diagonal loading δ


def stap_adaptive(snap: "ndarray[f64,2]", train: "ndarray[f64,3]",
                  steer: "ndarray[f64,1]", outY: "ndarray[f64,1]",
                  numGates: int, K: int, dof: int, iters: int,
                  alpha: float, loading: float):
    """The kernel handed to ``optimize()`` — sequential NumPy as a user
    would write it; the gate loop is discovered as pfor."""
    for g in range(0, numGates):
        R = np.dot(train[g, 0:K, 0:dof].T, train[g, 0:K, 0:dof])
        for i in range(0, dof):
            for j in range(0, dof):
                R[i, j] = R[i, j] / K
        w = alpha * steer[0:dof]
        for it in range(0, iters):
            r = steer[0:dof] - np.dot(R[0:dof, 0:dof], w[0:dof]) \
                - loading * w[0:dof]
            w = w + alpha * r[0:dof]
        outY[g] = np.dot(w[0:dof], snap[g, 0:dof])


def stap_seq(snap, train, steer, outY, numGates, K, dof, iters,
             alpha, loading):
    """Plain-NumPy sequential reference (same math, library idiom)."""
    for g in range(numGates):
        T = train[g]
        R = T.T @ T / K
        w = alpha * steer.copy()
        for _ in range(iters):
            w = w + alpha * (steer - R @ w - loading * w)
        outY[g] = w @ snap[g]


def make_stap_data(gates: int = GATES, k: int = K_TRAIN, dof: int = DOF,
                   seed: int = 7):
    rng = np.random.default_rng(seed)
    train = rng.normal(size=(gates, k, dof))
    snap = rng.normal(size=(gates, dof))
    steer = rng.normal(size=dof)
    out = np.zeros(gates)
    return snap, train, steer, out


def main(workers: int = 2, cpu: bool = False) -> None:
    snap, train, steer, out = make_stap_data()
    args = (GATES, K_TRAIN, DOF, ITERS, ALPHA, LOADING)

    out_ref = out.copy()
    t0 = time.perf_counter()
    stap_seq(snap, train, steer, out_ref, *args)
    t_seq = time.perf_counter() - t0
    print(f"[torch_stap] sequential reference: {t_seq:.3f}s "
          f"({GATES / t_seq:.1f} gates/s)")

    if cpu and workers < 2:
        sys.exit("--cpu needs >= 2 workers (CPU workers + one GPU poser)")
    rt = (ClusterRuntime(workers=workers, device="cpu",
                         sim_gpu_workers=(workers - 1,))
          if cpu else ClusterRuntime(workers=workers, device="cuda"))
    try:
        profs = [(p.wid, p.gflops, f"gpu:{p.gpu_kind}@{p.gpu_gflops}"
                  if p.has_gpu else "cpu") for p in rt.profiles()]
        print(f"[torch_stap] fleet on {rt.device!r} (wid, GFLOP/s, dev): "
              f"{profs}")
        ck = optimize(runtime=rt, workers=workers)(stap_adaptive)
        ck.pfor_config.distribute_threshold = 0  # force the cluster tier
        print("[torch_stap] generated distributed code:")
        print(ck.source("np"))

        out_got = out.copy()
        ck.call_variant("np", snap, train, steer, out_got, *args)  # warm
        out_got = out.copy()
        t0 = time.perf_counter()
        ck.call_variant("np", snap, train, steer, out_got, *args)
        t_dist = time.perf_counter() - t0
        err = np.abs(out_got - out_ref).max()
        assert err < 1e-8, f"cluster STAP mismatch: {err:.2e}"
        print(f"[torch_stap] cluster ({workers} worker processes): "
              f"{t_dist:.3f}s ({GATES / t_dist:.1f} gates/s, "
              f"{t_seq / t_dist:.2f}x vs sequential), max|err| {err:.1e}")

        # fault-tolerance drill: kill a worker process mid-run; its
        # replacement binds the same device and runs torch twins again
        killer = threading.Timer(0.05, rt.kill_worker)
        out_ft = out.copy()
        killer.start()
        ck.call_variant("np", snap, train, steer, out_ft, *args)
        killer.cancel()
        err = np.abs(out_ft - out_ref).max()
        assert err < 1e-8, f"post-kill STAP mismatch: {err:.2e}"
        st = rt.stats()
        print(f"[torch_stap] worker-kill drill OK (max|err| {err:.1e}); "
              f"deaths={st['worker_deaths']} resubmits={st['resubmits']} "
              f"replays={st['lineage_replays']}")
        ran = st["chunks_executed"]
        print(f"[torch_stap] chunks executed {ran} (by worker "
              f"{st['chunks_executed_by_worker']}); torch_chunks "
              f"{st['torch_chunks']}, batch hits/builds/fallbacks "
              f"{st['batch_hits']}/{st['batch_builds']}/"
              f"{st['batch_fallbacks']}; shipped {st['bytes_shipped']}B")
        assert ran.get("torch", 0) > 0, "no chunk ran the torch twin"
        if not cpu:
            assert set(ran) == {"torch"}, f"a chunk left the card: {ran}"
    finally:
        rt.shutdown()


if __name__ == "__main__":
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(pos[0]) if pos else 2, cpu="--cpu" in sys.argv)
