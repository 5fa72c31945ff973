"""Batched LM serving example on the port: continuous batching over a
reduced model with staggered request arrivals — single-process by
default, or with the state on a cluster worker with ``--cluster``.

The reference's ``examples/serve_lm.py`` with its imports taken from
``repro_torch`` and a ``--device`` option (the card by default;
``--device cpu`` serves on the CPU through the attention kernel's plain
version).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch_serve_lm.py --cluster [workers] \\
        [--device cpu]

The cluster path boots params + KV caches into a worker's object store
(``repro_torch.serve.remote_lm``), runs the same token-by-token decode
loop over a spawn-started fleet on ``--device``, and asserts that the
generated tokens equal the single-process ``ServeEngine``'s for the same
prompts.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import argparse  # noqa: E402


def main_local(device: str = "cuda") -> dict:
    from repro_torch.launch import serve as serve_mod

    stats = serve_mod.main(["--arch", "stablelm_3b", "--smoke",
                            "--requests", "8", "--slots", "3",
                            "--max-tokens", "10", "--device", device])
    assert stats["requests"] == 8
    return stats


def main_cluster(workers: int = 1, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distrib import ClusterRuntime
    from repro_torch.models import transformer as T
    from repro_torch.serve import ClusterLMEngine, Request, ServeEngine
    from repro_torch.serve.engine import serving_device

    serving_device(device)      # no card: raise here, naming --device cpu
    cfg = get_smoke_config("stablelm_3b")
    params, _ = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 12)))
               for _ in range(4)]

    ref_eng = ServeEngine(params, cfg, n_slots=2, max_seq=64, device=device)
    for i, p in enumerate(prompts):
        ref_eng.add_request(Request(f"req-{i}", p, max_tokens=8))
    ref = {r.request_id: list(r.generated)
           for r in ref_eng.run_until_done()}

    # a head that has used the card cannot fork: the engine needs spawn
    rt = ClusterRuntime(workers=workers, device=device, start_method="spawn")
    try:
        eng = ClusterLMEngine(rt, params, cfg, n_slots=2, max_seq=64,
                              trim_every=8)
        tickets = [eng.submit("tenant-a", p, max_tokens=8,
                              request_id=f"req-{i}")
                   for i, p in enumerate(prompts)]
        got = {t.request.request_id: t.wait(120.0) for t in tickets}
        assert got == ref, (got, ref)
        tel = eng.telemetry()
        print(f"[torch_serve_lm] cluster decode on {device} matches the "
              f"single-process engine on {len(prompts)} prompts "
              f"(ticks={tel['ticks']}, anchors={tel['anchors']}, "
              f"ttft_p50={tel['latency']['ttft_ms']['p50']:.1f}ms)")
        eng.close()
    finally:
        rt.shutdown()
    return tel


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cluster", nargs="?", type=int, const=1,
                    metavar="WORKERS",
                    help="serve from a fleet of WORKERS (default 1)")
    args = ap.parse_args()
    if args.cluster:
        main_cluster(args.cluster, args.device)
    else:
        main_local(args.device)
