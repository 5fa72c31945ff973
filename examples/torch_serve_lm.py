"""Batched LM serving example on the port: continuous batching over a
reduced model with staggered request arrivals, single-process.

The reference's ``examples/serve_lm.py::main_local`` with its imports
taken from ``repro_torch`` and a ``--device`` option (the card by
default; ``--device cpu`` serves through the attention kernel's plain
version). The reference's ``--cluster`` path (``ClusterLMEngine``) is
not ported yet.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
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


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main_local(ap.parse_args().device)
