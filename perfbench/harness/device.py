"""The device a run uses, as the result line names it."""

from __future__ import annotations

import subprocess
from typing import Dict


def describe(torch, device: str, count: int) -> Dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"not read ({err.__class__.__name__})"


def peak_bytes(torch, device: str) -> int:
    if device == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def synchronize(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def free(torch, device: str) -> None:
    import gc
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
