"""Checkpointing with async save and restore onto a device: the
reference's ``repro/checkpoint/ckpt.py`` on torch tensors, in its
layout.

Layout:  <dir>/step_<N>/
           manifest.json     — leaves (file, shape, dtype), step, extra
           <leaf_key>.npy    — one file per pytree leaf

Leaf keys are the reference's for the same tree (dict keys, NamedTuple
field names and list indices joined by "/", dict keys in sorted order:
``train/tree.py``). bfloat16 leaves are stored as their uint16 bits with
"bfloat16" named in the manifest, as the reference stores them; the
card has no ``ml_dtypes``, so they are viewed back through torch, not
numpy.

  * atomic publish: data written to step_<N>.tmp, renamed on
    completion — a crash mid-save never corrupts the latest checkpoint;
  * async save: the caller's thread copies every leaf to the host, a
    background thread writes them, and the train loop runs on;
  * restore onto a device: :func:`restore` puts each leaf on the device
    of the matching leaf of ``like_tree`` (or on ``device``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, unflatten

# dtypes numpy stores as they are; bfloat16 goes as its bits
_NUMPY = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.int64: "int64",
          torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool",
          torch.complex64: "complex64", torch.complex128: "complex128"}
_TORCH = {name: dt for dt, name in _NUMPY.items()}
_TORCH["bfloat16"] = torch.bfloat16


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in leaves_with_paths(tree)]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` as numpy, its logical dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NUMPY[t.dtype]
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None
         ) -> str:
    """Synchronous save with atomic publish."""
    return _write(ckpt_dir, step, [(key, _host(leaf)) for key, leaf
                                   in _flatten_with_paths(tree)], extra)


def _write(ckpt_dir: str, step: int, items, extra: Optional[Dict]) -> str:
    """Write [(key, (host array, logical dtype))] as step ``step``."""
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, (arr, logical_dtype) in items:
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": logical_dtype,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot on the caller thread, write on a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        self.wait()  # one in flight at a time
        snapshot = [(key, _host(leaf))
                    for key, leaf in _flatten_with_paths(tree)]

        def work():
            self.last_path = _write(self.ckpt_dir, step, snapshot, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(available_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)


def available_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree,
            device=None) -> Tuple[Any, Dict]:
    """Restore into fresh tensors shaped as ``like_tree``, each in the
    dtype of its leaf there and on its device (or on ``device``)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for key, like in _flatten_with_paths(like_tree):
        info = manifest["leaves"][key]
        arr = np.load(os.path.join(path, info["file"]))
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want = like.dtype if isinstance(like, torch.Tensor) \
            else _TORCH[info["dtype"]]
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(t.to(device=dev, dtype=want, copy=True))
    return unflatten(like_tree, iter(out)), manifest["extra"]
