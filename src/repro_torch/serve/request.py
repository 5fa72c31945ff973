"""The serving request record, shared by the single-process
:class:`repro_torch.serve.engine.ServeEngine` and the cluster engines.

Lives in its own jax-free module so the cluster serving plane (and
worker processes resolving shipped functions) can import it without
paying for the models that ``engine.py`` imports.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = ["Request"]


@dataclass
class Request:
    request_id: str
    prompt: np.ndarray                  # (S,) int32
    max_tokens: int = 16
    eos_id: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    submitted_s: float = field(default_factory=time.perf_counter)
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
