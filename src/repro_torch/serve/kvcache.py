"""Serving KV-cache management: fixed-slot batched cache with per-slot
occupancy — the static-shape (XLA-friendly) sibling of paged attention.

The engine keeps a cache of shape (slots, …, max_seq, …) per layer; a slot
map tracks which request occupies which slot and its current length.
Freeing is O(1) (occupancy bit), insertion finds the first free slot —
continuous batching without dynamic shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class SlotMap:
    n_slots: int
    occupied: np.ndarray = None          # bool (slots,)
    lengths: np.ndarray = None           # int32 (slots,)
    request_ids: List[Optional[str]] = None

    def __post_init__(self):
        self.occupied = np.zeros(self.n_slots, bool)
        self.lengths = np.zeros(self.n_slots, np.int32)
        self.request_ids = [None] * self.n_slots

    def allocate(self, request_id: str, length: int = 0) -> Optional[int]:
        free = np.flatnonzero(~self.occupied)
        if free.size == 0:
            return None
        slot = int(free[0])
        self.occupied[slot] = True
        self.lengths[slot] = length
        self.request_ids[slot] = request_id
        return slot

    def free(self, slot: int) -> None:
        self.occupied[slot] = False
        self.lengths[slot] = 0
        self.request_ids[slot] = None

    def advance(self, slot: int, by: int = 1) -> None:
        self.lengths[slot] += by

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self.occupied)

    def utilization(self) -> float:
        return float(self.occupied.mean())
