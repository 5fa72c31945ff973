"""Data pipeline: deterministic synthetic token streams, host-sharded,
with background prefetch.

Every host materializes only its shard of the global batch (shape
(global_batch/dp_shards, seq)); the loader is seeded per (host, step) so
restarts resume deterministically from the checkpointed step — the data
side of checkpoint/restart fault tolerance.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 1234
    embeds_dim: int = 0       # >0 → produce 'embeds' instead of tokens
    src_len: int = 0          # >0 → enc-dec: produce 'src_embeds'
    d_model: int = 0


class SyntheticTokens:
    """Zipf-ish synthetic language with local structure (so losses move)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 31 + cfg.host_id)
        b, s = self.local_batch, cfg.seq_len
        # markov-ish: next token = prev + small step (mod vocab) — low
        # entropy (≤ ln 3) so smoke-training measurably learns it
        start = rng.integers(0, cfg.vocab, size=(b, 1))
        steps = rng.integers(1, 4, size=(b, s - 1))
        toks = np.concatenate([start, steps], axis=1).cumsum(axis=1) \
            % cfg.vocab
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        labels[:, -1] = -100 if False else 0  # last position: predict 0
        out: Dict[str, np.ndarray] = {"labels": labels}
        if cfg.embeds_dim > 0:
            emb = rng.normal(size=(b, s, cfg.embeds_dim)) * 0.02
            out["embeds"] = emb.astype(np.float32)
        else:
            out["tokens"] = tokens
        if cfg.src_len > 0:
            src = rng.normal(size=(b, cfg.src_len, cfg.d_model)) * 0.02
            out["src_embeds"] = src.astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-N pipeline ahead of the step)."""

    def __init__(self, source: SyntheticTokens, depth: int = 2,
                 start_step: int = 0):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            batch = self.source.batch_at(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self, timeout: float = 10.0) -> Dict[str, np.ndarray]:
        return self.q.get(timeout=timeout)

    def stop(self):
        self._stop.set()


def make_pipeline(cfg: DataConfig, start_step: int = 0,
                  prefetch: int = 2) -> Prefetcher:
    return Prefetcher(SyntheticTokens(cfg), depth=prefetch,
                      start_step=start_step)
