"""Inputs drawn from the seed: training batches and served requests.

One generator reads every traffic file's parameters. Served requests
come in blocks of ``block`` whose (prompt, answer) lengths are the same
in every block and for every seed: the prompt lengths are the block's
quantiles of ``prompt_dist`` over ``prompt_tokens``, each paired with a
fixed answer-length quantile (``answer_dist`` over ``answer_tokens``);
the seed draws only each block's order and the token ids (uniform over
the vocabulary). So every seed offers the same work in another order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .weights import derive

#: a step that pairs the i-th prompt quantile of a block with answer
#: quantile (i * PAIRING) % block (odd: a permutation of a block of 2^k)
PAIRING = 13


def quantiles(dist: str, lo: int, hi: int, n: int) -> List[int]:
    """``n`` lengths at the midpoints of ``n`` equal shares of ``dist``
    ("log_uniform" or "uniform") over [lo, hi]."""
    qs = [(i + 0.5) / n for i in range(n)]
    if dist == "log_uniform":
        a, b = math.log(lo), math.log(hi)
        return [int(round(math.exp(a + q * (b - a)))) for q in qs]
    if dist == "uniform":
        return [int(round(lo + q * (hi - lo))) for q in qs]
    raise ValueError(f"unknown length distribution {dist!r}")


def block_sizes(t: Dict) -> List[Tuple[int, int]]:
    """The (prompt, answer) lengths of one block, in quantile order."""
    n = t["block"]
    prompts = quantiles(t["prompt_dist"], *t["prompt_tokens"], n)
    answers = quantiles(t["answer_dist"], *t["answer_tokens"], n)
    return [(prompts[i], answers[(i * PAIRING) % n]) for i in range(n)]


class Requests:
    """The served requests of a seed, by index: ``sizes(i)`` and
    ``prompt(i)`` (int32 token ids)."""

    def __init__(self, t: Dict, seed: int, vocab: int):
        self.t, self.vocab = t, vocab
        self.block = block_sizes(t)
        self._order = np.random.default_rng(derive(seed, "order"))
        self._tokens = derive(seed, "tokens")
        self._perm: List[np.ndarray] = []

    def sizes(self, i: int) -> Tuple[int, int]:
        b, j = divmod(i, len(self.block))
        while len(self._perm) <= b:
            self._perm.append(self._order.permutation(len(self.block)))
        return self.block[int(self._perm[b][j])]

    def prompt(self, i: int) -> np.ndarray:
        n, _ = self.sizes(i)
        rng = np.random.default_rng([self._tokens, i])
        return rng.integers(0, self.vocab, n, dtype=np.int32)


class Batches:
    """Training batches of a seed, drawn in turn on the device: (batch,
    seq_len + 1) token ids uniform over the vocabulary; each row's
    inputs are its first seq_len ids and its labels the next ones."""

    def __init__(self, t: Dict, seed: int, vocab: int, device, torch):
        self.torch, self.t, self.vocab = torch, t, vocab
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, "batches"))
        self.device = device

    def next(self) -> Dict:
        torch = self.torch
        ids = torch.randint(0, self.vocab,
                            (self.t["batch"], self.t["seq_len"] + 1),
                            generator=self.gen, device=self.device)
        return {"tokens": ids[:, :-1].to(torch.int32),
                "labels": ids[:, 1:].to(torch.int32)}
