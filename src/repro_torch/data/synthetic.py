"""Synthetic data: deterministic corpora with learnable structure (the
prompt half of ``repro.data.pipeline``, numpy only).  The serving launcher
draws its prompts here; training batches wait for the training port.

Corpora are generated from a seed, not downloaded:

  * ``markov`` — an order-2 Markov chain over the vocabulary with a skewed
    transition table.  Gives early exits a confidence gradient: frequent
    bigrams become predictable at shallow layers first (mirrors the paper's
    Table 1 phenomenon).
  * ``copy``   — induction-style [BOS a1..ak SEP a1..ak] sequences; the copy
    tail is predictable with near-1.0 confidence once learned.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    kind: str = "markov"       # "markov" | "copy" | "mixed"
    seed: int = 0


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        r = np.random.default_rng(cfg.seed + 1)
        # skewed order-1 table with strong modes (rows sum to 1)
        logits = r.gumbel(size=(v, v)) * 2.0
        top = r.integers(0, v, size=v)
        logits[np.arange(v), top] += 6.0      # each token has a likely successor
        self.table = np.exp(logits - logits.max(1, keepdims=True))
        self.table /= self.table.sum(1, keepdims=True)

    def _markov_seq(self, n: int) -> np.ndarray:
        v = self.cfg.vocab_size
        seq = np.empty(n, np.int32)
        seq[0] = self.rng.integers(0, v)
        for i in range(1, n):
            seq[i] = self.rng.choice(v, p=self.table[seq[i - 1]])
        return seq

    def _copy_seq(self, n: int) -> np.ndarray:
        v = self.cfg.vocab_size
        k = max(2, n // 2 - 1)
        head = self.rng.integers(2, v, size=k).astype(np.int32)
        sep = np.array([1], np.int32)
        seq = np.concatenate([head, sep, head])[:n]
        if len(seq) < n:
            seq = np.pad(seq, (0, n - len(seq)), constant_values=0)
        return seq

    def sample_tokens(self, n: int, kind: Optional[str] = None) -> np.ndarray:
        kind = kind or self.cfg.kind
        if kind == "mixed":
            kind = "copy" if self.rng.random() < 0.5 else "markov"
        return self._markov_seq(n) if kind == "markov" else self._copy_seq(n)
