"""Synthetic data: deterministic corpora with learnable structure (a copy
of ``repro.data.pipeline``, numpy only).  The serving launcher draws its
prompts here, the training launcher its batches (``batches``: tokens,
next-token labels and a float mask, the same draws as the JAX package's).

Corpora are generated from a seed, not downloaded:

  * ``markov`` — an order-2 Markov chain over the vocabulary with a skewed
    transition table.  Gives early exits a confidence gradient: frequent
    bigrams become predictable at shallow layers first (mirrors the paper's
    Table 1 phenomenon).  The dense table has one row and one column a
    state; past ``MAX_STATES`` ids (it would take V*V*8 bytes: 550 GB at
    gemma3's 262144) the chain runs over ``MAX_STATES`` states, token ids
    ``stride`` apart.  The table is built at the first markov draw (it
    has a generator of its own, so every draw is the same as if it were
    built up front): a ``copy`` corpus never pays for it.
  * ``copy``   — induction-style [BOS a1..ak SEP a1..ak] sequences; the copy
    tail is predictable with near-1.0 confidence once learned.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

MAX_STATES = 32768          # a dense table of 8 GiB (float64)


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
        self.states = min(cfg.vocab_size, MAX_STATES)
        # state s is token s * stride
        self.stride = cfg.vocab_size // self.states
        self._table: Optional[np.ndarray] = None

    @property
    def table(self) -> np.ndarray:
        """The (states, states) transition table, built on first use."""
        if self._table is None:
            v = self.states
            r = np.random.default_rng(self.cfg.seed + 1)
            # skewed order-1 table with strong modes (rows sum to 1)
            logits = r.gumbel(size=(v, v)) * 2.0
            top = r.integers(0, v, size=v)
            # each token has a likely successor
            logits[np.arange(v), top] += 6.0
            table = np.exp(logits - logits.max(1, keepdims=True))
            table /= table.sum(1, keepdims=True)
            self._table = table
        return self._table

    def _markov_seq(self, n: int) -> np.ndarray:
        v = self.states
        seq = np.empty(n, np.int32)
        seq[0] = self.rng.integers(0, v)
        for i in range(1, n):
            seq[i] = self.rng.choice(v, p=self.table[seq[i - 1]])
        return seq * self.stride

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

    def batches(self, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` batches of ``batch_size`` sequences of ``seq_len``
        tokens: {"tokens", "labels" (the next tokens), "mask" (float32
        ones)}, int32 tokens as the JAX package's."""
        cfg = self.cfg
        for _ in range(steps):
            toks = np.stack([self.sample_tokens(cfg.seq_len + 1)
                             for _ in range(cfg.batch_size)])
            yield {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "mask": np.ones((cfg.batch_size, cfg.seq_len), np.float32),
            }
