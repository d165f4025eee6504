"""Synthetic vocabulary and pretraining stream (the port's copy of
``repro/data/synthetic.py``).

Token layout: PAD, BOS, SEP, ARROW, then ``num_keys`` key tokens,
``num_labels`` label tokens and ``num_words`` word tokens.

:class:`PretrainStream` mixes two stream kinds, deterministic in (seed,
step) so that a restarted trainer resumes at the exact batch: markov
(order-1 Markov "text" over the word tokens, a fixed random transition
table per seed) and icl (many-shot episodes of a fresh key -> label
mapping rendered as ``[SEP key ARROW label]`` shots).  Batches come split
into (source, target) at a point drawn from ``split_choices``; numpy
arrays, the same as the reference's for the same seed and step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticVocab:
    num_keys: int = 64
    num_labels: int = 64
    num_words: int = 256

    PAD: int = 0
    BOS: int = 1
    SEP: int = 2
    ARROW: int = 3

    @property
    def key_base(self) -> int:
        return 4

    @property
    def label_base(self) -> int:
        return self.key_base + self.num_keys

    @property
    def word_base(self) -> int:
        return self.label_base + self.num_labels

    @property
    def size(self) -> int:
        return self.word_base + self.num_words

    def key(self, i) -> int:
        return self.key_base + i

    def label(self, i) -> int:
        return self.label_base + i

    def label_ids(self) -> np.ndarray:
        return np.arange(self.label_base, self.label_base + self.num_labels)


class PretrainStream:
    def __init__(self, vocab: SyntheticVocab, batch: int, seq_len: int,
                 split_choices: Tuple[int, ...], seed: int = 0,
                 icl_fraction: float = 0.7):
        assert all(s < seq_len for s in split_choices)
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.split_choices = split_choices
        self.seed = seed
        self.icl_fraction = icl_fraction
        base = np.random.default_rng(seed)
        # fixed markov transition table (sparse-ish: each word has 8 likely successors)
        W = vocab.num_words
        self._succ = base.integers(0, W, size=(W, 8))

    def _episode(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.vocab
        mapping = rng.integers(0, v.num_labels, size=v.num_keys)
        n_shots = length // 4
        keys = rng.integers(0, v.num_keys, size=n_shots)
        toks = np.empty((n_shots, 4), np.int32)
        toks[:, 0] = v.SEP
        toks[:, 1] = v.key_base + keys
        toks[:, 2] = v.ARROW
        toks[:, 3] = v.label_base + mapping[keys]
        flat = toks.reshape(-1)
        out = np.full((length,), v.PAD, np.int32)
        out[: flat.size] = flat
        return out

    def _markov(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.vocab
        W = v.num_words
        out = np.empty((length,), np.int32)
        cur = int(rng.integers(0, W))
        for i in range(length):
            out[i] = v.word_base + cur
            if rng.random() < 0.1:
                cur = int(rng.integers(0, W))
            else:
                cur = int(self._succ[cur, int(rng.integers(0, 8))])
        return out

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a step (seekable restart)."""
        rng = np.random.default_rng((self.seed, step))
        split = int(rng.choice(self.split_choices))
        toks = np.empty((self.batch, self.seq_len), np.int32)
        for b in range(self.batch):
            if rng.random() < self.icl_fraction:
                toks[b] = self._episode(rng, self.seq_len)
            else:
                toks[b] = self._markov(rng, self.seq_len)
        source = toks[:, :split]
        target = toks[:, split:]
        mask = (target != self.vocab.PAD).astype(np.float32)
        return {"source": source, "target": target, "target_mask": mask,
                "split": split}
