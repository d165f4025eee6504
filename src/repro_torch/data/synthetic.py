"""Synthetic vocabulary of the ICL tasks (the port's copy of
``repro/data/synthetic.py::SyntheticVocab``).

Token layout: PAD, BOS, SEP, ARROW, then ``num_keys`` key tokens,
``num_labels`` label tokens and ``num_words`` word tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

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
