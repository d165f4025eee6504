"""Materialized compressed prefixes: projection, storage, per-slot seating
(``repro/serving/prefix_store.py``, dense layout).

The compress → serve handoff in three steps:

1. :func:`materialize_prefix` pushes the compressor's per-layer output O^i
   through the frozen target's K/V projections (RoPE'd at positions
   0..m-1), giving each layer's compressed KV cache ``{"k", "v"}``.
2. :class:`PrefixStore` keeps one materialized prefix per ICL task.
3. :func:`seat_prefix_row` copies a stored prefix into *one batch slot* of
   a live engine cache (positions [0, m)), so different slots of one decode
   batch serve different tasks; :func:`write_prefix_to_cache` is the
   batch-wide variant.

Caches are per-layer lists of ``{"k", "v"}`` tensors (slots, max_len, Hkv,
hd), written in place.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.attention import project_kv
from repro_torch.models.transformer import Transformer


@torch.no_grad()
def materialize_prefix(target: Transformer, cfg: ModelConfig, prefix: list) -> list:
    """Turn per-layer ``{"h": O^i}`` entries into ``{"k", "v"}`` caches."""
    out = []
    for block, entry in zip(target.layers, prefix):
        h = entry["h"]
        B, m = h.shape[0], h.shape[1]
        pos = torch.arange(m, dtype=torch.int32, device=h.device).expand(B, m)
        k, v = project_kv(block.attn, cfg, h, pos)
        out.append({"k": k, "v": v})
    return out


def write_prefix_to_cache(cfg: ModelConfig, cache: list, prefix: list) -> list:
    """Seat compressed memory at cache positions [0, m), batch-wide (row b
    of the materialized prefix lands in slot b).  In place."""
    for c, p in zip(cache, prefix):
        for key in ("k", "v"):
            m = p[key].shape[1]
            c[key][:, :m] = p[key].to(c[key].dtype)
    return cache


def seat_prefix_row(cache: list, row: list, slot: int) -> list:
    """Install one task's batch-free prefix row into batch slot ``slot``:
    KV lands at positions [0, m) of that slot.  In place."""
    for c, p in zip(cache, row):
        for key in ("k", "v"):
            m = p[key].shape[0]
            c[key][slot, :m] = p[key].to(c[key].dtype)
    return cache


def take_prefix_row(materialized: list, batch_index: int = 0) -> list:
    """One batch row of a :func:`materialize_prefix` output, batch-free."""
    return [{key: x[batch_index] for key, x in entry.items()}
            for entry in materialized]


class PrefixStore:
    """In-memory store of materialized compressed prefixes, one per task,
    kept batch-free (a single task's per-layer cache rows)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._base_len: Dict[str, int] = {}

    def put(self, name: str, materialized: list, batch_index: int = 0) -> str:
        row = take_prefix_row(materialized, batch_index)
        self._entries[name] = row
        self._base_len[name] = int(row[0]["k"].shape[0])
        return name

    def get(self, name: str) -> list:
        return self._entries[name]

    def base_len(self, name: str) -> int:
        return self._base_len[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries
