"""Materialized compressed prefixes: projection, storage, per-slot seating
(``repro/serving/prefix_store.py``).

The compress → serve handoff in three steps:

1. :func:`materialize_prefix` pushes the compressor's per-layer output O^i
   through the frozen target's K/V projections (RoPE'd at positions
   0..m-1), giving each layer's compressed KV cache ``{"k", "v"}``.
2. :class:`PrefixStore` keeps one materialized prefix per ICL task (dense
   layout); :class:`PagedPrefixStore` writes it once into ref-counted
   blocks of the engine's KV pool (paged layout).
3. :func:`seat_prefix_row` copies a stored prefix into *one batch slot* of
   a dense engine cache (positions [0, m)), so different slots of one
   decode batch serve different tasks; :func:`write_prefix_to_cache` is
   the batch-wide variant.  A paged slot is seated by pointing its block
   table at the prefix's blocks (the engine's ``_seat_blocks``).

Caches are per-layer lists of ``{"k", "v"}`` tensors — (slots, max_len,
Hkv, hd) stripes or (num_blocks, block_size, Hkv, hd) pools — written in
place.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import project_kv
from repro_torch.models.transformer import Transformer
from repro_torch.serving.block_pool import BlockAllocator


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
    kept batch-free (a single task's per-layer cache rows).

    ``capacity`` (optional) bounds resident prefixes LRU-style: inserting
    past capacity evicts the least-recently-used entry.  Dense seating
    *copies* a prefix into the slot's cache stripe, so evicting a seated
    entry is safe and never raises."""

    def __init__(self, cfg: ModelConfig, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        self.cfg = cfg
        self.capacity = capacity
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self.stats = _new_store_stats()

    def put(self, name: str, materialized: list, batch_index: int = 0) -> str:
        row = take_prefix_row(materialized, batch_index)
        if name not in self._entries:
            while self.capacity is not None and \
                    len(self._entries) >= self.capacity:
                self.evict(next(iter(self._entries)))  # oldest first
        self._entries[name] = row
        self._entries.move_to_end(name)
        self.stats["puts"] += 1
        return name

    def lookup(self, name: str) -> bool:
        """Counted residency check — the serve-path ``hits``/``misses``."""
        hit = name in self._entries
        self.stats["hits" if hit else "misses"] += 1
        return hit

    def evict(self, name: str) -> None:
        self._check(name)
        del self._entries[name]
        self.stats["evictions"] += 1

    def get(self, name: str) -> list:
        self._check(name)
        self._entries.move_to_end(name)  # LRU recency
        return self._entries[name]

    def base_len(self, name: str) -> int:
        """Memory slots the prefix occupies at the cache front."""
        self._check(name)
        return _row_base_len(self._entries[name])

    def _check(self, name: str) -> None:
        if name not in self._entries:
            raise KeyError(f"unknown prefix {name!r}; registered: "
                           f"{sorted(self._entries) or '(none)'}")

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def names(self):
        return tuple(self._entries)


# ---------------------------------------------------------------------------
# Paged (block-resident) prefixes
# ---------------------------------------------------------------------------


def write_prefix_row_to_blocks(cache: list, row: list,
                               block_ids: List[int]) -> list:
    """Scatter a batch-free prefix row's K/V into pool blocks, in place.
    ``block_ids`` hold logical positions [0, m); every layer writes the
    *same* block ids into its own pool (one block table resolves every
    layer)."""
    device = cache[0]["k"].device
    ids = torch.as_tensor(block_ids, dtype=torch.int32, device=device)[None]
    zero = torch.zeros((1,), dtype=torch.int32, device=device)
    for c, p in zip(cache, row):
        for key in ("k", "v"):
            ops.paged_scatter(c[key], p[key][None], ids, zero)
    return cache


def copy_paged_block(cache: list, src: int, dst: int) -> list:
    """Copy one physical block across every layer's pools, in place — the
    copy-on-write when a slot must write into a shared partial block."""
    for c in cache:
        for key in ("k", "v"):
            c[key][dst] = c[key][src]
    return cache


class PrefixSeatedError(RuntimeError):
    """Refused to evict a prefix whose blocks are still seated in slots."""


class PagedPrefixStore:
    """Block-resident compressed prefixes with ref-counts and LRU eviction.

    ``put`` scatters a task's materialized KV into freshly allocated pool
    blocks *once*; the engine seats a task into a slot by pointing the
    slot's block table at those blocks (``blocks()`` +
    ``BlockAllocator.incref``), so N slots on one task share one physical
    copy.  The store holds one reference per resident prefix; a block's
    refcount therefore exceeds 1 exactly while some slot is seated on it.

    ``capacity`` bounds the number of resident prefixes LRU-style:
    inserting past capacity evicts the least-recently-used *unseated*
    entry; if there is none, :class:`PrefixSeatedError` is raised.
    Explicitly evicting a seated prefix always raises."""

    def __init__(self, cfg: ModelConfig, allocator: BlockAllocator,
                 capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        self.cfg = cfg
        self.alloc = allocator
        self.capacity = capacity
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self.stats = _new_store_stats()

    def lookup(self, name: str) -> bool:
        """Counted residency check (see :meth:`PrefixStore.lookup`)."""
        hit = name in self._entries
        self.stats["hits" if hit else "misses"] += 1
        return hit

    def put(self, name: str, materialized: list, cache: list,
            batch_index: int = 0) -> str:
        """Make ``materialized`` row ``batch_index`` block-resident in
        ``cache``'s pools under ``name``.  Re-putting an existing name
        replaces it, which requires the old entry to be unseated."""
        row = take_prefix_row(materialized, batch_index)
        if name in self._entries:
            self.evict(name)  # raises PrefixSeatedError while seated
        while self.capacity is not None and len(self._entries) >= self.capacity:
            self._evict_lru()
        base_len = _row_base_len(row)
        blocks = self.alloc.alloc(self.alloc.blocks_for(base_len))
        if blocks:
            write_prefix_row_to_blocks(cache, row, blocks)
        self._entries[name] = {"blocks": blocks, "base_len": base_len}
        self.stats["puts"] += 1
        return name

    def _evict_lru(self) -> None:
        for name, entry in self._entries.items():  # oldest first
            if not self._seated(entry):
                self.evict(name)
                return
        raise PrefixSeatedError(
            f"PrefixStore at capacity ({self.capacity}) and every resident "
            "prefix is seated in a slot — grow the capacity or finish "
            "requests")

    def _seated(self, entry) -> bool:
        return any(self.alloc.refcount(b) > 1 for b in entry["blocks"])

    def evict(self, name: str) -> None:
        """Release a prefix's blocks back to the pool.  Raises
        :class:`PrefixSeatedError` while any slot is still seated on it —
        freeing blocks under a live block table would let the allocator
        hand them to another slot mid-decode."""
        entry = self._get(name, touch=False)
        if self._seated(entry):
            raise PrefixSeatedError(
                f"prefix {name!r} is seated in at least one slot")
        for b in entry["blocks"]:
            self.alloc.decref(b)
        del self._entries[name]
        self.stats["evictions"] += 1

    # ---- lookups (refresh LRU recency) ----

    def blocks(self, name: str) -> List[int]:
        return list(self._get(name)["blocks"])

    def base_len(self, name: str) -> int:
        return self._get(name)["base_len"]

    def _get(self, name: str, touch: bool = True) -> dict:
        if name not in self._entries:
            raise KeyError(f"unknown prefix {name!r}; registered: "
                           f"{sorted(self._entries) or '(none)'}")
        if touch:
            self._entries.move_to_end(name)
        return self._entries[name]

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def names(self):
        return tuple(self._entries)


def _new_store_stats() -> Dict[str, int]:
    """Counters both stores expose: serve-path residency ``hits`` /
    ``misses`` (``lookup``), entries made resident (``puts``) and entries
    released (``evictions``: LRU, explicit and re-put alike)."""
    return {"hits": 0, "misses": 0, "puts": 0, "evictions": 0}


def _row_base_len(row: list) -> int:
    """Memory slots of a batch-free prefix row: the m dim of its K."""
    return int(row[0]["k"].shape[0]) if row else 0
