"""Materialized compressed prefixes: projection, storage, per-slot seating
(``repro/serving/prefix_store.py``).

The compress → serve handoff in three steps:

1. :func:`materialize_prefix` pushes the compressor's per-layer output O^i
   through the frozen target's projections (positions 0..m-1), giving
   each layer's compressed cache: ``{"k", "v"}`` for an attention layer,
   the latents ``{"ckv", "kr"}`` for an MLA layer; a Mamba2 layer's
   handed-off state ``{"ssm"}`` passes through.
2. :class:`PrefixStore` keeps one materialized prefix per ICL task (dense
   layout); :class:`PagedPrefixStore` writes its pooled leaves (``k``,
   ``v``, ``ckv``, ``kr``) once into ref-counted blocks of the engine's
   pools and keeps the per-slot rest (the ``ssm`` state) beside them
   (paged layout).  Both bound their entries LRU-style (``capacity``),
   skip the names in ``pinned`` when they evict for room, and hand an
   evicted entry to ``demote_hook`` first (the tiered store,
   ``serving/tiers.py``, demotes it to host).
3. :func:`seat_prefix_row` copies a stored prefix into *one batch slot* of
   a dense engine cache (positions [0, m); the state replaces the slot's
   SSM state), so different slots of one decode batch serve different
   tasks; :func:`write_prefix_to_cache` is the batch-wide variant.  A
   paged slot is seated by pointing its block table at the prefix's
   blocks (the engine's ``_seat_blocks``) and seating the state row.

Caches are per-layer lists of dicts written in place: ``{"k", "v"}``
(slots, max_len, Hkv, hd) stripes or (num_blocks, block_size, Hkv, hd)
pools for attention, ``{"ckv", "kr"}`` stripes or pools for MLA, and
per-slot ``{"conv", "ssm"}`` state for Mamba2 and per-slot cross entries
``{"ck", "cv"}`` for an enc-dec decoder block on both layouts (a prefix
holds none; nothing here clears or fills them, as in the JAX package).
:func:`clear_slot_state` zeroes one slot's recurrent state before a
refill.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import prefix_positions, project_kv
from repro_torch.models.mla import latent
from repro_torch.models.transformer import Transformer
from repro_torch.serving.block_pool import BlockAllocator

#: The leaves that live at cache positions (pooled in the paged layout).
KV_KEYS = ("k", "v", "ckv", "kr")


@torch.no_grad()
def materialize_prefix(target: Transformer, cfg: ModelConfig, prefix: list) -> list:
    """Turn per-layer ``{"h": O^i}`` entries into compressed caches:
    attention -> ``{"k", "v"}``, MLA -> ``{"ckv", "kr"}``; an entry
    without ``"h"`` (a Mamba2 layer's ``{"ssm"}``) passes through."""
    out = []
    for block, desc, entry in zip(target.layers, cfg.layout.descriptors(),
                                  prefix):
        if "h" not in entry:
            out.append(entry)
            continue
        h = entry["h"]
        pos = prefix_positions(cfg, h.shape[0], h.shape[1], h.device)
        if desc.mixer == "mla":
            ckv, kr = latent(block.attn, cfg, h, pos)
            out.append({"ckv": ckv, "kr": kr})
        else:
            k, v = project_kv(block.attn, cfg, h, pos)
            out.append({"k": k, "v": v})
    return out


def write_prefix_to_cache(cfg: ModelConfig, cache: list, prefix: list) -> list:
    """Seat compressed memory at cache positions [0, m), batch-wide (row b
    of the materialized prefix lands in slot b); a handed-off state
    replaces the slots' SSM state.  In place."""
    for c, p in zip(cache, prefix):
        for key in KV_KEYS:
            if key in p:
                m = p[key].shape[1]
                c[key][:, :m] = p[key].to(c[key].dtype)
        if "ssm" in p:
            c["ssm"].copy_(p["ssm"].to(c["ssm"].dtype))
    return cache


def seat_prefix_row(cache: list, row: list, slot: int) -> list:
    """Install one task's batch-free prefix row into batch slot ``slot``:
    position leaves land at positions [0, m) of that slot, a state
    replaces the slot's SSM state.  In place."""
    for c, p in zip(cache, row):
        for key in KV_KEYS:
            if key in p:
                m = p[key].shape[0]
                c[key][slot, :m] = p[key].to(c[key].dtype)
        if "ssm" in p:
            c["ssm"][slot] = p["ssm"].to(c["ssm"].dtype)
    return cache


def clear_slot_state(cache: list, slot: int) -> list:
    """Zero one slot's recurrent state (Mamba2 conv window and SSM state)
    ahead of a refill, in place.  K/V needs no clearing: positions past a
    slot's length are masked.  A prefill continues from the cached state,
    so a refilled slot must not inherit its previous occupant's."""
    for c in cache:
        for key in ("conv", "ssm"):
            if key in c:
                c[key][slot].zero_()
    return cache


def take_prefix_row(materialized: list, batch_index: int = 0) -> list:
    """One batch row of a :func:`materialize_prefix` output, batch-free."""
    return [{key: x[batch_index] for key, x in entry.items()}
            for entry in materialized]


class PrefixStore:
    """In-memory store of materialized compressed prefixes, one per task,
    kept batch-free (a single task's per-layer cache rows).

    ``capacity`` (optional) bounds resident prefixes LRU-style: inserting
    past capacity evicts the least-recently-used entry not in
    :attr:`pinned` (:class:`PrefixSeatedError` when every entry is
    pinned).  Dense seating *copies* a prefix into the slot's cache
    stripe, so evicting a seated entry is safe.  ``demote_hook(name,
    row)`` runs just before an evicted entry is dropped."""

    def __init__(self, cfg: ModelConfig, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        self.cfg = cfg
        self.capacity = capacity
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self.stats = _new_store_stats()
        self.pinned: set = set()  # names the LRU must skip (engine-kept)
        self.demote_hook = None   # called (name, row) before an evict drops

    def put(self, name: str, materialized: list, batch_index: int = 0) -> str:
        return self.put_row(name, take_prefix_row(materialized, batch_index))

    def put_row(self, name: str, row: list) -> str:
        """Make an already batch-free per-layer row resident (the tiers'
        promotion lands here)."""
        if name not in self._entries:
            while self.capacity is not None and \
                    len(self._entries) >= self.capacity:
                self._evict_lru()
        self._entries[name] = row
        self._entries.move_to_end(name)
        self.stats["puts"] += 1
        return name

    def _evict_lru(self) -> None:
        for name in self._entries:  # oldest first
            if name not in self.pinned:
                self.evict(name)
                return
        raise PrefixSeatedError(
            f"PrefixStore at capacity ({self.capacity}) and every resident "
            "prefix is pinned by a queued or waiting request — grow the "
            "capacity or finish requests")

    def lookup(self, name: str) -> bool:
        """Counted residency check — the serve-path ``hits``/``misses``."""
        hit = name in self._entries
        self.stats["hits" if hit else "misses"] += 1
        return hit

    def evict(self, name: str, demote: bool = True) -> None:
        """``demote=False`` skips the hook (fresh content supersedes the
        old copy)."""
        self._check(name)
        if demote and self.demote_hook is not None:
            # a dense entry owns its tensors (seating copies them), so no
            # slot can be reading it: the seated guard is the paged store's
            # reprolint: ignore[demote-guard] -- dense K/V is owned, not pooled
            self.demote_hook(name, self._entries[name])
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
    """Scatter a batch-free prefix row's pooled leaves (K/V, MLA latents)
    into pool blocks, in place.  ``block_ids`` hold logical positions
    [0, m); every layer writes the *same* block ids into its own pools
    (one block table resolves every layer).  A state leaf is left for
    per-slot seating (:func:`seat_prefix_row`)."""
    ids = zero = None
    for c, p in zip(cache, row):
        keys = [key for key in KV_KEYS if key in p]
        if not keys:
            continue
        if ids is None:
            device = c[keys[0]].device
            ids = torch.as_tensor(block_ids, dtype=torch.int32,
                                  device=device)[None]
            zero = torch.zeros((1,), dtype=torch.int32, device=device)
        ops.paged_scatter([c[key] for key in keys],
                          [p[key][None] for key in keys], ids, zero)
    return cache


def copy_paged_block(cache: list, src: int, dst: int) -> list:
    """Copy one physical block across every layer's pools, in place — the
    copy-on-write when a slot must write into a shared partial block."""
    for c in cache:
        for key in KV_KEYS:
            if key in c:
                c[key][dst] = c[key][src]
    return cache


def strip_kv_leaves(row: list) -> Optional[list]:
    """A prefix row without its pooled leaves: the per-slot state left to
    seat (a Mamba2 layer's ``ssm``), or None when nothing remains."""
    stripped = [{k: v for k, v in e.items() if k not in KV_KEYS}
                for e in row]
    return stripped if any(stripped) else None


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
    inserting past capacity evicts the least-recently-used entry that is
    neither seated nor in :attr:`pinned`; if there is none,
    :class:`PrefixSeatedError` is raised.  Explicitly evicting a seated
    prefix always raises.  ``demote_hook(name, entry)`` runs after that
    guard and before the blocks are released, so the pool still holds the
    prefix's K/V while the hook reads it."""

    def __init__(self, cfg: ModelConfig, allocator: BlockAllocator,
                 capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        self.cfg = cfg
        self.alloc = allocator
        self.capacity = capacity
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self.stats = _new_store_stats()
        # the engine keeps this at the prefixes of queued and parked
        # requests while it installs one: they must survive the LRU
        self.pinned: set = set()
        self.demote_hook = None

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
        return self.put_row(name, take_prefix_row(materialized, batch_index),
                            cache)

    def put_row(self, name: str, row: list, cache: list) -> str:
        """:meth:`put` for an already batch-free row (the tiers'
        promotion path)."""
        if name in self._entries:
            # replace: raises PrefixSeatedError while seated; the old copy
            # is superseded, not demoted
            self.evict(name, demote=False)
        while self.capacity is not None and len(self._entries) >= self.capacity:
            self._evict_lru()
        base_len = _row_base_len(row)
        blocks = self.alloc.alloc(self.alloc.blocks_for(base_len))
        if blocks:
            write_prefix_row_to_blocks(cache, row, blocks)
        self._entries[name] = {"blocks": blocks, "base_len": base_len,
                               "state": strip_kv_leaves(row)}
        self.stats["puts"] += 1
        return name

    def _evict_lru(self) -> None:
        for name, entry in self._entries.items():  # oldest first
            if name not in self.pinned and not self._seated(entry):
                self.evict(name)
                return
        raise PrefixSeatedError(
            f"PrefixStore at capacity ({self.capacity}) and every resident "
            "prefix is seated in a slot or pinned by a waiting request — "
            "grow the pool or finish requests")

    def _seated(self, entry) -> bool:
        return any(self.alloc.refcount(b) > 1 for b in entry["blocks"])

    def evict(self, name: str, demote: bool = True) -> None:
        """Release a prefix's blocks back to the pool.  Raises
        :class:`PrefixSeatedError` while any slot is still seated on it —
        freeing blocks under a live block table would let the allocator
        hand them to another slot mid-decode.  ``demote=False`` skips the
        hook."""
        entry = self._get(name, touch=False)
        if self._seated(entry):
            raise PrefixSeatedError(
                f"prefix {name!r} is seated in at least one slot")
        if demote and self.demote_hook is not None:
            self.demote_hook(name, entry)
        for b in entry["blocks"]:
            self.alloc.decref(b)
        del self._entries[name]
        self.stats["evictions"] += 1

    # ---- lookups (refresh LRU recency) ----

    def blocks(self, name: str) -> List[int]:
        return list(self._get(name)["blocks"])

    def base_len(self, name: str) -> int:
        return self._get(name)["base_len"]

    def state_row(self, name: str) -> Optional[list]:
        """The per-slot leaves to seat beside the blocks (None: none)."""
        return self._get(name)["state"]

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
    """Memory slots of a batch-free prefix row: the m dim of its first
    position leaf (0 for a row of states alone)."""
    for e in row:
        for key in KV_KEYS:
            if key in e:
                return int(e[key].shape[0])
    return 0
