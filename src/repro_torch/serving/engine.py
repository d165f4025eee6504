"""Lock-step dense serving engine over compressed prefixes
(``repro/serving/engine.py``, the offline compress → serve path).

The engine owns one dense KV cache of ``slots`` rows of ``max_len``
positions per layer.  A task's materialized prefix is registered once
(:meth:`add_prefix`) and copied into any slot (:meth:`seat_prefix`) at
positions [0, m); :meth:`seat_compressed` seats one batch of prefixes
engine-wide (row b in slot b).  :meth:`generate` then, for every slot in
order, prefills its prompt behind the slot's context (a static-offset
continuation: the prefix is attended as a fully visible block, the prompt
causally) and takes the greedy first token; after that, one batched
decode step per token runs every slot at its own length over the
``(slots,)`` length vector.  Token ids come to the host once per step.

Which context a slot serves follows the JAX engine's admission rule
(``engine.py`` ``serve``): a request naming a prefix is seated on it; a
request naming none gets the engine-wide context of :meth:`seat_compressed`
if there is one, else no context at all.  ``generate(prompts, max_new)``
names none, exactly like the JAX ``generate``; ``prefixes=`` names one
per slot, like requests with ``Request.prefix`` served in lock step.

The scheduler, mid-decode refill, the paged layout, the online compiler,
the prefix tiers, the fused step and the telemetry are later slices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.prefix_store import PrefixStore, seat_prefix_row


class ServingEngine:
    def __init__(self, cfg: ModelConfig, target: tfm.Transformer, *,
                 slots: int, max_len: int, device=None,
                 prefix_store: Optional[PrefixStore] = None):
        device = resolve_device(device)
        if target.device.type != device.type:
            raise ValueError(f"target lives on {target.device}, engine asked "
                             f"for {device}")
        self.device = target.device
        self.cfg = cfg
        self.target = target
        self.slots = slots
        self.max_len = max_len
        self.cache = tfm.init_cache(cfg, slots, max_len, dtype=target.dtype,
                                    device=self.device)
        self.store = prefix_store if prefix_store is not None \
            else PrefixStore(cfg)
        self.base = np.zeros((slots,), np.int64)  # per-slot seated memory
        self._seated: list = [None] * slots  # named prefix each slot holds

    # ------------------------------------------------------------------
    # Prefix seating
    # ------------------------------------------------------------------

    def add_prefix(self, name: str, materialized: list,
                   batch_index: int = 0) -> str:
        """Register row ``batch_index`` of a materialized prefix as task
        ``name``."""
        return self.store.put(name, materialized, batch_index)

    def seat_prefix(self, slot: int, name: str) -> None:
        """Install task ``name``'s compressed memory into one slot."""
        seat_prefix_row(self.cache, self.store.get(name), slot)
        self.base[slot] = self.store.base_len(name)
        self._seated[slot] = name

    _COMPAT = "__seated_"  # store names of the seat_compressed rows

    def seat_compressed(self, materialized: list) -> None:
        """Install a batch of compressed contexts engine-wide: row b of
        ``materialized`` seats slot b and is kept in the store, so a slot
        that a named prefix displaced gets it back."""
        for slot in range(self.slots):
            self.store.put(self._COMPAT + str(slot), materialized, slot)
            self.seat_prefix(slot, self._COMPAT + str(slot))
        self._seated = [None] * self.slots

    def _reset_slot(self, slot: int) -> None:
        """Prepare a slot for a prompt that names no prefix: restore the
        engine-wide context if a named prefix displaced it, else serve
        without context."""
        if self._seated[slot] is None:
            return  # the slot still holds the engine-wide context (or none)
        if self._COMPAT + str(slot) in self.store:
            self.seat_prefix(slot, self._COMPAT + str(slot))
        else:
            self.base[slot] = 0
        self._seated[slot] = None

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _prefill_slot(self, slot: int, tokens: np.ndarray,
                      persist: bool = True) -> torch.Tensor:
        """Prefill one slot's prompt behind its seated prefix; returns the
        last token's logits row.  ``persist=False`` works on a copy of the
        slot's cache row and leaves the engine cache untouched."""
        n = len(tokens)
        base = int(self.base[slot])
        if not 0 < n <= self.max_len - base:
            raise ValueError(f"prompt of {n} tokens does not fit behind "
                             f"{base} seated slots in max_len {self.max_len}")
        row = [{key: c[key][slot:slot + 1] for key in ("k", "v")}
               for c in self.cache]
        if not persist:
            row = [{key: x.clone() for key, x in c.items()} for c in row]
        toks = torch.as_tensor(np.asarray(tokens, np.int64)[None],
                               device=self.device)
        logits, _ = self.target(tokens=toks, cache=row, cache_index=base,
                                mask_offset=base)
        return logits[0, n - 1]

    @torch.no_grad()
    def _decode_greedy(self, pending: np.ndarray,
                       lengths: np.ndarray) -> list:
        """One batched decode step: slot ``b`` consumes ``pending[b]`` at
        cache position ``lengths[b]``; returns the greedy next ids."""
        toks = torch.as_tensor(pending.astype(np.int64)[:, None],
                               device=self.device)
        lens = torch.as_tensor(lengths.astype(np.int32), device=self.device)
        logits, _ = self.target(tokens=toks, cache=self.cache,
                                cache_index=lens, decode=True)
        return logits[:, -1].argmax(dim=-1).tolist()  # the one sync per step

    # ------------------------------------------------------------------
    # Lock-step batch generation, label scoring
    # ------------------------------------------------------------------

    def generate(self, prompts, max_new: int,
                 prefixes: Optional[list] = None) -> np.ndarray:
        """Greedy batch generation over the slot pool.  ``prompts`` is a
        (slots, S) array or a list of ragged 1-D token arrays, one per
        slot.  ``prefixes`` (optional) names each slot's stored prefix
        (``None`` entries name none); see the module docstring for the
        context of a slot that names none.  Returns (slots, max_new)
        int32."""
        rows = [np.asarray(p, np.int32) for p in prompts]
        if len(rows) != self.slots:
            raise ValueError(f"{len(rows)} prompts for {self.slots} slots")
        if prefixes is None:
            prefixes = [None] * self.slots
        if len(prefixes) != self.slots:
            raise ValueError(f"{len(prefixes)} prefixes for {self.slots} slots")
        if max_new == 0:
            return np.zeros((self.slots, 0), np.int32)
        for slot, name in enumerate(prefixes):
            if name is None:
                self._reset_slot(slot)
            elif self._seated[slot] != name:
                self.seat_prefix(slot, name)
        out = [[] for _ in rows]
        pending = np.zeros((self.slots,), np.int64)
        lengths = self.base.copy()
        for slot, toks in enumerate(rows):
            row_logits = self._prefill_slot(slot, toks)
            lengths[slot] = self.base[slot] + len(toks)
            pending[slot] = row_logits.argmax().tolist()
            out[slot].append(int(pending[slot]))
        for _ in range(max_new - 1):
            ids = self._decode_greedy(pending, lengths)
            lengths += 1  # the step consumed every slot's pending token
            pending[:] = ids
            for slot, tok in enumerate(ids):
                out[slot].append(tok)
        return np.asarray(out, np.int32)

    def score_labels(self, context: np.ndarray, query: np.ndarray,
                     label_ids: np.ndarray) -> int:
        """Constrained classification: argmax over label token ids for the
        next token after [slot 0's context; context; query].  Leaves the
        engine cache untouched."""
        toks = np.concatenate([context, query]).astype(np.int32)
        row = self._prefill_slot(0, toks, persist=False)
        scores = row.float().cpu().numpy()
        return int(label_ids[np.argmax(scores[label_ids])])
