"""Continuous-batching serving engine over compressed caches
(``repro/serving/engine.py``, its classic decode step).

1. A task's materialized compressed prefix is registered once
   (:meth:`ServingEngine.add_prefix`).
2. :meth:`ServingEngine.serve` runs a fixed pool of batch slots.  Each
   :class:`~repro_torch.serving.scheduler.Request` names the task memory
   it wants; the engine seats that prefix into the request's slot,
   prefills the prompt *behind it* and decodes.  Slots are independent:

   * **ragged admission** — prompts of any length enter whichever slot is
     free; prefill is per slot, decode one batched step over the
     ``(slots,)`` length vector;
   * **per-slot masking** — every step attends to that slot's own
     ``base + tokens consumed`` positions only;
   * **per-slot stop** — a slot finishing (its stop token or its budget)
     frees at once and the scheduler refills it mid-decode;
   * **priority classes and preemption** — a queued request whose class
     outranks a running one that blocks it evicts the worst running slot;
     on re-admission the engine re-prefills ``prompt + emitted`` so the
     request resumes token-exact.  With ``priority_aging_s`` a queued
     request's class drops by one for each such interval it has waited
     (admission order only; preemption compares base classes).

Two KV layouts (``kv_layout=``):

* ``dense`` — per-slot ``(slots, max_len, …)`` stripes; seating copies the
  prefix into the slot's rows (prefix memory O(slots)).
* ``paged`` — one ``(num_blocks, block_size, …)`` pool per layer plus
  per-slot block tables; slots seated on one task share its ref-counted
  prefix blocks (prefix memory O(tasks)), with copy-on-write only for a
  partially filled tail block, private blocks freed on refill, and
  admission gated on free blocks net of every admitted request's
  reservation.

Prefill width.  The JAX engine pads a prompt of ``n`` tokens with token 0
to ``_bucket(n, cap)``, a power of two, except for a recurrent config (a
Mamba2 layer), whose state would advance over pad tokens: that one it
prefills exactly.  The port prefills the exact prompt for attention-only
configs too: causal masking keeps pad tokens out of every real row, so
the logits are the same.  A MoE layer derives its expert capacity from
all N tokens of the forward pass, pad tokens included, so there the width
changes which real tokens are dropped; for a config with a MoE layer and
no recurrent one the port prefills at the JAX width, padded with token 0,
and returns row ``n - 1``.  Reservations, allocations and the clock's
charges use the JAX width (:meth:`ServingEngine._width`) either way, so
the admission gate admits the same requests in the same order.

Recurrent state.  A Mamba2 layer keeps per-slot conv/ssm state on both
layouts, and a prefill continues from it.  A slot is *dirty* once a
prefill or a batched decode step (which advances every slot, idle ones
included) has run on it since it was seated; a request that names no
prefix zeroes a dirty slot's state first (``clear_slot_state``), a
request naming a prefix always re-seats it, and ``score_labels``
restores slot 0 before its one-shot prefill.  A preempted request
resumes in a cleared slot by re-prefilling prompt + emitted tokens.

The cache is updated in place: a ``persist=False`` prefill (label
scoring) writes only into blocks it allocates itself and returns them, so
no prefix or slot block changes.  The batched decode step runs every
slot, as the JAX classic step does: an idle slot consumes its last token
again at its last length and writes its K/V through its own stripe
(dense) or block table (paged: its own stale blocks, the unused tail of a
seated prefix's partial block, or the trash block 0).  Its hidden state
then picks experts as the JAX one does, which matters once idle and
active lanes compete for a MoE layer's capacity.

Online compilation (``compressor=``).  A request that carries
``raw_shots`` for a task no tier holds is parked (``waiting_on_prefix``)
while the :class:`~repro_torch.serving.compiler.PrefixCompiler` compresses
the shots: behind each decode step at most ``compile_token_budget``
source tokens, or, when nothing decodes, the head job to completion.  A
finished prefix is installed into the store (deferred while capacity is
held by seated or queued prefixes) and its requests wake in arrival
order.

Prefix tiers (``host_capacity=`` / ``disk_dir=``).  The store is fronted
by a :class:`~repro_torch.serving.tiers.TieredPrefixStore`: an evicted
prefix is demoted to pinned host memory and, past ``host_capacity``,
spilled to a disk shard; a request naming it parks while it is promoted
back, ``promote_layer_budget`` layers behind each decode step.  Promotion
is preferred to recompiling, also for a request that carries raw shots.

The clock is injected (``clock=``, wall time by default): a
:class:`~repro_torch.serving.clock.VirtualClock` makes every timing a
function of the work performed; compile tokens and promoted layers are
charged too.  The fused step (and its compile-chunk lane), speculative
decoding, telemetry, the watchdog, the budget autotuner and meshes are
later slices of the port.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.block_pool import (TRASH_BLOCK, BlockAllocator,
                                            OutOfBlocksError)
from repro_torch.serving.compiler import PrefixCompiler, pow2_bucket
from repro_torch.serving.prefix_store import (PagedPrefixStore,
                                              PrefixSeatedError, PrefixStore,
                                              clear_slot_state,
                                              copy_paged_block,
                                              seat_prefix_row,
                                              take_prefix_row,
                                              write_prefix_to_cache)
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.tiers import TieredPrefixStore


def _bucket(n: int, cap: int) -> int:
    """The JAX engine's prefill width for ``n`` tokens: the next power of
    two (min 8), clamped to the slot's remaining cache space."""
    return max(1, min(pow2_bucket(n, 8), cap))


class ServingEngine:
    _COMPAT = "__seated_"  # store names of the seat_compressed rows

    def __init__(self, cfg: ModelConfig, target: tfm.Transformer, *,
                 slots: int, max_len: int, device=None,
                 prefix_store: Optional[PrefixStore] = None,
                 kv_layout: str = "dense", block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 prefix_capacity: Optional[int] = None,
                 compressor=None,
                 compile_token_budget: Optional[int] = None,
                 host_capacity: Optional[int] = None,
                 disk_dir: Optional[str] = None,
                 promote_layer_budget: Optional[int] = None,
                 clock=None, priority_aging_s: Optional[float] = None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be dense or paged, got "
                             f"{kv_layout!r}")
        if compile_token_budget is not None and compile_token_budget < 1:
            raise ValueError("compile_token_budget must be >= 1 (or None)")
        if promote_layer_budget is not None and promote_layer_budget < 1:
            raise ValueError("promote_layer_budget must be >= 1 (or None)")
        device = resolve_device(device)
        if target.device.type != device.type:
            raise ValueError(f"target lives on {target.device}, engine asked "
                             f"for {device}")
        self.device = target.device
        # injected clock; charge()/advance_to() are duck-typed: absent on a
        # wall clock, charging is a no-op and waits become short sleeps
        self.clock = clock if clock is not None else time.perf_counter
        charge = getattr(self.clock, "charge", None)
        self._charge = charge if charge is not None else (lambda *_: None)
        self.priority_aging_s = priority_aging_s
        self.request_log: Dict[int, dict] = {}  # per-request timings
        self.trace: List[tuple] = []  # per-serve event log
        self.counters = {
            "decode_steps": 0, "prefills": 0, "tokens_generated": 0,
            "decode_steps_during_compile": 0, "compile_chunks_interleaved": 0,
            "decode_steps_during_promote": 0, "promote_steps_interleaved": 0,
            "decode_gap_max_s": 0.0, "decode_gap_sum_s": 0.0,
            "decode_gaps": 0, "decode_time_s": 0.0,
            "preemptions": 0, "preempted_tokens_refilled": 0,
        }
        self.cfg = cfg
        self.target = target
        self.slots = slots
        self.max_len = max_len
        self.kv_layout = kv_layout
        descs = cfg.layout.descriptors()
        # recurrent state would advance over pad tokens: exact prefill;
        # MoE capacity counts every token of a prefill: pad as the JAX
        # engine does (module docstring)
        self._recurrent = any(d.mixer == "mamba" for d in descs)
        self._pad_prefill = (not self._recurrent
                             and any(d.mlp == "moe" for d in descs))
        self.base = np.zeros((slots,), np.int64)  # per-slot seated memory
        self.base_len = 0  # the seat_compressed context's length
        self._seated: List[Optional[str]] = [None] * slots  # named prefix
        self._dirty = np.zeros((slots,), bool)  # used since seating
        kw = dict(dtype=target.dtype, device=self.device)
        if kv_layout == "paged":
            if prefix_store is not None:
                raise ValueError(
                    "paged engines own their PagedPrefixStore (its blocks "
                    "live in the engine's pool); pass prefix_capacity instead")
            table_width = -(-max_len // block_size)
            if num_blocks is None:
                # every slot's worst case, headroom for 4 resident task
                # prefixes, plus the reserved trash block
                num_blocks = 1 + (slots + 4) * table_width
            self.block_size = block_size
            self.alloc = BlockAllocator(num_blocks, block_size)
            self.cache = tfm.init_paged_cache(cfg, num_blocks, block_size,
                                              slots, **kw)
            self.tables = np.full((slots, table_width), TRASH_BLOCK, np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
            # blocks promised to admitted-but-unfinished requests: decode
            # allocations draw them down; _can_admit nets them off the
            # free count so concurrent slots can't race the pool empty
            self._reserved = np.zeros((slots,), np.int64)
            self._reserved_pending = 0  # admitted, not yet prefilled
            self.store = PagedPrefixStore(cfg, self.alloc,
                                          capacity=prefix_capacity)
        else:
            self.cache = tfm.init_cache(cfg, slots, max_len, **kw)
            self.store = (prefix_store if prefix_store is not None
                          else PrefixStore(cfg, capacity=prefix_capacity))
        # online compiler: raw_shots requests compile on the serving path,
        # at most compile_token_budget source tokens per loop iteration
        self.compile_token_budget = compile_token_budget
        self.compiler = (PrefixCompiler(compressor, cfg, target)
                         if compressor is not None else None)
        # tiered store: evictions demote down the hierarchy, cold prefixes
        # promote back promote_layer_budget layers per loop iteration
        self.promote_layer_budget = promote_layer_budget
        self.tiers: Optional[TieredPrefixStore] = None
        if host_capacity is not None or disk_dir is not None:
            self.store = self.tiers = TieredPrefixStore(
                self.store, host_capacity=host_capacity, disk_dir=disk_dir,
                cache_ref=lambda: self.cache, device=self.device)

    @property
    def paged(self) -> bool:
        return self.kv_layout == "paged"

    # ------------------------------------------------------------------
    # Prefix seating
    # ------------------------------------------------------------------

    def add_prefix(self, name: str, materialized: list,
                   batch_index: int = 0) -> str:
        """Register row ``batch_index`` of a materialized prefix as task
        ``name``.  In the paged layout this writes the prefix into pool
        blocks once; every slot later seated on it shares that copy."""
        if self.paged:
            return self.store.put(name, materialized, self.cache, batch_index)
        return self.store.put(name, materialized, batch_index)

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop this slot's references: private blocks return to the free
        pool; shared prefix blocks persist (the store holds a ref)."""
        for b in self._slot_blocks[slot]:
            self.alloc.decref(b)
        self._slot_blocks[slot] = []
        self.tables[slot, :] = TRASH_BLOCK

    def _seat_blocks(self, slot: int, name: str) -> None:
        """Point one slot's block table at a resident prefix's blocks."""
        self._release_slot_blocks(slot)
        blocks = self.store.blocks(name)
        for b in blocks:
            self.alloc.incref(b)
        self._slot_blocks[slot] = blocks
        self.tables[slot, :len(blocks)] = blocks

    def seat_prefix(self, slot: int, name: str) -> None:
        """Install task ``name``'s compressed memory into one slot."""
        clear_slot_state(self.cache, slot)
        if self.paged:
            self._seat_blocks(slot, name)
        else:
            seat_prefix_row(self.cache, self.store.get(name), slot)
        self.base[slot] = self.store.base_len(name)
        self._seated[slot] = name
        self._dirty[slot] = False

    def seat_compressed(self, materialized: list) -> None:
        """Install a batch of compressed contexts engine-wide: row b of
        ``materialized`` seats slot b and is kept in the store, so a slot
        that a named prefix displaced gets it back."""
        if self.cfg.memcom is None:
            raise ValueError(f"{self.cfg.name} has no MemCom config")
        self.base_len = self.cfg.memcom.num_memory_tokens
        if self.paged:
            for b in range(self.slots):
                name = self._COMPAT + str(b)
                # unseat first so a re-put never trips the eviction guard
                self._release_slot_blocks(b)
                self.store.put(name, materialized, self.cache, batch_index=b)
                self.seat_prefix(b, name)
        else:
            write_prefix_to_cache(self.cfg, self.cache, materialized)
            self.base[:] = self.base_len
            for b in range(self.slots):
                self.store.put(self._COMPAT + str(b), materialized,
                               batch_index=b)
        self._seated = [None] * self.slots
        self._dirty[:] = False

    def _reset_slot(self, slot: int) -> None:
        """Prepare a slot for a request that names no prefix: restore the
        engine-wide context if the slot no longer holds it (a named prefix
        displaced it, or a previous occupant advanced its recurrent
        state), else serve without context."""
        if self._seated[slot] is None and not (self._recurrent
                                               and self._dirty[slot]):
            return  # the slot still holds the engine-wide context (or none)
        if self._COMPAT + str(slot) in self.store:
            self.seat_prefix(slot, self._COMPAT + str(slot))
        else:
            clear_slot_state(self.cache, slot)
            if self.paged:
                self._release_slot_blocks(slot)
            self.base[slot] = 0
            self._dirty[slot] = False
        self._seated[slot] = None

    def _restore_slot(self, slot: int) -> None:
        """Refresh the context a slot holds (its named prefix or the
        engine-wide one) when earlier generation may have advanced its
        recurrent state; attention K/V at [0, base) is never overwritten,
        so only recurrent configs need this."""
        if not (self._recurrent and self._dirty[slot]):
            return
        if self._seated[slot] is not None:
            self.seat_prefix(slot, self._seated[slot])
        elif self._COMPAT + str(slot) in self.store:
            self.seat_prefix(slot, self._COMPAT + str(slot))
            self._seated[slot] = None
        else:
            clear_slot_state(self.cache, slot)
            self._dirty[slot] = False

    # ------------------------------------------------------------------
    # Continuous-batching serve loop
    # ------------------------------------------------------------------

    @torch.no_grad()
    def serve(self, requests: Iterable[Request], *,
              seed: int = 0) -> Dict[int, np.ndarray]:
        """Serve ragged, per-task requests to completion.  Returns
        {request.uid: generated tokens}, a stop token included when it
        fired.  More requests than slots is fine: finished slots are
        refilled mid-decode.  Requests with ``arrival_s`` are held until
        the clock reaches that offset from the start of the call; the
        timings land in ``request_log``, the events in ``trace``."""
        epoch = self.clock()  # request_log times are offsets from here
        sched = Scheduler(self.slots, clock=self.clock,
                          aging_interval_s=self.priority_aging_s)
        self.trace = []
        self.request_log = {}
        requests = list(requests)
        for req in requests:  # validate the whole batch first
            self._check_request(req)

        def _arrive(req: Request) -> None:
            self.request_log[req.uid] = {
                "priority": int(req.priority),
                "arrival_s": float(req.arrival_s if req.arrival_s is not None
                                   else self.clock() - epoch),
                "first_token_s": None, "finish_s": None,
                "tokens": 0, "preemptions": 0,
            }
            self._submit(sched, req)

        future = sorted((r for r in requests if r.arrival_s is not None),
                        key=lambda r: (r.arrival_s, r.uid))
        for req in requests:
            if req.arrival_s is None:
                _arrive(req)

        # per-request sampling streams seeded from (seed, uid): a request's
        # tokens do not depend on admission order or slot interleaving
        streams: Dict[int, np.random.Generator] = {}

        def _stream(req: Request) -> np.random.Generator:
            rng = streams.get(req.uid)
            if rng is None:
                rng = streams[req.uid] = np.random.default_rng(
                    np.random.SeedSequence([int(seed), int(req.uid)]))
            return rng

        results: Dict[int, np.ndarray] = {}
        pending = np.zeros((self.slots,), np.int32)  # next token per slot
        lengths = self.base.copy()  # per-slot valid cache length
        paged = self.paged
        # a resumed request re-prefills prompt + already-emitted tokens,
        # so the paged gate sizes its window on that longer prefill
        can_seat = ((lambda r: self._can_admit(r, sched.resume_len(r.uid)))
                    if paged else None)
        last_decode_done: Optional[float] = None
        c = self.counters

        def _finish(slot):
            req, toks = sched.finish(slot)
            if paged:
                self._reserved[slot] = 0  # unused decode headroom returns
            streams.pop(req.uid, None)
            results[req.uid] = toks
            log = self.request_log[req.uid]
            log["finish_s"] = self.clock() - epoch
            log["tokens"] = int(len(toks))

        while sched.has_work() or future:
            now_s = self.clock() - epoch
            while future and future[0].arrival_s <= now_s:
                _arrive(future.pop(0))
            if not sched.has_work():
                self._advance_to(epoch + future[0].arrival_s)
                continue
            if self.compiler is not None:
                self._drain_compiler(sched)
            if self.tiers is not None:
                self._drain_promoter(sched)
            admitted = sched.admit(can_seat)
            if paged and not admitted and not sched.active_slots() \
                    and sched.pending:
                # nothing running and the head request fails the gate:
                # reclaim every free slot's private blocks, retry once
                self._reclaim_free_slots(sched)
                admitted = sched.admit(can_seat)
                if not admitted:
                    raise OutOfBlocksError(
                        f"paged KV pool ({self.alloc.num_blocks} blocks of "
                        f"{self.block_size}) cannot hold the next request "
                        "even with every free slot reclaimed — grow "
                        "num_blocks or evict resident prefixes")
            if sched.pending:
                admitted += self._preempt_for_priority(
                    sched, can_seat, protected={s for s, _ in admitted})
            for slot, req in admitted:
                if req.prefix is not None:
                    # the slot's K/V at [0, base) still holds its prefix;
                    # recurrent state may have advanced since
                    if self._seated[slot] != req.prefix or self._recurrent:
                        self.seat_prefix(slot, req.prefix)
                else:
                    self._reset_slot(slot)
                # a preempted request resumes by re-prefilling everything
                # it had consumed and emitted: the rebuilt KV is exact
                resumed = sched.emitted_tokens(slot)
                toks = (np.concatenate([req.tokens, resumed])
                        if resumed.size else req.tokens)
                if resumed.size:
                    c["preempted_tokens_refilled"] += int(resumed.size)
                    self.trace.append(("resume", req.uid, slot,
                                       int(resumed.size)))
                if paged:
                    # the gate's pending reservation becomes this slot's:
                    # prefill allocates its share now, the rest stays
                    # reserved for the decode steps to draw down
                    self._reserved_pending -= self._blocks_needed(
                        req, self._req_base(req), extra=resumed.size)
                    base = int(self.base[slot])
                    need = self._blocks_needed(req, base, extra=resumed.size)
                    width = self._width(len(toks), self.max_len - base)
                    covered = (self.alloc.blocks_for(base + width)
                               - self.alloc.blocks_for(base)
                               + (1 if base % self.block_size else 0))
                    self._reserved[slot] = max(0, need - covered)
                row_logits = self._prefill_slot(slot, toks)
                lengths[slot] = self.base[slot] + len(toks)
                tok = self._sample_row(row_logits, req.temperature,
                                       _stream(req))
                pending[slot] = tok
                self.trace.append(("admit", req.uid, slot))
                log = self.request_log[req.uid]
                if log["first_token_s"] is None:
                    log["first_token_s"] = self.clock() - epoch
                if sched.record_token(slot, tok):
                    _finish(slot)
            active = sched.active_slots()
            compiling = (self.compiler is not None
                         and self.compiler.has_compile_work())
            promoting = (self.tiers is not None
                         and self.tiers.has_promote_work())
            if not active:
                # nothing decodes: a whole job stalls nobody; promotion is
                # the cheaper way to an admissible request, so it goes first
                if promoting:
                    self._promote_step(None)
                elif compiling:
                    self._compile_step(None)
                continue  # admit the next queued requests (or exit)
            greedy = all(sched.request_in(s).temperature <= 0 for s in active)
            if paged:
                self._ensure_decode_blocks(active, lengths)
            t_start = self.clock()
            out = self._decode_step(pending, lengths, greedy)
            self._charge("decode_step", 1)
            # the step advanced every slot's recurrent state, idle ones too
            self._dirty[:] = True
            c["decode_time_s"] += self.clock() - t_start
            if last_decode_done is not None:
                # decode gap: the non-decode time since the previous step
                gap = t_start - last_decode_done
                c["decode_gap_max_s"] = max(c["decode_gap_max_s"], gap)
                c["decode_gap_sum_s"] += gap
                c["decode_gaps"] += 1
            last_decode_done = self.clock()
            c["decode_steps"] += 1
            c["decode_steps_during_compile"] += int(compiling)
            c["decode_steps_during_promote"] += int(promoting)
            self.trace.append(("decode", len(active)))
            for slot in active:
                lengths[slot] += 1  # the step consumed this slot's token
                req = sched.request_in(slot)
                tok = int(out[slot]) if greedy else self._sample_row(
                    out[slot], req.temperature, _stream(req))
                pending[slot] = tok
                c["tokens_generated"] += 1
                if sched.record_token(slot, tok):
                    _finish(slot)
            if compiling:  # a budgeted chunk behind this decode step
                self._compile_step(self.compile_token_budget)
                c["compile_chunks_interleaved"] += 1
            if promoting:
                self._promote_step(self.promote_layer_budget)
                c["promote_steps_interleaved"] += 1
        return results

    def _preempt_for_priority(self, sched: Scheduler, can_seat,
                              protected=frozenset()):
        """Evict at most one running slot when the best queued request's
        base class strictly outranks it and admission left it stuck.  The
        victim is the worst running request (lowest class, then most
        emitted tokens, then highest slot), never one of ``protected``
        (admitted this iteration, not yet prefilled); its paged blocks are
        released and the scheduler stashes its tokens for a token-exact
        resume.  Returns what the retried admission seated."""
        cand = sched.best_queued()
        if cand is None:
            return []
        victims = [s for s in sched.active_slots()
                   if s not in protected
                   and sched.request_in(s).priority > cand.priority]
        if not victims:
            return []
        victim = max(victims, key=lambda s: (sched.request_in(s).priority,
                                             len(sched.emitted_tokens(s)), s))
        req = sched.preempt(victim)
        if self.paged:
            self._release_slot_blocks(victim)
            self._reserved[victim] = 0
            self.base[victim] = 0
            self._seated[victim] = None
        self.counters["preemptions"] += 1
        self.request_log[req.uid]["preemptions"] += 1
        self.trace.append(("preempt", req.uid, victim))
        return sched.admit(can_seat)

    def _advance_to(self, t: float) -> None:
        """Wait until the clock reads ``t``: a virtual clock jumps there;
        a wall clock sleeps one short slice (the loop re-checks)."""
        jump = getattr(self.clock, "advance_to", None)
        if jump is not None:
            jump(t)
            return
        dt = t - self.clock()
        if dt > 0:
            time.sleep(min(dt, 0.02))

    def _check_request(self, req: Request) -> None:
        """Side-effect-free validation of one request: the errors
        :meth:`_submit` would raise."""
        if req.prefix is not None and req.prefix not in self.store:
            if self.tiers is not None and self.tiers.cold_resident(req.prefix):
                base = self.tiers.cold_base_len(req.prefix)  # promotable
            elif req.raw_shots is None:
                raise KeyError(
                    f"unknown prefix {req.prefix!r}; registered: "
                    f"{sorted(self.store.names()) or '(none)'}")
            elif self.compiler is None:
                raise ValueError(
                    f"request {req.uid} carries raw_shots but the engine "
                    "has no compressor — pass ServingEngine(compressor=...)")
            else:
                base = self.cfg.memcom.num_memory_tokens  # the seat to come
        elif req.prefix is not None:
            base = self.store.base_len(req.prefix)
        else:
            # no-prefix requests land on the engine-wide base or a slot
            # reset to 0: base_len is the worst case
            base = self.base_len
        need = base + len(req.tokens) + req.max_new
        if need > self.max_len:
            raise ValueError(
                f"request {req.uid}: prefix+prompt+max_new={need} "
                f"exceeds max_len={self.max_len}")

    def _submit(self, sched: Scheduler, req: Request) -> None:
        """Queue a validated request.  One whose prefix is not resident
        parks ``waiting_on_prefix`` while the prefix is promoted from a
        cold tier or, failing that, compiled from its raw shots (both
        single-flight per name)."""
        if req.prefix is not None and not self.store.lookup(req.prefix):
            if self.tiers is not None and self.tiers.cold_resident(req.prefix):
                self.tiers.submit_promotion(req.prefix, priority=req.priority)
            else:
                self.compiler.submit(req.prefix, req.raw_shots,
                                     priority=req.priority)
            sched.park(req)
            self.trace.append(("park", req.uid, req.prefix))
            return
        sched.submit(req)

    # ------------------------------------------------------------------
    # Online compilation and tier promotion
    # ------------------------------------------------------------------

    def _compile_step(self, token_budget: Optional[int]) -> None:
        before = self.compiler.stats["tokens"]
        self.compiler.step(token_budget)
        consumed = self.compiler.stats["tokens"] - before
        if consumed:
            self._charge("compile_token", consumed)
            self.trace.append(("compile", consumed))

    def _promote_step(self, chunk_budget: Optional[int]) -> None:
        before = self.tiers.tier_stats["promote_chunks"]
        self.tiers.promote_step(chunk_budget)
        copied = self.tiers.tier_stats["promote_chunks"] - before
        if copied:
            self._charge("promote_chunk", copied)
            self.trace.append(("promote", copied))

    def _drain_promoter(self, sched: Scheduler) -> None:
        """Install at most one finished promotion and wake its requests
        (one per call, as :meth:`_drain_compiler`)."""
        ready = self.tiers.ready_promotions()
        if not ready:
            return
        name = ready[0]
        if not self._install(name, self.tiers.promoted_row(name), sched):
            return  # capacity held: retry on a later iteration
        self.tiers.mark_promoted(name)
        self.trace.append(("promoted", name))
        self._wake(sched, name)

    def _drain_compiler(self, sched: Scheduler) -> None:
        """Install at most one finished compilation and wake its
        requests.  One per call: the woken requests admit (and so seat
        and pin the fresh prefix) before a later install's LRU could
        reclaim it."""
        ready = self.compiler.ready()
        if not ready:
            return
        name = ready[0]
        row = take_prefix_row(self.compiler.job(name).materialized)
        if not self._install(name, row, sched):
            return
        self.compiler.mark_installed(name)
        self.trace.append(("seat", name))
        self._wake(sched, name)

    def _wake(self, sched: Scheduler, name: str) -> None:
        for req in sched.wake(name):
            self.trace.append(("wake", req.uid, name))

    def _install(self, name: str, row: list, sched: Scheduler) -> bool:
        """Make a compiled or promoted prefix row store-resident under
        capacity pressure.  A capped store whose every resident prefix is
        seated or pinned raises
        :class:`PrefixSeatedError`, an exhausted pool
        :class:`OutOfBlocksError`: free slots' stale block references are
        released and the put retried; still failing, the install is
        deferred while anything runs or waits in the queue, and raised
        only when nothing could ever free capacity."""
        # the prefixes of queued and parked requests must survive this
        # install's LRU; the pin lives only as long as the put
        if self.paged:
            def put():
                self.store.put_row(name, row, self.cache)
        else:
            def put():
                self.store.put_row(name, row)
        self.store.pinned = sched.referenced_prefixes()
        try:
            try:
                put()
                return True
            except (PrefixSeatedError, OutOfBlocksError):
                if self.paged:
                    self._reclaim_free_slots(sched)
                    try:
                        put()
                        return True
                    except (PrefixSeatedError, OutOfBlocksError):
                        pass
                if sched.active_slots() or sched.pending:
                    return False
                raise
        finally:
            self.store.pinned = set()

    def stats(self) -> dict:
        """Engine counters, the prefix store's hit/miss/put/eviction
        counters, the compiler's job/chunk counters, the tiers' counters
        and (paged) pool occupancy, under the JAX engine's keys."""
        out = {"engine": dict(self.counters),
               "prefix_store": dict(self.store.stats),
               "compiler": (dict(self.compiler.stats)
                            if self.compiler is not None else None),
               "budgets": {
                   "compile_token_budget": self.compile_token_budget,
                   "promote_layer_budget": self.promote_layer_budget}}
        if self.tiers is not None:
            out["prefix_tiers"] = self.tiers.tier_snapshot()
        if self.paged:
            out["pool"] = {
                "num_blocks": self.alloc.num_blocks,
                "block_size": self.block_size,
                "blocks_used": self.alloc.used_count,
                "blocks_free": self.alloc.free_count,
            }
        return out

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _width(self, n: int, cap: int) -> int:
        """The JAX engine's prefill width for ``n`` tokens with ``cap``
        positions left: exact for a recurrent config, else the bucket.
        Charges and paged reservations use it."""
        return n if self._recurrent else _bucket(n, cap)

    def _slot_view(self, slot: int, persist: bool) -> list:
        """The cache a one-slot prefill runs on: per-slot leaves (dense K/V
        stripes, Mamba2 conv/ssm) cut to the slot's row — views, so the
        forward's in-place writes land in the slot — and pooled K/V whole
        (the block table scopes those writes).  ``persist=False`` clones
        the per-slot rows instead, so the slot keeps its state."""
        def leaf(key, x):
            if self.paged and key in ("k", "v"):
                return x
            row = x[slot:slot + 1]
            return row if persist else row.clone()
        return [{key: leaf(key, x) for key, x in c.items()}
                for c in self.cache]

    def _prefill_slot(self, slot: int, tokens: np.ndarray,
                      persist: bool = True) -> torch.Tensor:
        """Prefill one slot's prompt behind its seated prefix; returns the
        last token's logits row.  ``persist=False`` leaves every cache
        stripe, pool block and recurrent state the engine holds
        untouched."""
        n = len(tokens)
        base = int(self.base[slot])
        cap = self.max_len - base
        if not 0 < n <= cap:
            raise ValueError(f"prompt of {n} tokens does not fit behind "
                             f"{base} seated slots in max_len {self.max_len}")
        self.counters["prefills"] += 1
        width = self._width(n, cap)  # the reference's prefill width
        self._charge("prefill_token", width)
        padded = np.zeros((1, width if self._pad_prefill else n), np.int64)
        padded[0, :n] = tokens
        kw = dict(tokens=torch.as_tensor(padded, device=self.device),
                  cache=self._slot_view(slot, persist), cache_index=base,
                  mask_offset=base)
        if self.paged:
            if persist:
                self._prepare_prefill(slot, base, width)
                table = self.tables[slot]
            else:
                snap = self.alloc.snapshot()
                table = self._scratch_table(slot, base, width)
            kw["block_tables"] = torch.as_tensor(table[None],
                                                 device=self.device)
        logits, _ = self.target(**kw)
        if persist:
            self._dirty[slot] = True
        elif self.paged:
            # the scratch blocks go back to the pool; the queued forward
            # still reads them before any later work can reuse them
            self.alloc.restore(snap)
        return logits[0, n - 1]

    def _decode_step(self, pending: np.ndarray, lengths: np.ndarray,
                     greedy: bool) -> np.ndarray:
        """One batched decode step: slot ``b`` consumes ``pending[b]`` at
        position ``lengths[b]``.  Returns the greedy ids (slots,) or the
        float32 logits (slots, vocab) on the host — the step's one sync."""
        toks = torch.as_tensor(pending.astype(np.int64)[:, None],
                               device=self.device)
        lens = torch.as_tensor(lengths.astype(np.int32), device=self.device)
        kw = {}
        if self.paged:
            kw = dict(block_tables=torch.as_tensor(self.tables,
                                                   device=self.device))
        logits, _ = self.target(tokens=toks, cache=self.cache,
                                cache_index=lens, decode=True, **kw)
        last = logits[:, -1]
        if greedy:
            return last.argmax(dim=-1).cpu().numpy()
        return last.float().cpu().numpy()

    @staticmethod
    def _sample_row(logits_row, temperature: float,
                    rng: np.random.Generator) -> int:
        if torch.is_tensor(logits_row):
            if temperature <= 0:
                return int(logits_row.argmax().tolist())
            logits_row = logits_row.float().cpu().numpy()
        if temperature <= 0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / temperature
        z -= z.max()
        p = np.exp(z)
        return int(rng.choice(len(p), p=p / p.sum()))

    # ------------------------------------------------------------------
    # Paged capacity management
    # ------------------------------------------------------------------

    def _reclaim_free_slots(self, sched: Scheduler) -> None:
        """Release every *free* slot's block references (finished-but-not-
        reseated slots still hold them)."""
        for slot in sched.free_slots():
            self._release_slot_blocks(slot)
            self.base[slot] = 0
            self._seated[slot] = None

    def _cow_block(self, slot: int, table_index: int) -> None:
        """Copy-on-write one table entry: copy the physical block, drop
        this slot's reference to the shared original, re-point the table
        at the private copy."""
        blocks = self._slot_blocks[slot]
        new = self.alloc.alloc(1)[0]
        copy_paged_block(self.cache, blocks[table_index], new)
        self.alloc.decref(blocks[table_index])
        blocks[table_index] = new
        self.tables[slot, table_index] = new

    def _prepare_prefill(self, slot: int, base: int, width: int) -> None:
        """Make the slot's table cover positions [0, base + width):
        copy-on-write a *shared* partial tail block (the prompt's first
        token lands inside it), then allocate fresh private blocks for
        the rest of the window."""
        bs = self.block_size
        blocks = self._slot_blocks[slot]
        if base % bs and blocks:
            ti = base // bs  # the partially filled tail block's index
            if self.alloc.refcount(blocks[ti]) > 1:  # shared: store/slots
                self._cow_block(slot, ti)
        need = self.alloc.blocks_for(base + width) - len(blocks)
        if need > 0:
            fresh = self.alloc.alloc(need)
            self.tables[slot, len(blocks):len(blocks) + need] = fresh
            blocks.extend(fresh)

    def _scratch_table(self, slot: int, base: int, width: int) -> np.ndarray:
        """A block table for a prefill whose writes must touch no block
        the engine holds: the slot's full prefix blocks (read only), a
        copy of its partial tail block, and fresh blocks for the window.
        The caller returns the new blocks with ``alloc.restore``."""
        bs = self.block_size
        held = self._slot_blocks[slot]
        blocks = list(held[:base // bs])
        if base % bs:
            tail = self.alloc.alloc(1)[0]
            copy_paged_block(self.cache, held[base // bs], tail)
            blocks.append(tail)
        blocks += self.alloc.alloc(self.alloc.blocks_for(base + width)
                                   - len(blocks))
        table = np.full(self.tables.shape[1:], TRASH_BLOCK, np.int32)
        table[:len(blocks)] = blocks
        return table

    def _ensure_decode_blocks(self, active, lengths) -> None:
        """Before a decode step, extend each active slot's table so its
        incoming write position is block-backed; allocations draw down
        the slot's admission-time reservation."""
        bs = self.block_size
        for slot in active:
            last = int(lengths[slot]) // bs
            blocks = self._slot_blocks[slot]
            while len(blocks) <= last:
                fresh = self.alloc.alloc(1)[0]
                self.tables[slot, len(blocks)] = fresh
                blocks.append(fresh)
                self._reserved[slot] = max(0, self._reserved[slot] - 1)
            if self.alloc.refcount(blocks[last]) > 1:
                # a decode write into a still-shared block cannot happen
                # after a >= 1-token prefill; COW beats a corrupted prefix
                self._cow_block(slot, last)

    def _blocks_needed(self, req: Request, base: int, extra: int = 0) -> int:
        """Worst-case private blocks for a request's whole window: the
        prefill bucket, the decode budget and a possible tail-block COW.
        ``extra`` counts already-emitted tokens a preempted request
        re-prefills on resume."""
        n = len(req.tokens) + extra
        width = self._width(n, self.max_len - base)
        total = base + max(width, len(req.tokens) + req.max_new)
        return (self.alloc.blocks_for(total) - self.alloc.blocks_for(base)
                + (1 if base % self.block_size else 0))

    def _req_base(self, req: Request) -> int:
        return (self.store.base_len(req.prefix) if req.prefix
                else self.base_len)

    def _can_admit(self, req: Request, extra: int = 0) -> bool:
        """Free-block admission gate: the request's whole private window
        must fit in the pool net of other slots' outstanding reservations,
        so a seated slot never stalls mid-decode waiting for memory.  A
        True return reserves the window."""
        need = self._blocks_needed(req, self._req_base(req), extra=extra)
        outstanding = int(self._reserved.sum()) + self._reserved_pending
        if need > self.alloc.free_count - outstanding:
            return False
        self._reserved_pending += need
        return True

    # ------------------------------------------------------------------
    # Compat APIs (lock-step batch generation, label scoring)
    # ------------------------------------------------------------------

    def generate(self, prompts, max_new: int, temperature: float = 0.0,
                 seed: int = 0, stop_token: Optional[int] = None) -> np.ndarray:
        """Batch-generate over the slot pool through :meth:`serve`, one
        request per slot naming no prefix (the slot serves the
        engine-wide context of :meth:`seat_compressed`, or none).
        ``prompts`` is a (slots, S) array or a list of ragged 1-D token
        arrays.  Returns (slots, n) int32; with a stop token, shorter rows
        are right-padded with it."""
        rows = [np.asarray(p, np.int32) for p in prompts]
        if len(rows) != self.slots:
            raise ValueError(f"{len(rows)} prompts for {self.slots} slots")
        if max_new == 0:
            return np.zeros((self.slots, 0), np.int32)
        reqs = [Request(tokens=r, max_new=max_new, stop_token=stop_token,
                        temperature=temperature) for r in rows]
        results = self.serve(reqs, seed=seed)
        outs = [results[r.uid] for r in reqs]
        n = max(len(o) for o in outs)
        fill = stop_token if stop_token is not None else 0
        return np.stack([np.pad(o, (0, n - len(o)), constant_values=fill)
                         for o in outs]).astype(np.int32)

    @torch.no_grad()
    def score_labels(self, context: np.ndarray, query: np.ndarray,
                     label_ids: np.ndarray) -> int:
        """Constrained classification: argmax over label token ids for the
        next token after [slot 0's context; context; query].  Restores a
        dirty recurrent slot 0's context first; the one-shot prefill then
        leaves the engine's cache untouched."""
        toks = np.concatenate([context, query]).astype(np.int32)
        self._restore_slot(0)
        row = self._prefill_slot(0, toks, persist=False)
        scores = row.float().cpu().numpy()
        return int(label_ids[np.argmax(scores[label_ids])])
