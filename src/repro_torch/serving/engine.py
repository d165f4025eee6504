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

Fused step (``fused_step=True``, attention-only layouts).  One forward
pass carries every seated slot's decode lane *plus* one bounded chunk: a
joining request's prompt, streamed ``fused_chunk_tokens`` at a time while
other slots decode, or a compile chunk of the
:class:`~repro_torch.serving.compiler.PrefixCompiler` run in the same
step's window, so admission and compile work open no decode gap.  The
step's lane width W is a power of two; lanes past a slot's valid count
write no cache row (``lane_valid``) and their outputs are ignored.  With
``spec_draft=`` / ``spec_k=`` the same lanes verify speculative drafts: a
greedy drafter (``"self"``, the target itself, or a ``(cfg, model)`` of
the same vocabulary) proposes k tokens a slot from its own dense cache of
the plain prompt, the fused step scores k + 1 positions at once, and
acceptance (the longest greedy match, or Leviathan's residual sampling on
the request's own stream) moves the slot's length forward: a rejection is
an implicit rollback of the K/V in both layouts.  A Mamba2 layer's state
would advance over the padding lanes, so the fused step and speculative
decoding raise for a recurrent config.  The step functions are plain
callables kept in a registry keyed by the JAX engine's geometry tuples,
and ``stats()["engine"]["jit_compiles"]`` counts the keys per family as
the JAX engine counts its compilations (no CUDA graph is captured).

The clock is injected (``clock=``, wall time by default): a
:class:`~repro_torch.serving.clock.VirtualClock` makes every timing a
function of the work performed; compile tokens, promoted layers and
drafter steps are charged too.

Observability (``tracer=``, ``metrics=``, ``watchdog=``), as the
reference wires it: a :class:`~repro_torch.serving.telemetry.Tracer`
records the request lifecycle's spans and instants on the engine's clock
(:data:`~repro_torch.serving.telemetry.NULL_TRACER`, a no-op, by
default); the counters live in a
:class:`~repro_torch.serving.telemetry.MetricsRegistry` (the engine's,
the scheduler's, the store's, the compiler's, the tiers' and the
clock's), so that ``stats()`` is a view over it and
``render_prometheus()`` gives the reference's text; an
:class:`~repro_torch.serving.slo_watchdog.SLOWatchdog` is fed TTFT, decode
gaps and tokens per step and may shed admissions below a priority floor
while a page alert holds (``shed_floor``).  Every recorded value is a
host value, and a step's span closes after the step's token readback:
tracing adds no device synchronization and changes no token.  With
``autotune_budgets=True`` the compile and promote budgets are halved
while the mean decode gap of the last ``autotune_interval`` gaps
overshoots ``target_decode_gap_s`` (or a page alert hints so) and doubled
back, up to 8x their configured values, while it undershoots half of it.
Meshes are a later slice of the port.
"""

from __future__ import annotations

import copy
import time
from collections import OrderedDict
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
from repro_torch.serving.telemetry import (NULL_TRACER, MetricGroup,
                                           MetricsRegistry, Tracer)
from repro_torch.serving.tiers import TieredPrefixStore


def _bucket(n: int, cap: int) -> int:
    """The JAX engine's prefill width for ``n`` tokens: the next power of
    two (min 8), clamped to the slot's remaining cache space."""
    return max(1, min(pow2_bucket(n, 8), cap))


def _lane_capable(cfg: ModelConfig) -> bool:
    """Can this config absorb padding lanes?  The fused step (and the
    drafter's masked decode) pad every slot to one lane width and rely on
    masked K/V writes and causal masking to hide the padding; a Mamba2
    state advances over it, and cross-attention / encoder stacks read
    non-causally."""
    return (cfg.encoder is None
            and all(d.mixer in ("attn", "mla") and not d.cross_attn
                    for d in cfg.layout.descriptors()))


def _has_moe(cfg: ModelConfig) -> bool:
    return any(d.mlp == "moe" for d in cfg.layout.descriptors())


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
                 clock=None, priority_aging_s: Optional[float] = None,
                 autotune_budgets: bool = False,
                 target_decode_gap_s: Optional[float] = None,
                 autotune_interval: int = 16,
                 fused_step: bool = False, fused_chunk_tokens: int = 16,
                 spec_draft=None, spec_k: int = 0,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 watchdog=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be dense or paged, got "
                             f"{kv_layout!r}")
        if compile_token_budget is not None and compile_token_budget < 1:
            raise ValueError("compile_token_budget must be >= 1 (or None)")
        if promote_layer_budget is not None and promote_layer_budget < 1:
            raise ValueError("promote_layer_budget must be >= 1 (or None)")
        if autotune_budgets:
            if target_decode_gap_s is None or target_decode_gap_s <= 0:
                raise ValueError("autotune_budgets needs a positive "
                                 "target_decode_gap_s")
            if compile_token_budget is None and promote_layer_budget is None:
                raise ValueError("autotune_budgets needs at least one of "
                                 "compile_token_budget/promote_layer_budget")
            if autotune_interval < 1:
                raise ValueError("autotune_interval must be >= 1")
        if fused_chunk_tokens < 1:
            raise ValueError("fused_chunk_tokens must be >= 1")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if (spec_k > 0) != (spec_draft is not None):
            raise ValueError("speculative decoding needs both spec_draft "
                             "and spec_k >= 1 (or neither)")
        if spec_k > 0 and not fused_step:
            raise ValueError("speculative decoding rides the fused step — "
                             "pass fused_step=True with spec_k")
        if (fused_step or spec_k) and not _lane_capable(cfg):
            raise ValueError(
                f"{cfg.name}: fused_step/speculative decoding need a pure "
                "attention/MLA layout — recurrent (mamba), cross-attention "
                "and encoder stacks cannot absorb masked garbage lanes")
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
        # telemetry: a no-op tracer by default and a fresh registry unless
        # the caller shares one; the tracer reads the engine's clock, so
        # spans sit on request_log's timeline
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled and self.tracer.clock is None:
            self.tracer.clock = self.clock
        attach = getattr(self.clock, "attach_metrics", None)
        if attach is not None:
            attach(self.metrics)  # charged-seconds counters by work kind
        # SLO burn-rate watchdog (opt-in): fed at the TTFT and gap sites,
        # stepped once per loop iteration; its degradation hook may set
        # shed_floor (admission shedding) and degrade_hint (autotuner
        # pressure) while a page alert is active
        self.watchdog = watchdog
        self.shed_floor: Optional[int] = None
        self.degrade_hint = False
        self.last_step_t: Optional[float] = None  # /healthz liveness
        if watchdog is not None:
            if watchdog.clock is None:
                watchdog.clock = self.clock
            watchdog.attach_engine(self)
        self.priority_aging_s = priority_aging_s
        self._autotune = autotune_budgets
        self.target_decode_gap_s = target_decode_gap_s
        self.autotune_interval = autotune_interval
        self._budget_init = (compile_token_budget, promote_layer_budget)
        self.request_log: Dict[int, dict] = {}  # per-request timings
        self.trace: List[tuple] = []  # per-serve event log
        # a registry-backed MetricGroup: every `self._counters[k] += 1`
        # lands in a `serving_engine_*` gauge
        self._counters = self.metrics.group("serving_engine", {
            "decode_steps": 0, "prefills": 0, "tokens_generated": 0,
            "decode_steps_during_compile": 0, "compile_chunks_interleaved": 0,
            "decode_steps_during_promote": 0, "promote_steps_interleaved": 0,
            "decode_gap_max_s": 0.0, "decode_gap_sum_s": 0.0,
            "decode_gaps": 0, "decode_time_s": 0.0,
            "preemptions": 0, "preempted_tokens_refilled": 0,
            "autotune_shrinks": 0, "autotune_grows": 0,
            # fused step: decode + chunk work in one step
            "fused_steps": 0, "fused_chunks": 0,
            "fused_prefill_chunks": 0, "fused_prefill_tokens": 0,
            "fused_compile_chunks": 0,
            # speculative decoding
            "spec_rounds": 0, "draft_proposed": 0, "draft_accepted": 0,
        }, help="engine loop counter")
        self._m_gap = self.metrics.histogram(
            "serving_decode_gap_seconds",
            "non-decode time between consecutive decode steps")
        self._m_ttft = self.metrics.histogram(
            "serving_ttft_seconds", "arrival to first token",
            labelnames=("priority",))
        self._m_latency = self.metrics.histogram(
            "serving_request_latency_seconds", "arrival to finish",
            labelnames=("priority",))
        self._m_jit = self.metrics.counter(
            "serving_jit_compiles_total",
            "jitted-program builds by step-function family",
            labelnames=("family",))
        self._gap_samples: List[float] = []  # every decode gap (p50/p99)
        self._gap_window: List[float] = []   # gaps since the last autotune
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
        if self.compiler is not None:
            self.compiler.stats = self.metrics.group(
                "serving_compiler", self.compiler.stats,
                help="online prefix compiler counter")
        # adopt the store's counters before the tiers front it (the tiered
        # facade's `stats` delegates to this same group)
        if not isinstance(self.store.stats, MetricGroup):
            self.store.stats = self.metrics.group(
                "serving_prefix_store", self.store.stats,
                help="HBM prefix store counter")
        # tiered store: evictions demote down the hierarchy, cold prefixes
        # promote back promote_layer_budget layers per loop iteration
        self.promote_layer_budget = promote_layer_budget
        self.tiers: Optional[TieredPrefixStore] = None
        if host_capacity is not None or disk_dir is not None:
            self.store = self.tiers = TieredPrefixStore(
                self.store, host_capacity=host_capacity, disk_dir=disk_dir,
                cache_ref=lambda: self.cache, device=self.device)
            self.tiers.tier_stats = self.metrics.group(
                "serving_prefix_tiers", self.tiers.tier_stats,
                help="tiered prefix cache counter")
        # fused step and speculative decoding.  The step functions are
        # kept by geometry key (the JAX engine's jit keys): the per-family
        # count of keys seen is the reference's compile count, which lives
        # as long as the engine (reset_stats leaves it alone)
        self.fused = bool(fused_step)
        self.fused_chunk_tokens = int(fused_chunk_tokens)
        self._joining: "OrderedDict[int, dict]" = OrderedDict()
        self._programs: "OrderedDict[tuple, object]" = OrderedDict()
        self._program_cap = 128  # LRU, as the reference's registry
        self._jit_compiles: Dict[str, int] = {}
        self._geom_seen: set = set()
        self.spec_k = int(spec_k)
        self._draft_cfg = self._drafter = None
        if self.spec_k:
            if spec_draft == "self":
                # self-speculation: the target drafts for itself from the
                # plain prompt (no prefix): the acceptance upper bound
                self._draft_cfg, self._drafter = cfg, target
            else:
                self._draft_cfg, self._drafter = spec_draft
            dcfg = self._draft_cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"drafter vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size} — drafts would be meaningless")
            if not _lane_capable(dcfg):
                raise ValueError(
                    f"drafter {dcfg.name}: needs a pure attention/MLA "
                    "layout (its cache rolls forward by accepted length)")
            if self._drafter.device.type != self.device.type:
                raise ValueError(f"drafter lives on {self._drafter.device}, "
                                 f"engine on {self.device}")
            # the drafter keeps its own dense per-slot cache in either
            # layout: it drafts from the plain prompt and shares no blocks
            self._draft_cache = tfm.init_cache(
                dcfg, slots, max_len, dtype=self._drafter.dtype,
                device=self.device)
            self._draft_len = np.zeros((slots,), np.int64)

    @property
    def paged(self) -> bool:
        return self.kv_layout == "paged"

    @property
    def counters(self) -> MetricGroup:
        """The engine's counters (``stats()["engine"]``'s own keys)."""
        return self._counters

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
    # Fused step + speculative decoding step functions
    # ------------------------------------------------------------------

    def _note_geometry(self, family: str, key: tuple) -> None:
        """Count a step-function family's geometry the first time it is
        seen (the reference's jit compilation of a classic step)."""
        k = (family, key)
        if k not in self._geom_seen:
            self._geom_seen.add(k)
            self._jit_compiles[family] = self._jit_compiles.get(family, 0) + 1
            self._m_jit.inc(family=family)

    def _program(self, family: str, key: tuple, make):
        """The geometry-keyed registry of step functions (LRU-bounded as
        the reference's program cache: an evicted key counts again)."""
        full = (family,) + key
        fn = self._programs.get(full)
        if fn is None:
            fn = self._programs[full] = make()
            self._jit_compiles[family] = self._jit_compiles.get(family, 0) + 1
            self._m_jit.inc(family=family)
            while len(self._programs) > self._program_cap:
                self._programs.popitem(last=False)
        else:
            self._programs.move_to_end(full)
        return fn

    def _fused_program(self, W: int, greedy: bool, comp_geom):
        """The fused step at lane width ``W``: every slot's decode (and
        speculative verify) lanes, a joining slot's chunk lanes and, when
        ``comp_geom = (offset, width, cache bucket)``, a compile chunk, in
        one step; one host sync reads the greedy ids (slots, W) or the
        float32 logits (slots, W, vocab).  Lanes ``s >= valids[b]`` write
        no cache row; lane ``s`` of slot ``b`` queries position
        ``lengths[b] + s``, so causality hides whatever they touch."""
        def make():
            body = (self.compiler.chunk_body(comp_geom[0])
                    if comp_geom is not None else None)

            def run(tokens, lengths, valids, comp):
                kw = {}
                if self.paged:
                    kw["block_tables"] = self._dev(self.tables)
                logits, _ = self.target(
                    tokens=self._dev(tokens), cache=self.cache,
                    cache_index=self._dev(lengths.astype(np.int32)),
                    decode=True, lane_valid=self._dev(valids), **kw)
                out = logits.argmax(dim=-1) if greedy else logits.float()
                comp_out = body(*comp) if body is not None else None
                return out.cpu().numpy(), comp_out

            return run

        return self._program("fused", (W, bool(greedy), comp_geom), make)

    def _draft_prog(self, k: int):
        """k drafter proposals and one catch-up step (it writes the last
        draft's K/V, so after a fully accepted round the drafter's cache
        holds every token the target consumed), each a one-lane masked
        decode over every slot of the drafter's cache; a write past the
        stripe is dropped (``ln < max_len``).  Returns (slots, k) ids."""
        drafter, max_len = self._drafter, self.max_len

        def make():
            def run(pending, lens):
                tok = self._dev(pending.astype(np.int64))
                ln = self._dev(lens.astype(np.int32))
                drafts = []
                for _ in range(k + 1):
                    logits, _ = drafter(
                        tokens=tok[:, None], cache=self._draft_cache,
                        cache_index=ln, decode=True,
                        lane_valid=(ln < max_len).to(torch.int32))
                    tok = logits[:, -1].argmax(dim=-1)
                    drafts.append(tok)
                    ln = ln + 1
                # steps 0..k-1 emit d1..dk; step k only rolls the cache
                return torch.stack(drafts[:k], dim=1).cpu().numpy()

            return run

        return self._program("draft", (k,), make)

    def _draft_prefill(self, slot: int, tokens: np.ndarray) -> None:
        """(Re)build the drafter's stripe of one slot from position 0 with
        the plain prompt (+ any resumed tokens), never the compressed
        prefix: that lowers acceptance for prefixed tasks, never
        correctness, since every draft is verified.  The registry keys it
        by the reference's padded width; a MoE drafter is padded to it
        (its capacity counts every token), another prefills exactly."""
        n = len(tokens)
        width = max(1, min(pow2_bucket(n, 8), self.max_len))
        drafter = self._drafter

        def make():
            def run(toks, s):
                drafter(tokens=self._dev(toks),
                        cache=self._slot_view(self._draft_cache, s),
                        cache_index=0, mask_offset=0, logits=False)

            return run

        prog = self._program("draft_prefill", (width,), make)
        padded = np.zeros((1, width if _has_moe(self._draft_cfg) else n),
                          np.int64)
        padded[0, :n] = tokens
        prog(padded, slot)
        self._draft_len[slot] = n
        self._charge("draft_step", 1)

    @staticmethod
    def _softmax_row(logits_row: np.ndarray, temperature: float) -> np.ndarray:
        z = np.asarray(logits_row, np.float64) / temperature
        z -= z.max()
        p = np.exp(z)
        return p / p.sum()

    def _spec_sample(self, logits_rows: np.ndarray, drafts: np.ndarray,
                     temperature: float, rng: np.random.Generator):
        """Sampled (Leviathan) acceptance against a greedy drafter: its
        distribution is a point mass at the draft d, so d is accepted with
        probability p(d) and a rejection resamples from p with d zeroed;
        the emitted stream is distributed as token-by-token sampling from
        the target.  Returns (emitted tokens, accepted drafts); the draws
        come from the request's own stream."""
        emitted: List[int] = []
        accepted = 0
        for j, d in enumerate(np.asarray(drafts, np.int64)):
            p = self._softmax_row(logits_rows[j], temperature)
            if rng.uniform() < p[d]:
                emitted.append(int(d))
                accepted += 1
                continue
            q = p.copy()
            q[d] = 0.0
            tot = q.sum()
            if tot <= 0.0:  # the target is a point mass at d too
                emitted.append(int(d))
                accepted += 1
                continue
            emitted.append(int(rng.choice(len(q), p=q / tot)))
            return emitted, accepted
        # every draft accepted: a bonus token from the last verify lane
        p = self._softmax_row(logits_rows[len(drafts)], temperature)
        emitted.append(int(rng.choice(len(p), p=p)))
        return emitted, accepted

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
        timings land in ``request_log``, the events in ``trace``.  If the
        loop dies, the tracer's flight recorder is dumped (when it has a
        dump path) before the exception propagates."""
        try:
            return self._serve_impl(requests, seed=seed)
        except BaseException:
            self.tracer.dump_on_error()
            raise

    def _serve_impl(self, requests: Iterable[Request], *,
                    seed: int = 0) -> Dict[int, np.ndarray]:
        epoch = self.clock()  # request_log times are offsets from here
        sched = Scheduler(self.slots, clock=self.clock,
                          aging_interval_s=self.priority_aging_s,
                          metrics=self.metrics)
        self.trace = []
        self.request_log = {}
        tr = self.tracer
        # trace ids are serve-local arrival ordinals, not Request.uid (a
        # process-global counter): the trace stays a function of (scenario,
        # seed) across runs in one process
        self._rids: Dict[int, int] = {}
        requests = list(requests)
        for req in requests:  # validate the whole batch first
            self._check_request(req)

        def _arrive(req: Request) -> None:
            rid = self._rids[req.uid] = len(self._rids)
            self.request_log[req.uid] = {
                "priority": int(req.priority),
                "arrival_s": float(req.arrival_s if req.arrival_s is not None
                                   else self.clock() - epoch),
                "first_token_s": None, "finish_s": None,
                "tokens": 0, "preemptions": 0,
            }
            if tr.enabled:
                tr.instant("scheduler", "arrive", rid=rid,
                           priority=int(req.priority))
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
        wd = self.watchdog
        if wd is not None:
            base_seat = can_seat

            def can_seat(r, _base=base_seat):
                # degradation hook: while a page alert holds shed_floor,
                # park lower-priority admissions, but only while some
                # slot runs, so shedding an idle engine cannot deadlock
                if (self.shed_floor is not None
                        and int(r.priority) >= self.shed_floor
                        and sched.active_slots()):
                    return False
                return True if _base is None else _base(r)
        last_decode_done: Optional[float] = None
        self.last_step_t = self.clock()
        c = self._counters

        def _finish(slot):
            req, toks = sched.finish(slot)
            if paged:
                self._reserved[slot] = 0  # unused decode headroom returns
            streams.pop(req.uid, None)
            results[req.uid] = toks
            log = self.request_log[req.uid]
            log["finish_s"] = self.clock() - epoch
            log["tokens"] = int(len(toks))
            self._m_latency.observe(log["finish_s"] - log["arrival_s"],
                                    priority=log["priority"])
            if tr.enabled:
                tr.instant(f"slot{slot}", "finish",
                           rid=self._rids[req.uid], tokens=len(toks))

        def _first_token(req: Request) -> None:
            log = self.request_log[req.uid]
            if log["first_token_s"] is None:
                log["first_token_s"] = self.clock() - epoch
                ttft = log["first_token_s"] - log["arrival_s"]
                self._m_ttft.observe(ttft, priority=log["priority"])
                if wd is not None:
                    wd.observe("ttft", ttft)

        while sched.has_work() or future:
            if wd is not None:
                wd_steps0 = c["decode_steps"]
                wd_toks0 = c["tokens_generated"]
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
                    sched, can_seat,
                    protected={s for s, _ in admitted} | set(self._joining))
            # fused chunked admission: while other slots decode (or a join
            # is in flight), a new request joins and its prompt streams
            # through the fused steps instead of one prefill-sized gap
            admitted_slots = {s for s, _ in admitted}
            busy_decode = any(s not in admitted_slots
                              and s not in self._joining
                              for s in sched.active_slots())
            for slot, req in admitted:
                t_adm = self.clock() if tr.enabled else 0.0
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
                    if tr.enabled:
                        tr.instant(f"slot{slot}", "resume",
                                   rid=self._rids[req.uid],
                                   tokens=int(resumed.size))
                if paged:
                    # the gate's pending reservation becomes this slot's:
                    # prefill allocates its share now, the rest stays
                    # reserved for the decode steps to draw down
                    self._reserved_pending -= self._blocks_needed(
                        req, self._req_base(req), extra=resumed.size)
                    base = int(self.base[slot])
                    need = self._blocks_needed(req, base, extra=resumed.size)
                if self.fused and (busy_decode or self._joining):
                    self._joining[slot] = {"req": req, "toks": toks,
                                           "consumed": 0, "t0": t_adm}
                    lengths[slot] = self.base[slot]
                    if paged:
                        # the whole window stays reserved; chunk prefills
                        # and decode steps draw it down as they allocate
                        self._reserved[slot] = need
                    self.trace.append(("admit", req.uid, slot))
                    self.trace.append(("join", req.uid, slot, len(toks)))
                    continue
                if paged:
                    width = self._width(len(toks), self.max_len - base)
                    covered = (self.alloc.blocks_for(base + width)
                               - self.alloc.blocks_for(base)
                               + (1 if base % self.block_size else 0))
                    self._reserved[slot] = max(0, need - covered)
                row_logits = self._prefill_slot(slot, toks)
                lengths[slot] = self.base[slot] + len(toks)
                if self.spec_k:
                    self._draft_prefill(slot, toks)
                tok = self._sample_row(row_logits, req.temperature,
                                       _stream(req))
                pending[slot] = tok
                self.trace.append(("admit", req.uid, slot))
                if tr.enabled:
                    tr.span(f"slot{slot}", "admission", t_adm,
                            rid=self._rids[req.uid], prefix=req.prefix,
                            prompt_tokens=len(toks),
                            resumed=int(resumed.size))
                _first_token(req)
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
            decode_lanes = [s for s in active if s not in self._joining]
            chunk_slot = next(iter(self._joining)) if self._joining else None
            comp = None
            if (self.fused and compiling and chunk_slot is None
                    and self.compile_token_budget is not None):
                # the chunk lane is free: a compile chunk rides the step
                comp = self.compiler.peek_chunk(self.compile_token_budget)
            spec = bool(self.spec_k and decode_lanes)
            if not (self.fused and (spec or chunk_slot is not None
                                    or comp is not None)):
                # ---- classic single-token decode step ----
                greedy = all(sched.request_in(s).temperature <= 0
                             for s in active)
                self._note_geometry("decode", (bool(greedy),))
                if paged:
                    self._ensure_decode_blocks(active, lengths)
                t_start = self.clock()
                out = self._decode_step(pending, lengths, greedy)
                self._charge("decode_step", 1)
                # the step advanced every slot's recurrent state, idle
                # ones too
                self._dirty[:] = True
                c["decode_time_s"] += self.clock() - t_start
                last_decode_done = self._step_done(t_start, last_decode_done,
                                                   compiling, promoting)
                if tr.enabled:
                    tr.span("engine", "decode_step", t_start,
                            last_decode_done, active=len(active))
                self.trace.append(("decode", len(active)))
                for slot in active:
                    lengths[slot] += 1  # the step consumed this slot's token
                    req = sched.request_in(slot)
                    tok = int(out[slot]) if greedy else self._sample_row(
                        out[slot], req.temperature, _stream(req))
                    pending[slot] = tok
                    c["tokens_generated"] += 1
                    if self.spec_k:
                        self._draft_len[slot] += 1
                    if sched.record_token(slot, tok):
                        _finish(slot)
                if compiling:  # a budgeted chunk behind this decode step
                    self._compile_step(self.compile_token_budget)
                    c["compile_chunks_interleaved"] += 1
                if promoting:
                    self._promote_step(self.promote_layer_budget)
                    c["promote_steps_interleaved"] += 1
                self._end_iteration(wd, wd_steps0 if wd is not None else 0,
                                    wd_toks0 if wd is not None else 0)
                continue
            # ---- fused step: decode lanes + one chunk, one step ----
            # everything up to the bookkeeping sits inside the step's
            # timing window, so a join or compile chunk widens no gap
            t_start = self.clock()
            drafts = None
            k_eff = np.zeros((self.slots,), np.int64)
            if spec:
                for s in decode_lanes:
                    req = sched.request_in(s)
                    left = req.max_new - len(sched.emitted_tokens(s))
                    k_eff[s] = max(0, min(self.spec_k, left - 1,
                                          self.max_len - int(lengths[s]) - 1))
                drafts = self._draft_prog(self.spec_k)(pending,
                                                       self._draft_len)
                self._charge("draft_step", self.spec_k + 1)
                c["spec_rounds"] += 1
            chunk_n, jn = 0, None
            if chunk_slot is not None:
                jn = self._joining[chunk_slot]
                chunk_n = min(len(jn["toks"]) - jn["consumed"],
                              self.fused_chunk_tokens)
            lanes = 1 + (self.spec_k if spec else 0)
            W = pow2_bucket(max(lanes, chunk_n), 1)
            tokens_in = np.zeros((self.slots, W), np.int64)
            valids = np.zeros((self.slots,), np.int32)
            for s in decode_lanes:
                tokens_in[s, 0] = pending[s]
                kk = int(k_eff[s])
                if kk:
                    tokens_in[s, 1:1 + kk] = drafts[s, :kk]
                valids[s] = 1 + kk
            completing = False
            if chunk_slot is not None:
                c0 = jn["consumed"]
                tokens_in[chunk_slot, :chunk_n] = jn["toks"][c0:c0 + chunk_n]
                valids[chunk_slot] = chunk_n
                completing = c0 + chunk_n == len(jn["toks"])
            greedy = all(sched.request_in(s).temperature <= 0
                         for s in decode_lanes)
            if completing and jn["req"].temperature > 0:
                greedy = False  # the chunk's first token is sampled
            if paged:
                self._ensure_decode_blocks(decode_lanes, lengths,
                                           widths=valids)
                if chunk_slot is not None:
                    got = self._prepare_prefill(
                        chunk_slot, int(lengths[chunk_slot]), chunk_n)
                    self._reserved[chunk_slot] = max(
                        0, int(self._reserved[chunk_slot]) - got)
            comp_geom = comp_args = None
            cw = 0
            if comp is not None:
                job, offset, cw, clen = comp
                # the reference keys its program on the power-of-two
                # source-cache length its compiler allocates
                comp_geom = (offset, cw, pow2_bucket(clen, 16))
                comp_args = (self.compiler.compressor, job.state.cache,
                             self.compiler.chunk_tokens(job, cw))
            out, comp_out = self._fused_program(W, greedy, comp_geom)(
                tokens_in, lengths, valids, comp_args)
            self._charge("decode_step", 1)
            if chunk_n:
                self._charge("prefill_token", chunk_n)
            if comp is not None:
                self._charge("compile_token", cw)
            self._dirty[:] = True
            c["decode_time_s"] += self.clock() - t_start
            last_decode_done = self._step_done(t_start, last_decode_done,
                                               compiling, promoting)
            if tr.enabled:
                tr.span("engine", "fused_step", t_start, last_decode_done,
                        lanes=len(decode_lanes), chunk_tokens=int(chunk_n),
                        compile_tokens=int(cw))
            c["fused_steps"] += 1
            if chunk_n or comp is not None:
                c["fused_chunks"] += 1
            self.trace.append(("fused", len(decode_lanes), int(chunk_n),
                               int(cw)))
            if chunk_slot is not None:
                jn["consumed"] += chunk_n
                lengths[chunk_slot] += chunk_n
                c["fused_prefill_chunks"] += 1
                c["fused_prefill_tokens"] += int(chunk_n)
                if completing:
                    del self._joining[chunk_slot]
                    req = jn["req"]
                    c["prefills"] += 1
                    tok = (int(out[chunk_slot, chunk_n - 1]) if greedy
                           else self._sample_row(
                               out[chunk_slot, chunk_n - 1], req.temperature,
                               _stream(req)))
                    pending[chunk_slot] = tok
                    if self.spec_k:
                        self._draft_prefill(chunk_slot, jn["toks"])
                    self.trace.append(("join_done", req.uid, chunk_slot))
                    if tr.enabled:
                        tr.span(f"slot{chunk_slot}", "admission", jn["t0"],
                                rid=self._rids[req.uid], prefix=req.prefix,
                                prompt_tokens=len(jn["toks"]),
                                fused_join=True)
                    _first_token(req)
                    if sched.record_token(chunk_slot, tok):
                        _finish(chunk_slot)
            for s in decode_lanes:
                req = sched.request_in(s)
                kk = int(k_eff[s])
                if kk == 0:  # a plain decode lane (no drafts this round)
                    lengths[s] += 1
                    tok = (int(out[s, 0]) if greedy else self._sample_row(
                        out[s, 0], req.temperature, _stream(req)))
                    pending[s] = tok
                    c["tokens_generated"] += 1
                    if self.spec_k:
                        self._draft_len[s] += 1
                    if sched.record_token(s, tok):
                        _finish(s)
                    continue
                c["draft_proposed"] += kk
                dr = drafts[s, :kk]
                if greedy or req.temperature <= 0:
                    # greedy acceptance: the longest prefix where the
                    # drafter matched the target's argmax; the emitted
                    # tokens are exactly the non-speculative stream
                    g = (out[s, :kk + 1] if greedy
                         else np.argmax(out[s, :kk + 1], axis=-1))
                    a = 0
                    while a < kk and int(dr[a]) == int(g[a]):
                        a += 1
                    emitted = [int(t) for t in g[:a + 1]]
                else:
                    emitted, a = self._spec_sample(
                        out[s, :kk + 1], dr, req.temperature, _stream(req))
                c["draft_accepted"] += a
                if tr.enabled:
                    tr.instant(f"slot{s}", "spec_accept",
                               rid=self._rids[req.uid], proposed=kk,
                               accepted=int(a))
                # implicit K/V rollback: only the accepted prefix counts;
                # rejected lanes' rows sit past the new length (dense) or
                # in private tail blocks (paged), unseen until overwritten
                lengths[s] += len(emitted)
                self._draft_len[s] += len(emitted)
                pending[s] = emitted[-1]
                for t in emitted:
                    c["tokens_generated"] += 1
                    if sched.record_token(s, t):
                        _finish(s)
                        break
            if comp is not None:
                self.compiler.absorb_chunk(job, comp_out[0], comp_out[1], cw)
                c["fused_compile_chunks"] += 1
                c["compile_chunks_interleaved"] += 1
                self.trace.append(("compile", cw))
                if tr.enabled:
                    # the chunk rode the fused step: its span is the
                    # step's own window on the compiler track
                    tr.span("compiler", "compile_chunk", t_start,
                            last_decode_done, tokens=int(cw), fused=True)
            elif compiling and self.compile_token_budget is None:
                # an unbudgeted compile cannot ride the chunk lane: the
                # whole job behind this step (the stalled baseline)
                self._compile_step(None)
                c["compile_chunks_interleaved"] += 1
            if promoting:
                self._promote_step(self.promote_layer_budget)
                c["promote_steps_interleaved"] += 1
            self._end_iteration(wd, wd_steps0 if wd is not None else 0,
                                wd_toks0 if wd is not None else 0)
        self._refresh_gauges()
        return results

    def _end_iteration(self, wd, steps0: int, toks0: int) -> None:
        """A loop iteration's close: the watchdog's tokens-per-step sample
        and evaluation, and the autotuner once its window is full."""
        if wd is not None:
            # goodput proxy: tokens emitted per engine step this iteration
            # (speculative acceptance lifts it above 1 a lane)
            dsteps = self._counters["decode_steps"] - steps0
            if dsteps:
                wd.observe("tokens_per_step",
                           (self._counters["tokens_generated"] - toks0)
                           / dsteps)
            wd.step()
        if self._autotune and len(self._gap_window) >= self.autotune_interval:
            self._autotune_step()

    def _step_done(self, t_start: float, last_done: Optional[float],
                   compiling: bool, promoting: bool) -> float:
        """Close one decode step (classic or fused) that started at
        ``t_start``: record the decode gap since ``last_done`` (the
        non-decode time between steps; the autotuner's window, the gap
        histogram and the watchdog see it too) and count the step.
        Returns the step's end, which is also ``last_step_t``."""
        c = self._counters
        if last_done is not None:
            gap = t_start - last_done
            c["decode_gap_max_s"] = max(c["decode_gap_max_s"], gap)
            c["decode_gap_sum_s"] += gap
            c["decode_gaps"] += 1
            self._gap_samples.append(gap)
            self._gap_window.append(gap)
            self._m_gap.observe(gap)
            if self.watchdog is not None:
                self.watchdog.observe("decode_gap", gap)
        c["decode_steps"] += 1
        c["decode_steps_during_compile"] += int(compiling)
        c["decode_steps_during_promote"] += int(promoting)
        self.last_step_t = self.clock()
        return self.last_step_t

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
        self._counters["preemptions"] += 1
        self.request_log[req.uid]["preemptions"] += 1
        self.trace.append(("preempt", req.uid, victim))
        if self.tracer.enabled:
            self.tracer.instant(f"slot{victim}", "preempt",
                                rid=self._rids[req.uid],
                                by_priority=int(cand.priority))
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

    def _autotune_step(self) -> None:
        """Feedback on the compile and promote budgets: while the mean
        decode gap of the last window overshoots the target (or a page
        alert's degradation hint is set), halve them; while it undershoots
        half the target, double them back, up to 8x their configured
        values.  A new compile width is a new geometry key of the fused
        step's registry."""
        window = self._gap_window
        mean_gap = sum(window) / len(window)
        del window[:]
        init_c, init_p = self._budget_init
        if mean_gap > self.target_decode_gap_s or self.degrade_hint:
            changed = False
            if self.compile_token_budget is not None \
                    and self.compile_token_budget > 1:
                self.compile_token_budget = self.compile_token_budget // 2
                changed = True
            if self.promote_layer_budget is not None \
                    and self.promote_layer_budget > 1:
                self.promote_layer_budget = self.promote_layer_budget // 2
                changed = True
            if changed:
                self._counters["autotune_shrinks"] += 1
                self.trace.append(("autotune", "shrink",
                                   self.compile_token_budget,
                                   self.promote_layer_budget))
                if self.tracer.enabled:
                    self.tracer.instant(
                        "engine", "autotune", action="shrink",
                        compile_budget=self.compile_token_budget,
                        promote_budget=self.promote_layer_budget)
        elif mean_gap < self.target_decode_gap_s / 2:
            changed = False
            if init_c is not None and self.compile_token_budget < init_c * 8:
                self.compile_token_budget = min(
                    self.compile_token_budget * 2, init_c * 8)
                changed = True
            if init_p is not None and self.promote_layer_budget < init_p * 8:
                self.promote_layer_budget = min(
                    self.promote_layer_budget * 2, init_p * 8)
                changed = True
            if changed:
                self._counters["autotune_grows"] += 1
                self.trace.append(("autotune", "grow",
                                   self.compile_token_budget,
                                   self.promote_layer_budget))
                if self.tracer.enabled:
                    self.tracer.instant(
                        "engine", "autotune", action="grow",
                        compile_budget=self.compile_token_budget,
                        promote_budget=self.promote_layer_budget)

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
            if self.tracer.enabled:
                self.tracer.begin_async("scheduler", "waiting_on_prefix",
                                        self._rids[req.uid],
                                        prefix=req.prefix)
            return
        sched.submit(req)

    # ------------------------------------------------------------------
    # Online compilation and tier promotion
    # ------------------------------------------------------------------

    def _compile_step(self, token_budget: Optional[int]) -> None:
        before = self.compiler.stats["tokens"]
        t0 = self.clock()
        self.compiler.step(token_budget)
        consumed = self.compiler.stats["tokens"] - before
        if consumed:
            self._charge("compile_token", consumed)
            self.trace.append(("compile", consumed))
            if self.tracer.enabled:
                self.tracer.span("compiler", "compile_chunk", t0,
                                 tokens=int(consumed))

    def _promote_step(self, chunk_budget: Optional[int]) -> None:
        before = self.tiers.tier_stats["promote_chunks"]
        t0 = self.clock()
        self.tiers.promote_step(chunk_budget)
        copied = self.tiers.tier_stats["promote_chunks"] - before
        if copied:
            self._charge("promote_chunk", copied)
            self.trace.append(("promote", copied))
            if self.tracer.enabled:
                self.tracer.span("promoter", "promote_chunk", t0,
                                 chunks=int(copied))

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
        if self.tracer.enabled:
            self.tracer.instant("promoter", "promoted", prefix=name)
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
        if self.tracer.enabled:
            self.tracer.instant("compiler", "prefix_installed", prefix=name)
        self._wake(sched, name)

    def _wake(self, sched: Scheduler, name: str) -> None:
        for req in sched.wake(name):
            self.trace.append(("wake", req.uid, name))
            if self.tracer.enabled:
                self.tracer.end_async("scheduler", "waiting_on_prefix",
                                      self._rids[req.uid])

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

    def reset_stats(self) -> None:
        """Zero every counter (engine, store, compiler, tiers), the gap
        samples and the autotuner's window; the step functions' geometry
        counts and the live budgets stay."""
        for k in self._counters:
            self._counters[k] = type(self._counters[k])(0)
        self._gap_samples = []
        self._gap_window = []
        for group in (self.store.stats,
                      self.compiler.stats if self.compiler else {},
                      self.tiers.tier_stats if self.tiers else {}):
            for k in group:
                group[k] = 0

    @property
    def gap_samples(self) -> List[float]:
        """Every decode gap since the last :meth:`reset_stats` (the
        traffic harness's decode-gap percentiles)."""
        return list(self._gap_samples)

    def stats(self) -> dict:
        """Engine counters (with the decode gaps' p50 / p99, the step
        functions' geometry counts ``jit_compiles`` and the drafts'
        ``accept_rate``), the prefix store's hit/miss/put/eviction
        counters, the compiler's job/chunk counters, the tiers' counters,
        the fused step's settings and (paged) pool occupancy, under the
        JAX engine's keys: a deep copy of host values (no tensor), read
        from the registry, so that another thread may call it while the
        engine serves."""
        self._refresh_gauges()
        engine = dict(self._counters)
        gaps = self._gap_samples
        engine["decode_gap_p50_s"] = \
            float(np.percentile(gaps, 50)) if gaps else 0.0
        engine["decode_gap_p99_s"] = \
            float(np.percentile(gaps, 99)) if gaps else 0.0
        engine["jit_compiles"] = dict(self._jit_compiles)
        prop = engine["draft_proposed"]
        engine["accept_rate"] = (engine["draft_accepted"] / prop
                                 if prop else 0.0)
        out = {"engine": engine,
               "prefix_store": dict(self.store.stats),
               "compiler": (dict(self.compiler.stats)
                            if self.compiler is not None else None),
               # the live budgets sit outside _counters: the autotuner
               # moves them and reset_stats leaves them
               "budgets": {
                   "compile_token_budget": self.compile_token_budget,
                   "promote_layer_budget": self.promote_layer_budget,
                   "autotune": bool(self._autotune)}}
        if self.fused or self.spec_k:
            out["fused"] = {
                "enabled": self.fused,
                "chunk_tokens": self.fused_chunk_tokens,
                "spec_k": self.spec_k,
                "draft": (self._draft_cfg.name
                          if self._draft_cfg is not None else None),
            }
        if self.tiers is not None:
            out["prefix_tiers"] = self.tiers.tier_snapshot()
        if self.paged:
            out["pool"] = {
                "num_blocks": self.alloc.num_blocks,
                "block_size": self.block_size,
                "blocks_used": self.alloc.used_count,
                "blocks_free": self.alloc.free_count,
            }
        return copy.deepcopy(out)

    def _refresh_gauges(self) -> None:
        """Push point-in-time values (pool occupancy, live budgets) into
        registry gauges, so that a scrape between serves is fresh."""
        g = self.metrics.gauge
        g("serving_budget_compile_tokens",
          "live compile token budget (autotuned)").set(
              self.compile_token_budget)
        g("serving_budget_promote_layers",
          "live promote layer-chunk budget (autotuned)").set(
              self.promote_layer_budget)
        if self.paged:
            g("serving_pool_blocks_used",
              "paged KV pool blocks in use").set(self.alloc.used_count)
            g("serving_pool_blocks_free",
              "paged KV pool blocks free").set(self.alloc.free_count)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _width(self, n: int, cap: int) -> int:
        """The JAX engine's prefill width for ``n`` tokens with ``cap``
        positions left: exact for a recurrent config, else the bucket.
        Charges and paged reservations use it."""
        return n if self._recurrent else _bucket(n, cap)

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @staticmethod
    def _slot_view(cache: list, slot: int, persist: bool = True,
                   pooled: bool = False) -> list:
        """The cache a one-slot prefill runs on: per-slot leaves (dense K/V
        stripes, Mamba2 conv/ssm) cut to the slot's row — views, so the
        forward's in-place writes land in the slot — and, with ``pooled``,
        the K/V pools whole (the block table scopes those writes).
        ``persist=False`` clones the per-slot rows instead, so the slot
        keeps its state."""
        def leaf(key, x):
            if pooled and key in ("k", "v"):
                return x
            row = x[slot:slot + 1]
            return row if persist else row.clone()
        return [{key: leaf(key, x) for key, x in c.items()} for c in cache]

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
        self._counters["prefills"] += 1
        width = self._width(n, cap)  # the reference's prefill width
        self._note_geometry("prefill", (width, base))
        self._charge("prefill_token", width)
        padded = np.zeros((1, width if self._pad_prefill else n), np.int64)
        padded[0, :n] = tokens
        kw = dict(tokens=torch.as_tensor(padded, device=self.device),
                  cache=self._slot_view(self.cache, slot, persist,
                                        pooled=self.paged),
                  cache_index=base,
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

    def _prepare_prefill(self, slot: int, base: int, width: int) -> int:
        """Make the slot's table cover positions [0, base + width):
        copy-on-write a *shared* partial tail block (the prompt's first
        token lands inside it), then allocate fresh private blocks for
        the rest of the window.  Returns the blocks drawn from the pool
        (the copy and the fresh ones), which a prompt streamed in fused
        chunks draws down from the slot's reservation."""
        bs = self.block_size
        blocks = self._slot_blocks[slot]
        got = 0
        if base % bs and blocks:
            ti = base // bs  # the partially filled tail block's index
            if self.alloc.refcount(blocks[ti]) > 1:  # shared: store/slots
                self._cow_block(slot, ti)
                got += 1
        need = self.alloc.blocks_for(base + width) - len(blocks)
        if need > 0:
            fresh = self.alloc.alloc(need)
            self.tables[slot, len(blocks):len(blocks) + need] = fresh
            blocks.extend(fresh)
            got += need
        return got

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

    def _ensure_decode_blocks(self, active, lengths, widths=None) -> None:
        """Before a decode step, extend each active slot's table so that
        its ``widths[slot]`` incoming write positions from
        ``lengths[slot]`` on (one without ``widths``; the fused step's
        verify lanes pass more) are block-backed; allocations draw down
        the slot's admission-time reservation."""
        bs = self.block_size
        for slot in active:
            w = 1 if widths is None else max(1, int(widths[slot]))
            first = int(lengths[slot]) // bs
            last = (int(lengths[slot]) + w - 1) // bs
            blocks = self._slot_blocks[slot]
            while len(blocks) <= last:
                fresh = self.alloc.alloc(1)[0]
                self.tables[slot, len(blocks)] = fresh
                blocks.append(fresh)
                self._reserved[slot] = max(0, self._reserved[slot] - 1)
            for bi in range(first, last + 1):
                if self.alloc.refcount(blocks[bi]) > 1:
                    # a decode write into a still-shared block cannot
                    # happen after a >= 1-token prefill; COW beats a
                    # corrupted prefix
                    self._cow_block(slot, bi)

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
