"""Request queue and slot bookkeeping for the continuous-batching engine
(the port's own copy of ``repro/serving/scheduler.py``).

Pure-python control plane, free of torch and jax: the
:class:`~repro_torch.serving.engine.ServingEngine` owns the device tensors and
asks the scheduler three questions each step — which queued requests fit
into free slots (:meth:`Scheduler.admit`), which slots are mid-generation
(:meth:`Scheduler.active_slots`), and whether a freshly sampled token
finishes its slot (:meth:`Scheduler.record_token`: per-slot stop token or
per-slot token budget, *independently* of every other slot).

Finished slots return to the free pool immediately, so the next queued
request is admitted mid-decode — no drain barrier, no recompilation (the
decode step's shapes never change; only the per-slot length vector does).

Requests whose compressed prefix is not HBM-resident sit in a fourth
stage, **waiting_on_prefix** (:meth:`Scheduler.park`), until the engine
makes it resident and :meth:`Scheduler.wake`\\ s them into the head of
the FIFO queue.  Two producers feed the stage — the online prefix
compiler (requests carrying ``raw_shots`` for an uncompiled task) and
the tiered store's promotion path (a previously evicted prefix
copying back from the host or disk tier) — and the scheduler cannot
tell them apart: parking is keyed by prefix name alone.

    waiting_on_prefix ──wake──▶ queued ──admit──▶ running ──▶ finished
                                   ▲                  │
                                   └────preempt───────┘

Priority classes
----------------
``Request.priority`` is an integer class, **lower = more urgent**
(class 0 outranks class 1).  Admission picks the queued request with the
smallest ``(effective_class, arrival)`` key, so order stays strictly
FIFO *within* a class — with a single class this degrades to the plain
FIFO the engine shipped with.  An optional anti-starvation rule ages
parked work: with ``aging_interval_s`` set, a request's effective class
drops by one for every interval it has waited, bounding how long a
low-priority request can be starved by a stream of urgent arrivals.
Aging affects *admission order only* — preemption (below) compares base
classes, so an aged request never evicts a genuinely higher class.

Preemption
----------
:meth:`Scheduler.preempt` evicts a running slot: the request returns to
the queue at its original arrival position (same rule as :meth:`wake`)
and its already-emitted tokens are stashed.  When the request is later
re-admitted, the stash resumes the slot — :meth:`emitted_tokens` lets
the engine re-prefill ``prompt + emitted`` so decode continues from the
exact KV state it was evicted with, and :meth:`record_token` keeps
counting against the original ``max_new`` budget.  The engine drives the
policy (who gets preempted, and the KV/block cleanup); the scheduler
only guarantees the bookkeeping is token-exact.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.sanitize import SanitizerError, sanitizer_enabled

_UIDS = itertools.count()

# ---------------------------------------------------------------------------
# Stage machine (machine-readable)
# ---------------------------------------------------------------------------
#
# The request lifecycle as data: reprolint's `state-machine` rule checks
# every `self._transition(uid, src, dst)` call site against this table,
# and under REPRO_SANITIZE=1 the scheduler validates each move as it
# happens — the static and the runtime checker read the same literals.
# "new" is the pre-scheduler stage (a Request object not yet submitted).
# Both literals must stay pure (no computed values): the linter
# evaluates them with ast.literal_eval.

STAGES = ("new", "queued", "waiting_on_prefix", "running", "finished")

LEGAL_TRANSITIONS = {
    ("new", "queued"),                # submit(): prefix resident (or none)
    ("new", "waiting_on_prefix"),     # park(): prefix compiling/promoting
    ("waiting_on_prefix", "queued"),  # wake(): prefix became resident
    ("queued", "running"),            # admit(): seated into a free slot
    ("running", "queued"),            # preempt(): evicted, tokens stashed
    ("running", "finished"),          # finish(): stop token or budget
}


@dataclass
class Request:
    """One generation request.

    ``prefix``: optional :class:`~repro_torch.serving.prefix_store.PrefixStore`
    entry name — the compressed many-shot task memory this request attends
    to.  Requests with different prefixes batch together; each is seated
    per slot.

    ``raw_shots``: optional (T,) raw many-shot context tokens.  When the
    named prefix is not resident, the engine compiles these online
    (chunked, interleaved with decode) instead of failing — the public
    API for a cold task is *just submit the request*.  With no explicit
    ``prefix`` the name is content-addressed from the shot bytes, so
    byte-identical shot sets from different requests dedup onto one
    compilation and one stored prefix.

    ``priority``: integer class, lower = more urgent; 0 is the default
    and highest class.  ``arrival_s``: optional arrival time in seconds
    *relative to the start of* :meth:`~repro_torch.serving.engine.ServingEngine
    .serve` — the engine holds the request until its clock reaches it,
    which is how the traffic harness replays a Poisson trace.
    """

    tokens: np.ndarray                 # (S,) int32 prompt
    max_new: int
    prefix: Optional[str] = None       # PrefixStore entry name
    stop_token: Optional[int] = None
    temperature: float = 0.0
    raw_shots: Optional[np.ndarray] = None  # (T,) int32 many-shot context
    priority: int = 0                  # class; lower admits/decodes first
    arrival_s: Optional[float] = None  # offset from serve() start
    uid: int = field(default_factory=lambda: next(_UIDS))

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError("prompt must contain at least one token")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.priority < 0:
            raise ValueError("priority classes are non-negative integers")
        if self.arrival_s is not None and self.arrival_s < 0:
            raise ValueError("arrival_s must be >= 0")
        if self.raw_shots is not None:
            self.raw_shots = np.asarray(self.raw_shots, np.int32).reshape(-1)
            if self.raw_shots.size == 0:
                raise ValueError("raw_shots must contain at least one token")
            if self.prefix is None:
                digest = hashlib.sha1(self.raw_shots.tobytes()).hexdigest()
                self.prefix = f"shots-{digest[:12]}"


@dataclass
class _SlotState:
    request: Request
    emitted: List[int] = field(default_factory=list)


class Scheduler:
    """Admits ragged requests into a fixed pool of batch slots."""

    def __init__(self, num_slots: int, *,
                 clock: Optional[Callable[[], float]] = None,
                 aging_interval_s: Optional[float] = None,
                 metrics=None):
        self.num_slots = num_slots
        self.clock = clock if clock is not None else time.perf_counter
        if aging_interval_s is not None and aging_interval_s <= 0:
            raise ValueError("aging_interval_s must be positive")
        self.aging_interval_s = aging_interval_s
        self._queue: deque[Request] = deque()
        self._slots: List[Optional[_SlotState]] = [None] * num_slots
        # waiting_on_prefix stage: prefix name -> requests parked until the
        # online compiler makes that prefix resident
        self._waiting: "OrderedDict[str, List[Request]]" = OrderedDict()
        # arrival order (submit() and park() alike): woken requests re-enter
        # the queue at their original position, never overtaking a request
        # that arrived before them — whichever compile finished first
        self._arrival = itertools.count()
        self._order: dict = {}
        self._arrive_t: dict = {}   # uid -> clock time first seen (for aging)
        self._resume: dict = {}     # uid -> tokens emitted before preemption
        self.preemptions = 0
        # REPRO_SANITIZE=1: validate every stage move against
        # LEGAL_TRANSITIONS as it happens (sampled once at construction)
        self._sanitize = sanitizer_enabled()
        self._stage: dict = {}      # uid -> current stage (sanitizer only)
        # optional telemetry: a MetricsRegistry (duck-typed — anything
        # with gauge()/counter()) receives queue-depth gauges and
        # lifecycle counters; None keeps the scheduler dependency-free
        self._m = None
        if metrics is not None:
            self._m = {
                "queued": metrics.gauge(
                    "serving_sched_queued", "requests in the FIFO queue"),
                "waiting": metrics.gauge(
                    "serving_sched_waiting_on_prefix",
                    "requests parked until their prefix is resident"),
                "running": metrics.gauge(
                    "serving_sched_running", "slots mid-generation"),
                "submitted": metrics.counter(
                    "serving_sched_submitted_total",
                    "requests entering the scheduler"),
                "preempted": metrics.counter(
                    "serving_sched_preemptions_total",
                    "running slots evicted for a higher class"),
            }

    # ---- stage machine ----

    def _transition(self, uid: int, src: str, dst: str) -> None:
        """Record one stage move.  The (src, dst) literals at every call
        site are what reprolint's `state-machine` rule checks against
        LEGAL_TRANSITIONS; under REPRO_SANITIZE=1 this also validates the
        move at runtime (edge legality + the request really being in
        ``src``).  A no-op on the hot path when the sanitizer is off."""
        if not self._sanitize:
            return
        if (src, dst) not in LEGAL_TRANSITIONS:
            raise SanitizerError(
                f"request {uid}: illegal stage transition {src!r} -> "
                f"{dst!r} (legal: {sorted(LEGAL_TRANSITIONS)})")
        cur = self._stage.get(uid, "new")
        if cur != src:
            raise SanitizerError(
                f"request {uid}: transition {src!r} -> {dst!r} but the "
                f"request is in stage {cur!r}")
        self._stage[uid] = dst

    # ---- queue side ----

    def _update_gauges(self) -> None:
        if self._m is None:
            return
        self._m["queued"].set(len(self._queue))
        self._m["waiting"].set(self.num_waiting)
        self._m["running"].set(
            sum(1 for s in self._slots if s is not None))

    def _stamp(self, request: Request) -> None:
        if request.uid not in self._order:
            self._order[request.uid] = next(self._arrival)
            self._arrive_t[request.uid] = self.clock()
            if self._m is not None:
                self._m["submitted"].inc()

    def submit(self, request: Request) -> int:
        self._stamp(request)
        self._transition(request.uid, "new", "queued")
        self._queue.append(request)
        self._update_gauges()
        return request.uid

    @property
    def pending(self) -> int:
        return len(self._queue)

    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._waiting)
                or any(s is not None for s in self._slots))

    # ---- priority / aging ----

    def effective_class(self, request: Request,
                        now: Optional[float] = None) -> int:
        """The priority class after anti-starvation aging: every
        ``aging_interval_s`` a request has waited shaves one class off,
        floored at 0.  With aging disabled this is just the base class."""
        if self.aging_interval_s is None or request.priority == 0:
            return request.priority
        now = self.clock() if now is None else now
        waited = max(0.0, now - self._arrive_t.get(request.uid, now))
        interval = self.aging_interval_s
        # floor division rounds 0.03 // 0.01 down to 2.0: count the whole
        # intervals waited exactly, so waiting priority * interval always
        # reaches class 0 (``repro``'s copy stops one class short there)
        n = int(waited // interval)
        while (n + 1) * interval <= waited:
            n += 1
        return max(0, request.priority - n)

    def _best_index(self) -> int:
        """Index into the arrival-ordered queue of the request with the
        smallest (effective_class, arrival) key.  The queue itself stays
        arrival-ordered, so ties break FIFO for free."""
        now = self.clock()
        best, best_key = 0, None
        for i, req in enumerate(self._queue):
            key = (self.effective_class(req, now), self._order[req.uid])
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def best_queued(self) -> Optional[Request]:
        """The request admit() would pick next, or None — the engine's
        preemption policy compares this against the running slots."""
        return self._queue[self._best_index()] if self._queue else None

    # ---- waiting_on_prefix stage ----

    def park(self, request: Request) -> int:
        """Hold a request until its (compiling) prefix becomes resident."""
        assert request.prefix is not None, "parking needs a prefix name"
        self._stamp(request)
        self._transition(request.uid, "new", "waiting_on_prefix")
        self._waiting.setdefault(request.prefix, []).append(request)
        self._update_gauges()
        return request.uid

    @property
    def num_waiting(self) -> int:
        return sum(len(v) for v in self._waiting.values())

    def waiting_names(self) -> Tuple[str, ...]:
        return tuple(self._waiting)

    def waiting_on(self, name: str) -> List[Request]:
        return list(self._waiting.get(name, ()))

    def _insert_by_arrival(self, req: Request) -> None:
        """Re-enter the queue at the original arrival position: ahead of
        everything that arrived later, behind everything earlier."""
        seq = self._order[req.uid]
        idx = 0
        for queued in self._queue:
            if self._order[queued.uid] > seq:
                break
            idx += 1
        self._queue.insert(idx, req)

    def wake(self, name: str) -> List[Request]:
        """Move every request parked on ``name`` back into the FIFO queue
        at its *original arrival position*: a woken request precedes
        everything that arrived after it, but never overtakes a request
        that arrived earlier (e.g. one woken by a previous install and
        still queued).  Returns the woken requests."""
        woken = self._waiting.pop(name, [])
        for req in woken:
            self._transition(req.uid, "waiting_on_prefix", "queued")
            self._insert_by_arrival(req)
        if woken:
            self._update_gauges()
        return woken

    def referenced_prefixes(self) -> set:
        """Prefix names some not-yet-finished request still depends on —
        the engine pins these against LRU eviction (a running slot's
        prefix is also block-refcount-protected; queued/waiting ones are
        only protected by this set)."""
        names = {r.prefix for r in self._queue if r.prefix is not None}
        names.update(self._waiting)
        for s in self._slots:
            if s is not None and s.request.prefix is not None:
                names.add(s.request.prefix)
        return names

    # ---- slot side ----

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def request_in(self, slot: int) -> Request:
        state = self._slots[slot]
        assert state is not None, f"slot {slot} is free"
        return state.request

    def admit(self, can_seat=None) -> List[Tuple[int, Request]]:
        """Seat queued requests into free slots. Returns the
        (slot, request) pairs admitted this call.

        Each free slot takes the queued request with the smallest
        ``(effective_class, arrival)`` key — plain FIFO when every
        request shares one class.  ``can_seat(request) -> bool`` gates
        admission on engine capacity (the paged engine passes its
        free-block check).  The first best-ranked request that does not
        fit stops the scan — later, smaller requests are *not* admitted
        around it, preserving the no-overtake guarantee within a class."""
        seated = []
        for slot in self.free_slots():
            if not self._queue:
                break
            idx = self._best_index()
            req = self._queue[idx]
            if can_seat is not None and not can_seat(req):
                break
            del self._queue[idx]
            self._transition(req.uid, "queued", "running")
            resumed = self._resume.pop(req.uid, None)
            self._slots[slot] = _SlotState(req, emitted=list(resumed or ()))
            seated.append((slot, req))
        if seated:
            self._update_gauges()
        return seated

    def emitted_tokens(self, slot: int) -> np.ndarray:
        """Tokens the seated request has already emitted — non-empty only
        for a preempted-and-resumed request, where the engine must
        re-prefill ``prompt + emitted`` to rebuild the evicted KV state."""
        state = self._slots[slot]
        assert state is not None, f"slot {slot} is free"
        return np.asarray(state.emitted, np.int32)

    def resume_len(self, uid: int) -> int:
        """How many stashed tokens a queued request will resume with (0
        for fresh requests) — the engine's block-capacity gate adds this
        to the prompt length before admission."""
        return len(self._resume.get(uid, ()))

    def preempt(self, slot: int) -> Request:
        """Evict a running slot back into the queue (token-exact): the
        emitted tokens are stashed for resumption and the request
        re-enters at its original arrival position.  The caller (engine)
        owns releasing the slot's KV/blocks."""
        state = self._slots[slot]
        assert state is not None, f"slot {slot} is free"
        self._slots[slot] = None
        req = state.request
        self._transition(req.uid, "running", "queued")
        self._resume[req.uid] = list(state.emitted)
        self._insert_by_arrival(req)
        self.preemptions += 1
        if self._m is not None:
            self._m["preempted"].inc()
            self._update_gauges()
        return req

    def record_token(self, slot: int, token: int) -> bool:
        """Append a sampled token to a slot's output. Returns True when the
        slot just finished — its own stop token or its own budget; other
        slots are unaffected."""
        state = self._slots[slot]
        assert state is not None, f"slot {slot} is free"
        state.emitted.append(int(token))
        req = state.request
        if req.stop_token is not None and int(token) == req.stop_token:
            return True
        return len(state.emitted) >= req.max_new

    def finish(self, slot: int) -> Tuple[Request, np.ndarray]:
        """Release a slot, returning (request, generated tokens)."""
        state = self._slots[slot]
        assert state is not None, f"slot {slot} is free"
        self._transition(state.request.uid, "running", "finished")
        self._slots[slot] = None
        self._update_gauges()
        return state.request, np.asarray(state.emitted, np.int32)
