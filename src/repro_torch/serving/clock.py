"""Injectable clocks for the serving stack (the port's own copy of
``repro/serving/clock.py``).

The engine and scheduler never call :func:`time.perf_counter` directly;
they call ``self.clock()``.  In production that *is* ``perf_counter``,
but tests and the traffic simulation inject a :class:`VirtualClock` so
every timestamp — arrival, TTFT, decode gap, aging — is a deterministic
function of the work performed, not of the host machine.

A bare fake clock (one that only ever returns what you set) would make
latency metrics degenerate: every decode step would take zero seconds
and the budget autotuner would have nothing to react to.  The virtual
clock therefore carries a *cost model*: the engine calls
``clock.charge(kind, units)`` at each work site (one decode step, one
prefilled token, one compiled token, one promoted chunk) and the clock
advances by ``costs[kind] * units``.  Simulated time then moves the way
wall time would — compile-heavy stretches stretch the decode gap, idle
waits jump with :meth:`VirtualClock.advance_to` — while staying
bit-reproducible across runs and machines.

On a real (wall) clock both hooks are absent; the engine detects that
with ``getattr`` and charging becomes a no-op while waits become short
sleeps.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["VirtualClock", "DEFAULT_COSTS"]

# Rough relative costs (seconds per unit of work).  Absolute values are
# arbitrary — only the ratios matter for scheduling decisions — but they
# are chosen so a decode step dominates a prefilled token and a budgeted
# compile/promote slice lands in the same order of magnitude as a step,
# mirroring the interleaving the real engine exhibits.
DEFAULT_COSTS: Dict[str, float] = {
    "decode_step": 1e-3,     # one batched decode step
    "prefill_token": 2e-5,   # one token of (padded) prefill width
    "compile_token": 2e-4,   # one source token consumed by the compiler
    "promote_chunk": 1e-4,   # one layer-chunk copied up a tier
    "draft_step": 2e-4,      # one drafter step (speculative decoding) —
                             # the drafter is the small sibling config, so
                             # a step costs a fraction of the target's
}


class VirtualClock:
    """Deterministic simulated clock with a work cost model.

    Calling the instance returns the current simulated time in seconds,
    so it is a drop-in for ``time.perf_counter`` wherever a zero-arg
    callable is expected.
    """

    def __init__(self, costs: Optional[Dict[str, float]] = None,
                 start: float = 0.0):
        self._t = float(start)
        self.costs = dict(DEFAULT_COSTS)
        if costs:
            self.costs.update(costs)
        self._charged_seconds = None  # labeled counter, see attach_metrics
        self._charged_units = None
        self._attached: list = []

    def attach_metrics(self, registry) -> None:
        """Register charged-work counters into a MetricsRegistry (duck-
        typed: anything with ``counter(name, help, labelnames)``): how
        much simulated time and how many work units each ``kind`` has
        consumed.  Idempotent per registry — the engine calls this from
        its constructor, and one clock may drive several engines sharing
        a registry."""
        if any(r is registry for r in self._attached):
            return
        self._attached.append(registry)
        self._charged_seconds = registry.counter(
            "virtual_clock_charged_seconds_total",
            "simulated seconds charged, by work kind",
            labelnames=("kind",))
        self._charged_units = registry.counter(
            "virtual_clock_charged_units_total",
            "work units charged, by work kind", labelnames=("kind",))

    def __call__(self) -> float:
        return self._t

    @property
    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("clock cannot run backwards")
        self._t += float(dt)

    def advance_to(self, t: float) -> None:
        """Jump forward to ``t`` (idle wait); never moves backwards."""
        self._t = max(self._t, float(t))

    def charge(self, kind: str, units: float = 1.0) -> None:
        """Advance by the modeled cost of ``units`` of work of ``kind``."""
        dt = self.costs.get(kind, 0.0) * float(units)
        self._t += dt
        if self._charged_seconds is not None:
            self._charged_seconds.inc(dt, kind=kind)
            self._charged_units.inc(float(units), kind=kind)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"VirtualClock(t={self._t:.6f})"
