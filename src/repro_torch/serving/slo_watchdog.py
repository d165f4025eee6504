"""SLO burn-rate watchdog over the serving engine's injected clock (the
port's own copy of ``repro/serving/slo_watchdog.py``).

Multi-window burn-rate alerting in the Google SRE mold: each
:class:`BurnRateRule` names a signal (TTFT, decode gap, goodput proxy),
a violation threshold and an error budget.  The **burn rate** over a
window is

    burn = (fraction of samples violating the SLO in the window) / budget

so burn 1.0 means "spending budget exactly as provisioned" and burn 10
means "the budget will be gone in a tenth of the window".  A rule fires
only when *both* a fast and a slow window exceed ``fire_burn`` (the fast
window gives low latency-to-detect, the slow window filters blips), and
clears with hysteresis when the fast window drops below ``clear_burn``.

Everything is timestamped by the injected clock.  On a
:class:`~repro_torch.serving.clock.VirtualClock` the full alert sequence —
order, timestamps, burn values — is a pure function of (scenario, seed):
two runs of one scenario produce byte-identical :meth:`SLOWatchdog.dumps`
output, which is what the tests lock.  The schema string is the
reference's, so the two packages' alert logs compare byte for byte.

Alerts are observable three ways at once: a tracer instant on the
``watchdog`` track, a ``serving_alerts_total{rule,severity}`` counter
(registered eagerly so the metric name is scrapeable before the first
alert), and an append-only :attr:`SLOWatchdog.alert_log` exported by
:meth:`SLOWatchdog.report` as a ``repro/alert-log/v1`` artifact.

While a ``page``-severity alert is active a pluggable degradation hook
runs; the default :class:`ShedDegrade` tells the engine to shed
lowest-priority admissions (``engine.shed_floor``) and hints the
compile/promote budget autotuner to tighten, undoing both on clear.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BurnRateRule", "SLOWatchdog", "ShedDegrade", "default_rules",
    "validate_alert_log", "ALERT_LOG_SCHEMA",
]

ALERT_LOG_SCHEMA = "repro/alert-log/v1"

#: Signals the engine feeds when a watchdog is attached.
SIGNALS = ("ttft", "decode_gap", "tokens_per_step")


@dataclass(frozen=True)
class BurnRateRule:
    """One SLO with two burn-rate windows.

    ``op`` gives the violation direction: ``"gt"`` for latency-style
    signals (a sample violates when it exceeds ``threshold``), ``"lt"``
    for throughput-style signals (violates when it falls below).
    """

    name: str
    metric: str
    threshold: float
    budget: float                # allowed violation fraction, in (0, 1]
    fast_window_s: float
    slow_window_s: float
    fire_burn: float = 1.0
    clear_burn: float = 0.5
    severity: str = "ticket"     # "ticket" | "page"
    op: str = "gt"               # "gt" | "lt"

    def __post_init__(self):
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"{self.name}: budget must be in (0, 1]")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                f"{self.name}: need 0 < fast_window_s <= slow_window_s")
        if self.severity not in ("ticket", "page"):
            raise ValueError(f"{self.name}: severity must be ticket|page")
        if self.op not in ("gt", "lt"):
            raise ValueError(f"{self.name}: op must be gt|lt")
        if self.clear_burn > self.fire_burn:
            raise ValueError(f"{self.name}: clear_burn > fire_burn "
                             "defeats the hysteresis")

    def violates(self, value: float) -> bool:
        return (value > self.threshold if self.op == "gt"
                else value < self.threshold)


def default_rules(*, slo_ttft_s: float = 0.05,
                  slo_gap_s: float = 0.005,
                  min_tokens_per_step: float = 0.5) -> List[BurnRateRule]:
    """The stock rule set the launcher wires under ``--traffic``: a
    paging TTFT burn, a ticket decode-gap burn, and a ticket goodput
    floor (tokens emitted per engine step across all slots)."""
    return [
        BurnRateRule(name="ttft_burn", metric="ttft",
                     threshold=slo_ttft_s, budget=0.10,
                     fast_window_s=0.05, slow_window_s=0.25,
                     fire_burn=2.0, clear_burn=1.0, severity="page"),
        BurnRateRule(name="decode_gap_burn", metric="decode_gap",
                     threshold=slo_gap_s, budget=0.20,
                     fast_window_s=0.02, slow_window_s=0.10,
                     fire_burn=2.0, clear_burn=1.0, severity="ticket"),
        BurnRateRule(name="goodput_floor", metric="tokens_per_step",
                     threshold=min_tokens_per_step, budget=0.25,
                     fast_window_s=0.02, slow_window_s=0.10,
                     fire_burn=2.0, clear_burn=1.0, severity="ticket",
                     op="lt"),
    ]


class SLOWatchdog:
    """Evaluates :class:`BurnRateRule`\\ s over observed samples.

    The watchdog never reads wall time: ``clock`` is the same injected
    callable the engine runs on, and callers may also pass explicit
    timestamps to :meth:`observe`/:meth:`step`.  It never *charges* the
    clock either — attaching a watchdog does not change the token
    stream, only admissions (via the degradation hook, which is the
    point).
    """

    def __init__(self, rules: Sequence[BurnRateRule], *,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, tracer=None, degrade_hook=None):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.rules = tuple(rules)
        self.clock = clock
        self.tracer = tracer
        self.degrade_hook = degrade_hook
        self.engine = None
        # metric -> deque-like list of (t, value), pruned on observe
        self._samples: Dict[str, List[Tuple[float, float]]] = {}
        self._keep: Dict[str, float] = {}
        for r in self.rules:
            self._keep[r.metric] = max(self._keep.get(r.metric, 0.0),
                                       r.slow_window_s)
        self._firing: Dict[str, bool] = {r.name: False for r in self.rules}
        self.alert_log: List[dict] = []
        self._alerts_total = None
        if metrics is not None:
            # eager registration: the name (HELP/TYPE) renders in
            # /metrics before any alert has fired
            self._alerts_total = metrics.counter(
                "serving_alerts_total",
                "SLO watchdog alerts fired, by rule and severity",
                labelnames=("rule", "severity"))

    # -- feeding -------------------------------------------------------

    def now(self) -> float:
        if self.clock is None:
            raise ValueError("watchdog has no clock: pass t= explicitly")
        return float(self.clock())

    def observe(self, metric: str, value: float,
                t: Optional[float] = None) -> None:
        if metric not in self._keep:
            return  # no rule watches this signal
        t = self.now() if t is None else float(t)
        buf = self._samples.setdefault(metric, [])
        buf.append((t, float(value)))
        # prune anything older than the widest slow window (plus slack
        # so a sample on the window edge is never dropped early)
        horizon = t - 2.0 * self._keep[metric]
        if buf and buf[0][0] < horizon:
            self._samples[metric] = [s for s in buf if s[0] >= horizon]

    def attach_engine(self, engine) -> None:
        """Bind the degradation hook's target (usually the engine that
        also feeds :meth:`observe`)."""
        self.engine = engine

    # -- evaluation ----------------------------------------------------

    def _burn(self, rule: BurnRateRule, window_s: float,
              now: float) -> Optional[float]:
        """Burn rate over ``[now - window_s, now]``; None with no
        samples (a silent window is not evidence either way)."""
        buf = self._samples.get(rule.metric, ())
        lo = now - window_s
        n = bad = 0
        for t, v in buf:
            if t < lo or t > now:
                continue
            n += 1
            if rule.violates(v):
                bad += 1
        if n == 0:
            return None
        return (bad / n) / rule.budget

    def step(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every rule at ``now``; returns the events (fire or
        clear) emitted by this step, already appended to
        :attr:`alert_log`."""
        now = self.now() if now is None else float(now)
        emitted: List[dict] = []
        for rule in self.rules:
            fast = self._burn(rule, rule.fast_window_s, now)
            slow = self._burn(rule, rule.slow_window_s, now)
            if not self._firing[rule.name]:
                if (fast is not None and slow is not None
                        and fast >= rule.fire_burn
                        and slow >= rule.fire_burn):
                    emitted.append(self._emit(rule, "fire", now, fast, slow))
            else:
                if fast is None or fast <= rule.clear_burn:
                    emitted.append(self._emit(rule, "clear", now,
                                              fast, slow))
        return emitted

    def _emit(self, rule: BurnRateRule, kind: str, now: float,
              fast: Optional[float], slow: Optional[float]) -> dict:
        self._firing[rule.name] = kind == "fire"
        event = {
            "t": now, "kind": kind, "rule": rule.name,
            "severity": rule.severity, "metric": rule.metric,
            "burn_fast": fast, "burn_slow": slow,
        }
        self.alert_log.append(event)
        if kind == "fire" and self._alerts_total is not None:
            self._alerts_total.inc(rule=rule.name, severity=rule.severity)
        if self.tracer is not None:
            self.tracer.instant(
                "watchdog", f"alert_{kind}:{rule.name}", t=now,
                severity=rule.severity,
                burn_fast=fast, burn_slow=slow)
        hook = self.degrade_hook
        if hook is not None:
            if kind == "fire":
                hook.on_fire(self, rule, event)
            else:
                hook.on_clear(self, rule, event)
        return event

    # -- state ---------------------------------------------------------

    def firing(self, name: str) -> bool:
        return self._firing[name]

    @property
    def page_active(self) -> bool:
        """True while any page-severity rule is firing."""
        return any(self._firing[r.name] for r in self.rules
                   if r.severity == "page")

    # -- export --------------------------------------------------------

    def report(self) -> dict:
        """The alert log as a schema'd JSON-ready artifact."""
        return {
            "schema": ALERT_LOG_SCHEMA,
            "rules": [{f.name: getattr(r, f.name) for f in fields(r)}
                      for r in self.rules],
            "events": list(self.alert_log),
            "fires": sum(1 for e in self.alert_log if e["kind"] == "fire"),
            "clears": sum(1 for e in self.alert_log
                          if e["kind"] == "clear"),
        }

    def dumps(self) -> str:
        """Deterministic serialization — byte-identical across runs of
        one (scenario, seed) on the virtual clock."""
        return json.dumps(self.report(), sort_keys=True,
                          separators=(",", ":"))


class ShedDegrade:
    """Default degradation hook: while a page alert is active, shed
    admissions below a priority floor and hint the budget autotuner.

    ``shed_floor`` semantics (enforced by the engine's admission gate):
    requests with ``priority >= floor`` wait in queue rather than admit,
    and only while at least one slot is still running — an idle engine
    always admits, so shedding can never deadlock the simulation.
    """

    def __init__(self, shed_priority: int = 1, tighten: bool = True):
        self.shed_priority = int(shed_priority)
        self.tighten = tighten

    def on_fire(self, wd: SLOWatchdog, rule: BurnRateRule,
                event: dict) -> None:
        eng = wd.engine
        if eng is None or rule.severity != "page":
            return
        eng.shed_floor = self.shed_priority
        if self.tighten:
            eng.degrade_hint = True
        if getattr(eng, "metrics", None) is not None:
            eng.metrics.counter(
                "serving_degradations_total",
                "degradation-hook actions taken on page alerts",
                labelnames=("action",)).inc(action="shed")

    def on_clear(self, wd: SLOWatchdog, rule: BurnRateRule,
                 event: dict) -> None:
        eng = wd.engine
        if eng is None or rule.severity != "page":
            return
        if not wd.page_active:
            eng.shed_floor = None
            eng.degrade_hint = False
            if getattr(eng, "metrics", None) is not None:
                eng.metrics.counter(
                    "serving_degradations_total",
                    "degradation-hook actions taken on page alerts",
                    labelnames=("action",)).inc(action="restore")


def validate_alert_log(doc: dict) -> List[str]:
    """Schema-check a ``repro/alert-log/v1`` artifact; returns problems
    (empty = valid)."""
    errs: List[str] = []
    if doc.get("schema") != ALERT_LOG_SCHEMA:
        errs.append(f"schema != {ALERT_LOG_SCHEMA!r}: "
                    f"{doc.get('schema')!r}")
    events = doc.get("events")
    if not isinstance(events, list):
        return errs + ["events missing or not a list"]
    rule_names = {r.get("name") for r in doc.get("rules", [])
                  if isinstance(r, dict)}
    last_t = None
    open_alerts = set()
    for i, ev in enumerate(events):
        for field in ("t", "kind", "rule", "severity", "metric"):
            if field not in ev:
                errs.append(f"event {i}: missing {field!r}")
        kind = ev.get("kind")
        if kind not in ("fire", "clear"):
            errs.append(f"event {i}: bad kind {kind!r}")
        if ev.get("severity") not in ("ticket", "page"):
            errs.append(f"event {i}: bad severity {ev.get('severity')!r}")
        if rule_names and ev.get("rule") not in rule_names:
            errs.append(f"event {i}: unknown rule {ev.get('rule')!r}")
        t = ev.get("t")
        if isinstance(t, (int, float)):
            if last_t is not None and t < last_t:
                errs.append(f"event {i}: timestamps not monotonic")
            last_t = t
        rule = ev.get("rule")
        if kind == "fire":
            if rule in open_alerts:
                errs.append(f"event {i}: double fire for {rule!r}")
            open_alerts.add(rule)
        elif kind == "clear":
            if rule not in open_alerts:
                errs.append(f"event {i}: clear without fire for {rule!r}")
            open_alerts.discard(rule)
    if doc.get("fires") is not None:
        n = sum(1 for e in events if e.get("kind") == "fire")
        if doc["fires"] != n:
            errs.append(f"fires count {doc['fires']} != {n}")
    return errs
