"""Flight-recorder tracing and the metrics registry of the serving stack
(the port's own copy of ``repro/serving/telemetry.py``).

Two observability primitives, both stamped by the engine's *injected*
clock (:class:`~repro_torch.serving.clock.VirtualClock` in simulation,
the host's ``perf_counter`` in production), so that telemetry on the
virtual clock is a deterministic function of (scenario, seed):

* :class:`Tracer` — spans and instants for the request lifecycle
  (arrive, park and wake on a prefix, compile and promote chunks,
  admission, preempt and resume, decode and fused steps, speculative
  acceptance, finish), kept in a bounded ring buffer (the **flight
  recorder**: the last N events survive a crash and can be dumped on
  error or on demand) and exported as Chrome-trace / Perfetto JSON, one
  track per slot plus engine, compiler, promoter and scheduler tracks.

* :class:`MetricsRegistry` — named counters, gauges and histograms with
  label sets.  The engine, scheduler, compiler, tiered store, clock and
  SLO watchdog register into one registry; ``ServingEngine.stats()`` is
  a view over it (its schema kept by :class:`MetricGroup`), and
  :meth:`MetricsRegistry.render_prometheus` emits the text exposition
  format the telemetry server serves.  The metric names, labels and text
  are the reference's, byte for byte.

Every value either holds is a host value (Python numbers, strings,
lists, dicts): recording never reads a device tensor, so it adds no
device synchronization, and a span closes where the engine's own step
readback already ended the step.  Disabled telemetry is the
:data:`NULL_TRACER` no-op singleton: the token stream is identical with
tracing on or off, because telemetry only reads the clock and never
charges it.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import OrderedDict, deque
from typing import (Callable, Dict, Iterable, List, Mapping, MutableMapping,
                    Optional, Sequence, Tuple)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry", "MetricGroup", "Counter", "Gauge", "Histogram",
    "DEFAULT_TIME_BUCKETS", "validate_chrome_trace", "REQUIRED_SPANS",
]


# ----------------------------------------------------------------------
# Tracer (flight recorder + Chrome-trace export)
# ----------------------------------------------------------------------

# Fixed Chrome-trace thread ids for the shared tracks; per-slot tracks
# ("slot0", "slot1", …) sit at _SLOT_TID_BASE + index so traces from
# engines of any slot count lay out identically.
_TRACK_TIDS = {"engine": 1, "compiler": 2, "promoter": 3, "scheduler": 4}
_SLOT_TID_BASE = 16
_PID = 1

#: Span names the serving loop guarantees for a traffic replay that
#: exercises online compile, tier promotion and priority preemption —
#: the CI schema-validation step asserts these (spec_accept additionally
#: when speculative decoding is on).
REQUIRED_SPANS = ("admission", "waiting_on_prefix", "compile_chunk",
                  "promote_chunk", "preempt", "resume", "decode_step")


def _track_tid(track: str) -> int:
    tid = _TRACK_TIDS.get(track)
    if tid is not None:
        return tid
    if track.startswith("slot"):
        try:
            return _SLOT_TID_BASE + int(track[4:])
        except ValueError:
            pass
    # unknown tracks get a stable tid from their name ordering at export
    return -1


class Tracer:
    """Structured event recorder over an injected clock.

    Events live in a ``deque(maxlen=capacity)`` — the flight recorder:
    with a finite capacity only the most recent events survive, which is
    exactly what a post-mortem wants.  ``capacity=None`` keeps
    everything (bench/trace-export mode).

    The tracer never advances or charges the clock; it only reads it.
    On a :class:`~repro_torch.serving.clock.VirtualClock` every timestamp is
    therefore a pure function of the work the engine performed, and two
    runs of the same (scenario, seed) dump byte-identical JSON.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None, *,
                 capacity: Optional[int] = None,
                 dump_path: Optional[str] = None):
        if capacity is not None and capacity < 1:
            raise ValueError("flight-recorder capacity must be >= 1")
        self.clock = clock
        self.capacity = capacity
        self.dump_path = dump_path
        self._events: "deque[dict]" = deque(maxlen=capacity)
        self.dropped = 0  # events pushed out of the ring buffer

    # -- recording -----------------------------------------------------

    def now(self) -> float:
        clock = self.clock if self.clock is not None else time.perf_counter
        return float(clock())

    def _push(self, ev: dict) -> None:
        if self.capacity is not None and len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def span(self, track: str, name: str, t0: float,
             t1: Optional[float] = None, **args) -> None:
        """A complete ("X") span on ``track`` from ``t0`` to ``t1``
        (default: now).  ``args`` land in the event's args dict."""
        if t1 is None:
            t1 = self.now()
        self._push({"ph": "X", "track": track, "name": name,
                    "t": float(t0), "dur": max(0.0, float(t1) - float(t0)),
                    "args": args})

    def instant(self, track: str, name: str,
                t: Optional[float] = None, **args) -> None:
        self._push({"ph": "i", "track": track, "name": name,
                    "t": self.now() if t is None else float(t),
                    "args": args})

    def begin_async(self, track: str, name: str, aid,
                    t: Optional[float] = None, **args) -> None:
        """Open an async ("b") span — e.g. ``waiting_on_prefix`` between a
        request's park and its wake, keyed by ``aid``."""
        self._push({"ph": "b", "track": track, "name": name, "id": str(aid),
                    "t": self.now() if t is None else float(t),
                    "args": args})

    def end_async(self, track: str, name: str, aid,
                  t: Optional[float] = None, **args) -> None:
        self._push({"ph": "e", "track": track, "name": name, "id": str(aid),
                    "t": self.now() if t is None else float(t),
                    "args": args})

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def events(self) -> List[dict]:
        """The recorded events, oldest first (internal schema)."""
        return list(self._events)

    # -- export --------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Render the ring buffer as a Chrome-trace / Perfetto JSON
        object: ``{"traceEvents": [...]}`` with one named thread per
        track.  Timestamps convert from clock seconds to microseconds.
        Event order (metadata first, then record order) and key order
        are deterministic."""
        tracks: List[str] = []
        for ev in self._events:
            if ev["track"] not in tracks:
                tracks.append(ev["track"])
        tids: Dict[str, int] = {}
        unknown = sorted(t for t in tracks if _track_tid(t) < 0)
        for t in tracks:
            tid = _track_tid(t)
            tids[t] = tid if tid >= 0 else 1024 + unknown.index(t)
        out: List[dict] = [{
            "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
            "args": {"name": "serving_engine"},
        }]
        for track in sorted(tracks, key=lambda t: tids[t]):
            out.append({"ph": "M", "pid": _PID, "tid": tids[track],
                        "name": "thread_name", "args": {"name": track}})
            out.append({"ph": "M", "pid": _PID, "tid": tids[track],
                        "name": "thread_sort_index",
                        "args": {"sort_index": tids[track]}})
        for ev in self._events:
            ce = {"ph": ev["ph"], "pid": _PID, "tid": tids[ev["track"]],
                  "name": ev["name"], "cat": "serving",
                  "ts": round(ev["t"] * 1e6, 3)}
            if ev["ph"] == "X":
                ce["dur"] = round(ev["dur"] * 1e6, 3)
            if ev["ph"] == "i":
                ce["s"] = "t"
            if "id" in ev:
                ce["id"] = ev["id"]
            if ev.get("args"):
                ce["args"] = ev["args"]
            out.append(ce)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dumps(self) -> str:
        """Serialize deterministically: two runs of the same virtual-
        clock scenario produce byte-identical output."""
        return json.dumps(self.chrome_trace(), sort_keys=True,
                          separators=(",", ":"))

    def dump(self, path: Optional[str] = None) -> str:
        path = path if path is not None else self.dump_path
        if path is None:
            raise ValueError("no dump path: pass one or set dump_path")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dumps())
        return path

    def dump_on_error(self) -> Optional[str]:
        """Best-effort flight-recorder dump from an exception path: write
        to ``dump_path`` if configured, swallow secondary failures."""
        if self.dump_path is None:
            return None
        try:
            return self.dump(self.dump_path)
        except OSError:
            return None


class NullTracer:
    """No-op tracer: the default.  Every method is a pass so disabled
    telemetry costs one attribute lookup per site and the serving loop
    is bit-exact with tracing off."""

    enabled = False
    clock = None
    capacity = None
    dump_path = None
    dropped = 0

    def now(self) -> float:
        return 0.0

    def span(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def begin_async(self, *a, **k) -> None:
        pass

    def end_async(self, *a, **k) -> None:
        pass

    def clear(self) -> None:
        pass

    def events(self) -> List[dict]:
        return []

    def chrome_trace(self) -> dict:
        return {"traceEvents": []}

    def dump_on_error(self) -> None:
        return None


#: Shared no-op tracer — the engine default.
NULL_TRACER = NullTracer()


def validate_chrome_trace(trace: dict,
                          require_spans: Sequence[str] = ()) -> List[str]:
    """Schema-check a Chrome-trace dict; returns a list of problems
    (empty = valid).  Used by tests and the CI validation step."""
    errs: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    names = set()
    for i, ev in enumerate(events):
        for field in ("ph", "pid", "tid", "name"):
            if field not in ev:
                errs.append(f"event {i}: missing {field!r}")
        ph = ev.get("ph")
        if ph != "M" and "ts" not in ev:
            errs.append(f"event {i}: missing 'ts'")
        if ph == "X" and "dur" not in ev:
            errs.append(f"event {i}: complete span missing 'dur'")
        if ph in ("b", "e") and "id" not in ev:
            errs.append(f"event {i}: async event missing 'id'")
        if ph != "M":
            names.add(ev.get("name"))
    for want in require_spans:
        if want not in names:
            errs.append(f"required span {want!r} absent from trace")
    return errs


# ----------------------------------------------------------------------
# Metrics registry
# ----------------------------------------------------------------------

#: 1-2-5 log ladder in seconds — decode gaps, TTFT and latency all fit.
DEFAULT_TIME_BUCKETS = (
    1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3,
    1e-2, 2e-2, 5e-2, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
)


def _fmt_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # insertion-ordered so exposition order is first-use order
        self._values: "OrderedDict[Tuple[str, ...], object]" = OrderedDict()

    def _key(self, labels: Mapping[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels):
        return self._values.get(self._key(labels), 0)

    def series(self) -> Dict[Tuple[str, ...], object]:
        """label-values tuple → value (counters/gauges)."""
        return dict(self._values)

    def _render_labels(self, key: Tuple[str, ...],
                       extra: Sequence[Tuple[str, str]] = ()) -> str:
        pairs = list(zip(self.labelnames, key)) + list(extra)
        if not pairs:
            return ""
        body = ",".join(f'{n}="{v}"' for n, v in pairs)
        return "{" + body + "}"

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._values):
            v = self._values[key]
            if v is None:
                continue
            lines.append(
                f"{self.name}{self._render_labels(key)} {_fmt_num(v)}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount=1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        self._values[key] = self._values.get(key, type(amount)(0)) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels) -> None:
        self._values[self._key(labels)] = value

    def inc(self, amount=1, **labels) -> None:
        key = self._key(labels)
        self._values[key] = self._values.get(key, type(amount)(0)) + amount

    def dec(self, amount=1, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus classic style): ``le`` upper
    bounds plus an implicit +Inf bucket, a sum and a count per label
    set.  :meth:`quantile` interpolates linearly inside the containing
    bucket — the same estimator as PromQL ``histogram_quantile``."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"{name}: buckets must be strictly increasing")
        self.bounds = bounds

    def _state(self, key: Tuple[str, ...]):
        st = self._values.get(key)
        if st is None:
            st = self._values[key] = {
                "counts": [0] * (len(self.bounds) + 1),
                "sum": 0.0, "count": 0,
            }
        return st

    def observe(self, value: float, **labels) -> None:
        st = self._state(self._key(labels))
        v = float(value)
        i = len(self.bounds)  # +Inf bucket by default
        for j, b in enumerate(self.bounds):
            if v <= b:
                i = j
                break
        st["counts"][i] += 1
        st["sum"] += v
        st["count"] += 1

    def snapshot(self, **labels) -> dict:
        """Plain-dict view for JSON artifacts: bucket bounds, per-bucket
        counts (last = +Inf), sum and count."""
        st = self._state(self._key(labels))
        return {"le": list(self.bounds) + ["+Inf"],
                "counts": list(st["counts"]),
                "sum": st["sum"], "count": st["count"]}

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile (0..1) from the buckets: find the
        bucket where the cumulative count first reaches ``q * count``
        and interpolate linearly between its bounds (lower bound 0 for
        the first bucket; the +Inf bucket clamps to the highest finite
        bound)."""
        st = self._state(self._key(labels))
        total = st["count"]
        if total == 0:
            return 0.0
        if len(self.bounds) == 1:
            # A single finite bucket gives no interpolation basis: every
            # observation is either <= the bound or in +Inf, and a lower
            # edge of 0 would fabricate precision.  Report the bound.
            return self.bounds[0]
        rank = q * total
        cum = 0
        for i, c in enumerate(st["counts"]):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.bounds):  # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - prev) / c
        return self.bounds[-1]

    def percentile(self, p: float, **labels) -> float:
        return self.quantile(p / 100.0, **labels)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._values):
            st = self._values[key]
            cum = 0
            for b, c in zip(list(self.bounds) + [math.inf], st["counts"]):
                cum += c
                le = self._render_labels(key, [("le", _fmt_num(b))])
                lines.append(f"{self.name}_bucket{le} {cum}")
            lab = self._render_labels(key)
            lines.append(f"{self.name}_sum{lab} {_fmt_num(st['sum'])}")
            lines.append(f"{self.name}_count{lab} {st['count']}")
        return lines


class MetricGroup(MutableMapping):
    """A dict-shaped stats facade backed by one registry gauge per key.

    The engine/store/compiler/tier counters were plain dicts mutated in
    ~50 places (``stats["hits"] += 1``); adopting them into a
    MetricGroup keeps every call site and the ``stats()`` schema intact
    while the values live in the registry (visible to the Prometheus
    renderer).  Values keep their python type (int stays int) so
    ``type(v)(0)`` resets still work."""

    def __init__(self, registry: "MetricsRegistry", prefix: str,
                 init: Mapping[str, object], help: str = ""):
        self._registry = registry
        self._prefix = prefix
        self._help = help
        self._metrics: "OrderedDict[str, Gauge]" = OrderedDict()
        for k, v in init.items():
            self[k] = v

    def _gauge(self, key: str) -> Gauge:
        g = self._metrics.get(key)
        if g is None:
            g = self._registry.gauge(f"{self._prefix}_{key}", self._help)
            self._metrics[key] = g
        return g

    def __getitem__(self, key: str):
        if key not in self._metrics:
            raise KeyError(key)
        return self._metrics[key].value()

    def __setitem__(self, key: str, value) -> None:
        self._gauge(key).set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("MetricGroup keys are fixed at registration")

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __repr__(self) -> str:
        return f"MetricGroup({dict(self)!r})"


class MetricsRegistry:
    """Process-local registry of named metrics.

    ``counter()``/``gauge()``/``histogram()`` are idempotent: asking for
    an existing name returns the existing metric (kind and labels must
    match), so components constructed per-serve keep accumulating into
    the same series.
    """

    def __init__(self):
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.labelnames}")
            return m
        m = self._metrics[name] = cls(name, help, labelnames, **kw)
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def group(self, prefix: str, init: Mapping[str, object],
              help: str = "") -> MetricGroup:
        """Adopt a stats dict: returns a dict-compatible
        :class:`MetricGroup` whose values are registry gauges named
        ``{prefix}_{key}``."""
        return MetricGroup(self, prefix, init, help)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return list(self._metrics)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): metrics in name
        order, label sets in sorted order — deterministic output."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """Nested plain-dict view (JSON-friendly) of every series."""
        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = {}
            for key in sorted(m._values):
                label = ",".join(f"{n}={v}"
                                 for n, v in zip(m.labelnames, key)) or ""
                v = m._values[key]
                series[label] = dict(v) if isinstance(v, dict) else v
            out[name] = {"kind": m.kind, "series": series}
        return out
