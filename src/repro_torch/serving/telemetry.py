"""The serving stack's metric histogram (the port's own copy of the
``Histogram`` of ``repro/serving/telemetry.py`` and its ``_Metric``
base).

:func:`~repro_torch.serving.traffic.slo_metrics` reduces the engine's
decode-gap samples through it: bucket-interpolated quantiles, the
estimator a Prometheus ``histogram_quantile`` reports.  The tracer, the
metrics registry and the other metric kinds are a later slice of the
port.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Mapping, Sequence, Tuple

__all__ = ["Histogram", "DEFAULT_TIME_BUCKETS"]

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
