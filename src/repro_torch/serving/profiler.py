"""Per-phase profiler: fold flight-recorder spans into self-time (the
port's own copy of ``repro/serving/profiler.py``).

Consumes a Chrome-trace dict (the :meth:`Tracer.chrome_trace` export —
the same artifact CI already schema-validates) and attributes time to
the serving subsystems:

=========  =====================================================
phase      spans
=========  =====================================================
decode     ``decode_step`` / ``fused_step`` on the engine track
prefill    per-slot ``admission`` spans (classic path; fused
           joins are *counted* but excluded from interval math —
           their work happens inside fused steps)
compile    ``compile_chunk`` on the compiler track
promote    ``promote_chunk`` on the promoter track
=========  =====================================================

``total_s`` is the union measure of a phase's intervals.  ``self_s``
subtracts time explainable by work that *rides* the phase's dispatch:
a fused compile chunk's span coincides exactly with its fused step, so
decode self-time excludes compile/promote/prefill overlap.  Speculative
decoding has no span of its own (acceptance is free within the fused
step) and is reported as an instant count.

On the virtual clock every number here is a pure function of
(scenario, seed).  On the card the spans are host times on the engine's
clock: a step span closes after the step's token readback, so it covers
the step's device work.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

__all__ = ["profile_spans", "validate_profile_report",
           "PROFILE_REPORT_SCHEMA"]

PROFILE_REPORT_SCHEMA = "repro/profile-report/v1"

PHASES = ("decode", "prefill", "compile", "promote")

_PHASE_SPANS = {
    "decode_step": "decode",
    "fused_step": "decode",
    "admission": "prefill",
    "compile_chunk": "compile",
    "promote_chunk": "promote",
}

_COUNTED_INSTANTS = ("spec_accept", "preempt", "resume", "autotune")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _measure(merged: Iterable[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in merged)


def _subtract(merged: List[Tuple[float, float]],
              cuts: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Set difference of two merged interval lists."""
    out: List[Tuple[float, float]] = []
    for lo, hi in merged:
        cur = lo
        for c0, c1 in cuts:
            if c1 <= cur or c0 >= hi:
                continue
            if c0 > cur:
                out.append((cur, c0))
            cur = max(cur, c1)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def profile_spans(trace: dict) -> dict:
    """Fold a Chrome-trace dict into a ``repro/profile-report/v1``."""
    events = trace.get("traceEvents", [])
    intervals: Dict[str, List[Tuple[float, float]]] = {p: [] for p in PHASES}
    spans: Dict[str, int] = {p: 0 for p in PHASES}
    counts: Dict[str, int] = {f"{n}s": 0 for n in _COUNTED_INSTANTS}
    counts["fused_joins"] = 0
    for ev in events:
        ph, name = ev.get("ph"), ev.get("name")
        if ph == "i" and name in _COUNTED_INSTANTS:
            counts[f"{name}s"] += 1
            continue
        if ph != "X":
            continue
        phase = _PHASE_SPANS.get(name)
        if phase is None:
            continue
        args = ev.get("args") or {}
        if name == "admission" and args.get("fused_join"):
            # the join's prompt streamed through fused steps: its span
            # covers the whole join window, which *is* decode time
            counts["fused_joins"] += 1
            continue
        t0 = float(ev["ts"]) * 1e-6
        t1 = t0 + float(ev.get("dur", 0.0)) * 1e-6
        intervals[phase].append((t0, t1))
        spans[phase] += 1

    merged = {p: _merge(intervals[p]) for p in PHASES}
    ridealong = _merge(merged["compile"] + merged["promote"]
                       + merged["prefill"])
    phases = {}
    for p in PHASES:
        total = _measure(merged[p])
        if p == "decode":
            self_s = _measure(_subtract(merged[p], ridealong))
        else:
            self_s = total
        phases[p] = {"spans": spans[p],
                     "total_s": round(total, 9),
                     "self_s": round(self_s, 9)}
    wall = _measure(_merge([iv for p in PHASES for iv in merged[p]]))
    return {"schema": PROFILE_REPORT_SCHEMA,
            "wall_s": round(wall, 9),
            "phases": phases,
            "counts": counts}


def validate_profile_report(doc: dict) -> List[str]:
    """Schema-check a profile report; returns problems (empty = valid)."""
    errs: List[str] = []
    if doc.get("schema") != PROFILE_REPORT_SCHEMA:
        errs.append(f"schema != {PROFILE_REPORT_SCHEMA!r}: "
                    f"{doc.get('schema')!r}")
    phases = doc.get("phases")
    if not isinstance(phases, dict):
        return errs + ["phases missing or not a dict"]
    for p in PHASES:
        st = phases.get(p)
        if not isinstance(st, dict):
            errs.append(f"phase {p!r} missing")
            continue
        for field in ("spans", "total_s", "self_s"):
            v = st.get(field)
            if not isinstance(v, (int, float)) or v < 0:
                errs.append(f"phase {p}: bad {field!r}: {v!r}")
        if isinstance(st.get("self_s"), (int, float)) and \
                isinstance(st.get("total_s"), (int, float)) and \
                st["self_s"] > st["total_s"] + 1e-9:
            errs.append(f"phase {p}: self_s exceeds total_s")
    wall = doc.get("wall_s")
    if not isinstance(wall, (int, float)) or wall < 0:
        errs.append(f"bad wall_s: {wall!r}")
    elif isinstance(phases.get("decode", {}).get("total_s"), (int, float)) \
            and wall + 1e-9 < max(
                (st.get("total_s", 0.0) for st in phases.values()
                 if isinstance(st, dict)), default=0.0):
        errs.append("wall_s smaller than a single phase total")
    counts = doc.get("counts")
    if not isinstance(counts, dict):
        errs.append("counts missing or not a dict")
    else:
        for k, v in counts.items():
            if not isinstance(v, int) or v < 0:
                errs.append(f"counts[{k!r}]: bad value {v!r}")
    return errs
