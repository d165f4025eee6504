"""The port's telemetry (``repro_torch/serving/telemetry.py`` and the
clock's charge counters) against the reference's, on the CPU.

The cases of ``tests/test_telemetry.py`` that need no engine are pure
Python: each runs once on each package's modules (the ``S`` fixture), so
one body holds both.  Beyond them, one sequence of observations gives
byte-equal Prometheus text, Chrome-trace JSON and registry snapshots in
both packages, the port's ``REQUIRED_SPANS`` is the reference's, and
neither package's modules import the other.  The engines' telemetry is
held in ``tests/test_torch_engine_telemetry.py``.
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serving as jserving
import repro.serving.clock as jclock
import repro.serving.telemetry as jtelemetry
import repro_torch.serving as pserving
import repro_torch.serving.clock as pclock
import repro_torch.serving.telemetry as ptelemetry


def _pkg(serving, telemetry, clock):
    return SimpleNamespace(
        MetricsRegistry=telemetry.MetricsRegistry, Tracer=telemetry.Tracer,
        VirtualClock=clock.VirtualClock, Histogram=telemetry.Histogram,
        Counter=telemetry.Counter, Gauge=telemetry.Gauge,
        MetricGroup=telemetry.MetricGroup,
        validate_chrome_trace=telemetry.validate_chrome_trace,
        NULL_TRACER=telemetry.NULL_TRACER,
        REQUIRED_SPANS=telemetry.REQUIRED_SPANS, serving=serving)


PKGS = {"repro": _pkg(jserving, jtelemetry, jclock),
        "repro_torch": _pkg(pserving, ptelemetry, pclock)}


@pytest.fixture(params=sorted(PKGS))
def S(request):
    return PKGS[request.param]


def test_the_port_is_its_own_copy():
    """Every name the reference's telemetry exports, defined in the
    port's own module (no re-export of the reference's)."""
    assert ptelemetry.REQUIRED_SPANS == jtelemetry.REQUIRED_SPANS
    assert ptelemetry.DEFAULT_TIME_BUCKETS == jtelemetry.DEFAULT_TIME_BUCKETS
    assert sorted(ptelemetry.__all__) == sorted(jtelemetry.__all__)
    for name in ptelemetry.__all__:
        obj = getattr(ptelemetry, name)
        if isinstance(obj, type):
            assert obj.__module__ == "repro_torch.serving.telemetry", name
            assert obj is not getattr(jtelemetry, name)


def test_required_spans_match_the_linter_mirror():
    from tools.reprolint.serving_rules import _REQUIRED_SPANS
    assert ptelemetry.REQUIRED_SPANS == _REQUIRED_SPANS


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's unit cases, on both packages
# ---------------------------------------------------------------------------


def test_counter_gauge_basics(S):
    reg = S.MetricsRegistry()
    c = reg.counter("requests_total", "requests", labelnames=("priority",))
    c.inc(priority=0)
    c.inc(2, priority=0)
    c.inc(priority=1)
    assert c.value(priority=0) == 3 and c.value(priority=1) == 1
    with pytest.raises(ValueError):
        c.inc(-1, priority=0)          # counters only go up
    with pytest.raises(ValueError):
        c.inc(1, wrong_label=0)        # undeclared label set
    g = reg.gauge("queue_depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value() == 3



def test_registry_idempotent_and_kind_mismatch(S):
    reg = S.MetricsRegistry()
    a = reg.counter("jobs_total", labelnames=("family",))
    b = reg.counter("jobs_total", labelnames=("family",))
    assert a is b                      # same name -> same metric object
    with pytest.raises(ValueError):
        reg.gauge("jobs_total")        # kind mismatch
    with pytest.raises(ValueError):
        reg.counter("jobs_total")      # label-set mismatch



def test_histogram_hand_computed_quantiles(S):
    """Bucket-interpolated quantiles against hand arithmetic on buckets
    (1, 2, 5): observations [1, 2, 3] put one count in each of the first
    three buckets, so p99's rank 2.97 lands in (2, 5] with 2 below."""
    h = S.Histogram("lat", buckets=(1.0, 2.0, 5.0))
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    assert math.isclose(h.percentile(99), 2.0 + 3.0 * 0.97)
    assert math.isclose(h.percentile(50), 1.0 + 1.0 * 0.5)
    snap = h.snapshot()
    assert snap["le"] == [1.0, 2.0, 5.0, "+Inf"]
    assert snap["counts"] == [1, 1, 1, 0]
    assert snap["count"] == 3 and math.isclose(snap["sum"], 6.0)
    h.observe(100.0)                   # +Inf bucket clamps to top bound
    assert h.quantile(1.0) == 5.0
    assert S.Histogram("empty", buckets=(1.0,)).quantile(0.5) == 0.0
    with pytest.raises(ValueError):
        S.Histogram("bad", buckets=(2.0, 1.0))  # not strictly increasing



def test_histogram_quantile_edge_cases(S):
    """Regression: an empty histogram reports 0.0 from any quantile
    (never NaN or a crash), and a single finite bucket reports its bound
    — interpolating against the fabricated 0 lower edge would invent
    precision the buckets don't have."""
    assert S.Histogram("e", buckets=(1.0, 2.0)).quantile(0.5) == 0.0
    assert S.Histogram("e2", buckets=(1.0, 2.0)).quantile(0.99) == 0.0
    h = S.Histogram("one", buckets=(4.0,))
    assert h.quantile(0.5) == 0.0       # still empty -> 0.0
    h.observe(3.0)
    assert h.quantile(0.5) == 4.0       # single bucket -> the bound
    h.observe(100.0)                    # lands in +Inf
    assert h.quantile(0.99) == 4.0      # clamps to the only finite bound
    assert h.quantile(0.0) == 4.0
    # labeled series keep per-series behavior: one observed, one empty
    h2 = S.Histogram("lab", buckets=(2.0,), labelnames=("k",))
    h2.observe(1.0, k="a")
    assert h2.quantile(0.5, k="a") == 2.0
    assert h2.quantile(0.5, k="b") == 0.0



def test_prometheus_text_exposition(S):
    reg = S.MetricsRegistry()
    reg.counter("zebra_total", "last alphabetically").inc(7)
    c = reg.counter("apple_total", "first", labelnames=("kind",))
    c.inc(1, kind="b")
    c.inc(2, kind="a")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    text = reg.render_prometheus()
    assert text.endswith("\n")
    lines = text.splitlines()
    # metrics render in name order regardless of registration order
    assert lines[0] == "# HELP apple_total first"
    assert lines[1] == "# TYPE apple_total counter"
    # label sets in sorted order
    assert lines[2] == 'apple_total{kind="a"} 2'
    assert lines[3] == 'apple_total{kind="b"} 1'
    # histogram buckets are cumulative and end with +Inf, then sum/count
    assert 'lat_seconds_bucket{le="0.1"} 1' in lines
    assert 'lat_seconds_bucket{le="1"} 2' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 2' in lines
    assert "lat_seconds_sum 0.55" in lines
    assert "lat_seconds_count 2" in lines
    assert "zebra_total 7" in lines
    # deterministic: rendering twice is byte-identical
    assert text == reg.render_prometheus()



def test_metric_group_preserves_dict_contract(S):
    """The stats-dict facade: every `stats["k"] += 1` call site keeps
    working, values keep their python type, and the same numbers show up
    under `{prefix}_{key}` in the registry."""
    reg = S.MetricsRegistry()
    grp = reg.group("store", {"hits": 0, "misses": 0, "ratio": 0.0})
    grp["hits"] += 3
    grp["misses"] += 1
    grp["ratio"] = 0.75
    assert dict(grp) == {"hits": 3, "misses": 1, "ratio": 0.75}
    assert isinstance(grp["hits"], int)       # type preserved: resets via
    assert type(grp["hits"])(0) == 0          # type(v)(0) stay exact
    assert len(grp) == 3 and "hits" in grp
    assert reg.get("store_hits").value() == 3
    with pytest.raises(KeyError):
        grp["unknown"]
    with pytest.raises(TypeError):
        del grp["hits"]                       # keys fixed at registration
    assert "store_hits 3" in reg.render_prometheus()



def test_flight_recorder_ring_buffer(S):
    clock = S.VirtualClock()
    tr = S.Tracer(clock, capacity=4)
    for i in range(10):
        clock.advance(0.001)
        tr.instant("engine", f"ev{i}")
    assert len(tr.events()) == 4
    assert tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["ev6", "ev7", "ev8", "ev9"]
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 6
    tr.clear()
    assert tr.events() == [] and tr.dropped == 0
    with pytest.raises(ValueError):
        S.Tracer(capacity=0)



def test_chrome_trace_schema(S, tmp_path):
    clock = S.VirtualClock()
    tr = S.Tracer(clock, dump_path=str(tmp_path / "flight.json"))
    tr.span("engine", "decode_step", 0.0, 0.001, active=2)
    tr.instant("slot0", "finish", rid=0)
    tr.begin_async("scheduler", "waiting_on_prefix", 7, prefix="t")
    clock.advance(0.002)
    tr.end_async("scheduler", "waiting_on_prefix", 7)
    tr.span("weird-track", "custom", 0.0, 0.001)
    trace = tr.chrome_trace()
    assert S.validate_chrome_trace(trace) == []
    evs = trace["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    names = {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert {"engine", "slot0", "scheduler", "weird-track"} <= names
    by_name = {e["name"]: e for e in evs if e["ph"] != "M"}
    assert by_name["decode_step"]["ph"] == "X"
    assert math.isclose(by_name["decode_step"]["dur"], 1000.0)  # µs
    assert by_name["decode_step"]["args"] == {"active": 2}
    assert by_name["finish"]["s"] == "t"                 # instant scope
    assert by_name["waiting_on_prefix"]["id"] == "7"     # async pairing
    # fixed tids: shared tracks stay put, slots offset, unknowns >= 1024
    tid = {e["args"]["name"]: e["tid"]
           for e in meta if e["name"] == "thread_name"}
    assert tid["engine"] == 1 and tid["scheduler"] == 4
    assert tid["slot0"] == 16 and tid["weird-track"] >= 1024
    # dump round-trips through JSON and dump_on_error is best-effort
    path = tr.dump_on_error()
    assert json.load(open(path)) == trace
    assert S.Tracer(clock).dump_on_error() is None         # no path set



def test_validate_chrome_trace_catches_malformed(S):
    assert S.validate_chrome_trace({}) == ["traceEvents missing or empty"]
    bad = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 0.0},  # no dur
        {"ph": "b", "pid": 1, "tid": 1, "name": "w", "ts": 0.0},  # no id
        {"ph": "i", "pid": 1, "tid": 1, "name": "x"},             # no ts
    ]}
    errs = S.validate_chrome_trace(bad, require_spans=("missing_span",))
    assert any("missing 'dur'" in e for e in errs)
    assert any("missing 'id'" in e for e in errs)
    assert any("missing 'ts'" in e for e in errs)
    assert any("missing_span" in e for e in errs)



def test_null_tracer_is_inert(S):
    assert S.NULL_TRACER.enabled is False
    S.NULL_TRACER.span("engine", "x", 0.0)
    S.NULL_TRACER.instant("engine", "y")
    assert S.NULL_TRACER.events() == []
    assert S.NULL_TRACER.chrome_trace() == {"traceEvents": []}
    assert S.NULL_TRACER.dump_on_error() is None



def test_virtual_clock_charge_counters(S):
    clock = S.VirtualClock()
    reg = S.MetricsRegistry()
    clock.attach_metrics(reg)
    clock.attach_metrics(reg)                 # idempotent per registry
    clock.charge("decode_step", 3)
    clock.charge("compile_token", 8)
    units = reg.get("virtual_clock_charged_units_total")
    secs = reg.get("virtual_clock_charged_seconds_total")
    assert units.value(kind="decode_step") == 3.0
    assert math.isclose(secs.value(kind="decode_step"),
                        3 * clock.costs["decode_step"])
    assert math.isclose(clock.now,
                        3 * clock.costs["decode_step"]
                        + 8 * clock.costs["compile_token"])





# ---------------------------------------------------------------------------
# one sequence of observations, byte-equal output in both packages
# ---------------------------------------------------------------------------


def _drive(S, seed):
    """Counters, gauges, histograms (labelled and not), a MetricGroup, the
    clock's charge counters and a tracer over one seeded op sequence."""
    rng = np.random.default_rng(seed)
    clock = S.VirtualClock()
    reg = S.MetricsRegistry()
    clock.attach_metrics(reg)
    tr = S.Tracer(clock, capacity=64)
    c = reg.counter("requests_total", "requests", labelnames=("priority",))
    g = reg.gauge("queue_depth", "queued")
    h = reg.histogram("lat_seconds", "latency", labelnames=("priority",))
    grp = reg.group("store", {"hits": 0, "misses": 0, "ratio": 0.0},
                    help="store counter")
    kinds = ("decode_step", "prefill_token", "compile_token",
             "promote_chunk", "draft_step")
    for i in range(200):
        op = int(rng.integers(0, 7))
        p = int(rng.integers(0, 3))
        if op == 0:
            c.inc(int(rng.integers(1, 4)), priority=p)
        elif op == 1:
            g.set(int(rng.integers(0, 9)))
        elif op == 2:
            h.observe(float(rng.exponential(0.01)), priority=p)
        elif op == 3:
            grp["hits" if p else "misses"] += 1
            grp["ratio"] = grp["hits"] / max(1, grp["hits"] + grp["misses"])
        elif op == 4:
            clock.charge(kinds[p + int(rng.integers(0, 3))],
                         int(rng.integers(1, 40)))
        elif op == 5:
            t0 = clock()
            clock.advance(float(rng.uniform(0, 1e-3)))
            tr.span(f"slot{p}", "admission", t0, rid=i, prefix=None)
        else:
            tr.begin_async("scheduler", "waiting_on_prefix", i,
                           prefix=f"task{p}")
            tr.instant("engine", "autotune", action="shrink",
                       compile_budget=p)
            tr.end_async("scheduler", "waiting_on_prefix", i)
    return reg, tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_sequence_gives_byte_equal_output(seed):
    jreg, jtr = _drive(PKGS["repro"], seed)
    preg, ptr = _drive(PKGS["repro_torch"], seed)
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert json.dumps(preg.snapshot(), sort_keys=True) == json.dumps(
        jreg.snapshot(), sort_keys=True)
    assert ptr.dumps() == jtr.dumps()
    assert ptr.dropped == jtr.dropped > 0  # the ring wrapped
    assert preg.names() == jreg.names()
