"""The port's span profiler (``repro_torch/serving/profiler.py``) against
the reference's, on the CPU.

The cases of ``tests/test_profiler.py`` (interval union and subtraction
by hand, the fused-join exclusion, instant counts, schema validation, a
round trip through a real ``Tracer``) run once on each package's modules
(the ``S`` fixture).  Seeded synthetic traces give byte-equal
``repro/profile-report/v1`` reports in both packages.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serving.profiler as jprofiler
import repro.serving.telemetry as jtelemetry
import repro_torch.serving.profiler as pprofiler
import repro_torch.serving.telemetry as ptelemetry


def _pkg(profiler, telemetry):
    return SimpleNamespace(
        profile_spans=profiler.profile_spans,
        validate_profile_report=profiler.validate_profile_report,
        PROFILE_REPORT_SCHEMA=profiler.PROFILE_REPORT_SCHEMA,
        _merge=profiler._merge, _measure=profiler._measure,
        _subtract=profiler._subtract, Tracer=telemetry.Tracer)


PKGS = {"repro": _pkg(jprofiler, jtelemetry),
        "repro_torch": _pkg(pprofiler, ptelemetry)}


@pytest.fixture(params=sorted(PKGS))
def S(request):
    return PKGS[request.param]


def _ev(name, t0_s, dur_s, **args):
    return {"ph": "X", "name": name, "pid": 1, "tid": 1,
            "ts": t0_s * 1e6, "dur": dur_s * 1e6, "args": args}


def _inst(name, t_s):
    return {"ph": "i", "name": name, "pid": 1, "tid": 1,
            "ts": t_s * 1e6, "args": {}}


def _trace(*events):
    return {"traceEvents": list(events)}


def test_schema_and_phases_are_the_reference_s():
    assert pprofiler.PROFILE_REPORT_SCHEMA == jprofiler.PROFILE_REPORT_SCHEMA
    assert pprofiler.PROFILE_REPORT_SCHEMA == "repro/profile-report/v1"
    assert pprofiler.PHASES == jprofiler.PHASES
    assert pprofiler._PHASE_SPANS == jprofiler._PHASE_SPANS
    assert pprofiler._COUNTED_INSTANTS == jprofiler._COUNTED_INSTANTS
    assert pprofiler.profile_spans is not jprofiler.profile_spans


# ---------------------------------------------------------------------------
# tests/test_profiler.py's cases, on both packages
# ---------------------------------------------------------------------------


def test_merge_and_measure_hand_computed(S):
    merged = S._merge([(3.0, 8.0), (0.0, 5.0), (10.0, 11.0)])
    assert merged == [(0.0, 8.0), (10.0, 11.0)]
    assert S._measure(merged) == pytest.approx(9.0)
    assert S._merge([]) == [] and S._measure([]) == 0.0



def test_subtract_hand_computed(S):
    base = [(0.0, 10.0)]
    # cut the middle, clip an edge, ignore a disjoint cut
    cuts = [(2.0, 4.0), (9.0, 12.0), (20.0, 21.0)]
    assert S._subtract(base, cuts) == [(0.0, 2.0), (4.0, 9.0)]
    assert S._subtract(base, [(0.0, 10.0)]) == []  # full cover
    assert S._subtract(base, []) == base



def test_profile_hand_computed_self_times(S):
    """decode [0, 10ms] with a compile chunk [2, 4ms] riding inside it:
    decode self-time is 8 ms; compile/prefill/promote keep self==total."""
    report = S.profile_spans(_trace(
        _ev("decode_step", 0.0, 0.010),
        _ev("compile_chunk", 0.002, 0.002),
        _ev("admission", 0.020, 0.002),
        _ev("promote_chunk", 0.030, 0.001),
    ))
    ph = report["phases"]
    assert ph["decode"] == {"spans": 1,
                            "total_s": pytest.approx(0.010),
                            "self_s": pytest.approx(0.008)}
    assert ph["compile"]["total_s"] == pytest.approx(0.002)
    assert ph["compile"]["self_s"] == pytest.approx(0.002)
    assert ph["prefill"]["spans"] == 1
    assert ph["promote"]["spans"] == 1
    # wall = union of everything: 10 + 2 + 1 ms
    assert report["wall_s"] == pytest.approx(0.013)
    assert S.validate_profile_report(report) == []



def test_overlapping_decode_spans_union_not_sum(S):
    report = S.profile_spans(_trace(
        _ev("decode_step", 0.0, 0.005),
        _ev("fused_step", 0.003, 0.005),   # overlaps the first 2 ms
    ))
    assert report["phases"]["decode"]["spans"] == 2
    assert report["phases"]["decode"]["total_s"] == pytest.approx(0.008)



def test_fused_join_admission_excluded_from_prefill(S):
    report = S.profile_spans(_trace(
        _ev("admission", 0.0, 0.002),
        _ev("admission", 0.010, 0.030, fused_join=True),
    ))
    # the join's span covers whole fused-step windows — counting it as
    # prefill would double-book decode time
    assert report["phases"]["prefill"]["spans"] == 1
    assert report["phases"]["prefill"]["total_s"] == pytest.approx(0.002)
    assert report["counts"]["fused_joins"] == 1



def test_instants_counted_not_measured(S):
    report = S.profile_spans(_trace(
        _ev("decode_step", 0.0, 0.001),
        _inst("spec_accept", 0.0005),
        _inst("spec_accept", 0.0008),
        _inst("preempt", 0.0002),
        _inst("resume", 0.0004),
        _inst("autotune", 0.0009),
        _inst("finish", 0.001),            # not a counted instant
    ))
    assert report["counts"] == {"spec_accepts": 2, "preempts": 1,
                                "resumes": 1, "autotunes": 1,
                                "fused_joins": 0}
    assert report["wall_s"] == pytest.approx(0.001)



def test_unknown_spans_and_metadata_ignored(S):
    report = S.profile_spans(_trace(
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "engine"}},
        _ev("mystery_span", 0.0, 1.0),
        _ev("decode_step", 0.0, 0.001),
    ))
    assert report["wall_s"] == pytest.approx(0.001)



def test_empty_trace_profiles_to_zero(S):
    report = S.profile_spans(_trace())
    assert report["wall_s"] == 0.0
    assert all(st["spans"] == 0 and st["total_s"] == 0.0
               for st in report["phases"].values())
    assert S.validate_profile_report(report) == []



def test_validate_profile_report_catches_malformed(S):
    good = S.profile_spans(_trace(_ev("decode_step", 0.0, 0.001)))
    bad = json.loads(json.dumps(good))
    bad["schema"] = "wrong/v9"
    assert any("schema" in e for e in S.validate_profile_report(bad))
    bad = json.loads(json.dumps(good))
    del bad["phases"]["compile"]
    assert any("missing" in e for e in S.validate_profile_report(bad))
    bad = json.loads(json.dumps(good))
    bad["phases"]["decode"]["self_s"] = 99.0  # self > total
    assert any("exceeds" in e for e in S.validate_profile_report(bad))
    bad = json.loads(json.dumps(good))
    bad["phases"]["decode"]["total_s"] = -1.0
    assert any("bad 'total_s'" in e for e in S.validate_profile_report(bad))
    bad = json.loads(json.dumps(good))
    bad["wall_s"] = 0.0  # smaller than the decode phase total
    assert any("wall_s" in e for e in S.validate_profile_report(bad))
    bad = json.loads(json.dumps(good))
    bad["counts"]["preempts"] = 1.5
    assert any("counts" in e for e in S.validate_profile_report(bad))



def test_round_trip_through_real_tracer(S):
    clock = iter(float(i) for i in range(100))
    tr = S.Tracer(clock=lambda: next(clock))
    tr.span("engine", "decode_step", 0.0, 0.5)
    tr.span("compiler", "compile_chunk", 0.1, 0.2)
    tr.instant("slot0", "preempt")
    report = S.profile_spans(tr.chrome_trace())
    assert report["schema"] == S.PROFILE_REPORT_SCHEMA
    assert S.validate_profile_report(report) == []
    assert report["phases"]["decode"]["self_s"] == pytest.approx(0.4)
    assert report["counts"]["preempts"] == 1
    # determinism: same trace, same bytes
    again = S.profile_spans(tr.chrome_trace())
    assert json.dumps(report, sort_keys=True) == \
        json.dumps(again, sort_keys=True)


# ---------------------------------------------------------------------------
# seeded traces, byte-equal reports in both packages
# ---------------------------------------------------------------------------


def _random_trace(seed):
    """Overlapping spans of every phase (fused joins among the
    admissions), the counted instants and others, through a real tracer
    on an explicit timeline."""
    rng = np.random.default_rng(seed)
    events = []
    t = 0.0
    names = ("decode_step", "fused_step", "admission", "compile_chunk",
             "promote_chunk", "mystery")
    for _ in range(300):
        t += float(rng.exponential(1e-3))
        if rng.uniform() < 0.2:
            events.append(_inst(str(rng.choice(
                ["spec_accept", "preempt", "resume", "autotune", "finish"])),
                t))
            continue
        name = str(rng.choice(names))
        args = ({"fused_join": True}
                if name == "admission" and rng.uniform() < 0.3 else {})
        events.append(_ev(name, t, float(rng.exponential(2e-3)), **args))
    return _trace(*events)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_one_trace_gives_byte_equal_reports(seed):
    trace = _random_trace(seed)
    got = pprofiler.profile_spans(trace)
    want = jprofiler.profile_spans(trace)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert pprofiler.validate_profile_report(got) == []
    assert got["phases"]["decode"]["self_s"] < got["phases"]["decode"][
        "total_s"]
