"""The port's SLO burn-rate watchdog (``repro_torch/serving/slo_watchdog.py``)
against the reference's, on the CPU.

The cases of ``tests/test_slo_watchdog.py`` that need no engine (burn
arithmetic by hand, the two-window fire, clear hysteresis, the
``ShedDegrade`` hook on a fake engine, the alert-log schema) run once on
each package's modules (the ``S`` fixture).  One sequence of observations
gives byte-equal ``SLOWatchdog.dumps()``, Prometheus text and tracer
instants in both packages; the schema string is the reference's.  The
engine's watchdog wiring is held in
``tests/test_torch_engine_telemetry.py``.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serving.slo_watchdog as jwd
import repro.serving.telemetry as jtelemetry
import repro_torch.serving.slo_watchdog as pwd
import repro_torch.serving.telemetry as ptelemetry


def _pkg(wd, telemetry):
    return SimpleNamespace(
        SLOWatchdog=wd.SLOWatchdog, BurnRateRule=wd.BurnRateRule,
        ShedDegrade=wd.ShedDegrade, default_rules=wd.default_rules,
        validate_alert_log=wd.validate_alert_log,
        MetricsRegistry=telemetry.MetricsRegistry, Tracer=telemetry.Tracer)


PKGS = {"repro": _pkg(jwd, jtelemetry), "repro_torch": _pkg(pwd, ptelemetry)}


@pytest.fixture(params=sorted(PKGS))
def S(request):
    return PKGS[request.param]


def _rule(S, **kw):
    base = dict(name="lat", metric="ttft", threshold=1.0, budget=0.5,
                fast_window_s=2.0, slow_window_s=10.0,
                fire_burn=1.0, clear_burn=0.5, severity="page")
    base.update(kw)
    return S.BurnRateRule(**base)


def _fire_once(wd):
    wd.observe("ttft", 2.0, t=1.0)
    wd.observe("ttft", 2.0, t=1.5)
    return wd.step(now=2.0)


class _FakeEngine:
    def __init__(self, S):
        self.shed_floor = None
        self.degrade_hint = False
        self.metrics = S.MetricsRegistry()


def test_schema_and_rules_are_the_reference_s():
    assert pwd.ALERT_LOG_SCHEMA == jwd.ALERT_LOG_SCHEMA == "repro/alert-log/v1"
    assert pwd.SIGNALS == jwd.SIGNALS
    for kw in ({}, dict(slo_ttft_s=0.5, slo_gap_s=0.01,
                        min_tokens_per_step=2.0)):
        assert [vars(r) for r in pwd.default_rules(**kw)] == [
            vars(r) for r in jwd.default_rules(**kw)]
    assert pwd.SLOWatchdog is not jwd.SLOWatchdog


# ---------------------------------------------------------------------------
# tests/test_slo_watchdog.py's unit cases, on both packages
# ---------------------------------------------------------------------------


def test_fire_with_hand_computed_burns(S):
    wd = S.SLOWatchdog([_rule(S)])
    wd.observe("ttft", 2.0, t=1.0)   # violates (> 1.0)
    wd.observe("ttft", 0.5, t=1.5)   # ok
    # fast [0, 2]: 1 bad of 2 -> frac 0.5 / budget 0.5 = burn 1.0
    # slow [-8, 2]: same two samples -> burn 1.0; both >= fire_burn
    events = wd.step(now=2.0)
    assert [e["kind"] for e in events] == ["fire"]
    assert events[0]["burn_fast"] == pytest.approx(1.0)
    assert events[0]["burn_slow"] == pytest.approx(1.0)
    assert events[0]["rule"] == "lat" and events[0]["severity"] == "page"
    assert wd.firing("lat") and wd.page_active



def test_clear_hysteresis_needs_burn_at_or_below_clear(S):
    wd = S.SLOWatchdog([_rule(S)])
    wd.observe("ttft", 2.0, t=1.0)
    wd.observe("ttft", 0.5, t=1.5)
    assert wd.step(now=2.0)[0]["kind"] == "fire"
    # burn still 1.0 > clear_burn 0.5 in [0.5, 2.5]: no clear yet
    assert wd.step(now=2.5) == []
    # three good samples push the bad one out of the fast window:
    # fast [1.5, 3.5] holds 4 samples, 0 bad -> burn 0.0 <= 0.5
    for t in (3.0, 3.2, 3.4):
        wd.observe("ttft", 0.5, t=t)
    events = wd.step(now=3.5)
    assert [e["kind"] for e in events] == ["clear"]
    assert events[0]["burn_fast"] == pytest.approx(0.0)
    assert not wd.firing("lat") and not wd.page_active



def test_silent_fast_window_clears_but_never_fires(S):
    wd = S.SLOWatchdog([_rule(S)])
    # an empty window is not evidence either way: no samples, no fire
    assert wd.step(now=1.0) == []
    wd.observe("ttft", 2.0, t=1.0)
    wd.observe("ttft", 2.0, t=1.5)
    assert wd.step(now=2.0)[0]["kind"] == "fire"
    # far future: fast window empty -> clear with burn_fast None
    events = wd.step(now=100.0)
    assert [e["kind"] for e in events] == ["clear"]
    assert events[0]["burn_fast"] is None



def test_fire_requires_both_windows_hot(S):
    wd = S.SLOWatchdog([_rule(S)])
    # seven good samples age into the slow window only
    for i in range(7):
        wd.observe("ttft", 0.5, t=1.0 + i)
    wd.observe("ttft", 2.0, t=9.0)
    wd.observe("ttft", 2.0, t=9.5)
    # fast [8, 10]: 2/2 bad -> burn 4.0; slow [0, 10]: 2/9 bad ->
    # (2/9)/0.5 = 0.444 < fire_burn -> the blip filter holds
    assert wd.step(now=10.0) == []
    assert not wd.firing("lat")



def test_lt_op_fires_on_throughput_floor(S):
    wd = S.SLOWatchdog([_rule(S, name="floor", metric="tokens_per_step",
                            threshold=0.5, op="lt", severity="ticket")])
    wd.observe("tokens_per_step", 0.2, t=1.0)
    wd.observe("tokens_per_step", 0.1, t=1.5)
    events = wd.step(now=2.0)
    assert [e["kind"] for e in events] == ["fire"]
    assert events[0]["severity"] == "ticket"
    assert not wd.page_active  # ticket severity never pages



def test_unwatched_metric_is_dropped(S):
    wd = S.SLOWatchdog([_rule(S)])
    wd.observe("decode_gap", 99.0, t=1.0)  # no rule watches this signal
    assert wd._samples == {}
    assert wd.step(now=2.0) == []



def test_rule_validation(S):
    with pytest.raises(ValueError):
        _rule(S, budget=0.0)
    with pytest.raises(ValueError):
        _rule(S, fast_window_s=5.0, slow_window_s=1.0)
    with pytest.raises(ValueError):
        _rule(S, severity="sev1")
    with pytest.raises(ValueError):
        _rule(S, op="ge")
    with pytest.raises(ValueError):
        _rule(S, clear_burn=2.0, fire_burn=1.0)
    with pytest.raises(ValueError):
        S.SLOWatchdog([_rule(S), _rule(S)])  # duplicate names
    with pytest.raises(ValueError):
        S.SLOWatchdog([_rule(S)]).now()  # no clock, no explicit t



def test_alert_counter_renders_before_and_after_fire(S):
    reg = S.MetricsRegistry()
    wd = S.SLOWatchdog([_rule(S)], metrics=reg)
    # eagerly registered: scrapeable before any alert
    assert "serving_alerts_total" in reg.render_prometheus()
    _fire_once(wd)
    assert ('serving_alerts_total{rule="lat",severity="page"} 1'
            in reg.render_prometheus())



def test_tracer_gets_alert_instants(S):
    tr = S.Tracer(clock=lambda: 0.0)
    wd = S.SLOWatchdog([_rule(S)], tracer=tr)
    _fire_once(wd)
    wd.step(now=100.0)
    names = [e["name"] for e in tr.events()]
    assert names == ["alert_fire:lat", "alert_clear:lat"]
    assert tr.events()[0]["track"] == "watchdog"



def test_report_roundtrip_and_determinism(S):
    def run():
        wd = S.SLOWatchdog([_rule(S)])
        _fire_once(wd)
        wd.step(now=100.0)
        return wd
    a, b = run(), run()
    assert a.dumps() == b.dumps()  # byte-identical serialization
    doc = json.loads(a.dumps())
    assert S.validate_alert_log(doc) == []
    assert doc["fires"] == 1 and doc["clears"] == 1



def test_validate_alert_log_catches_malformed(S):
    wd = S.SLOWatchdog([_rule(S)])
    _fire_once(wd)
    good = wd.report()
    bad = json.loads(json.dumps(good))
    bad["events"][0]["kind"] = "oops"
    assert any("bad kind" in e for e in S.validate_alert_log(bad))
    bad = json.loads(json.dumps(good))
    bad["events"].append(dict(bad["events"][0]))  # double fire
    assert any("double fire" in e for e in S.validate_alert_log(bad))
    bad = json.loads(json.dumps(good))
    bad["events"].append(dict(bad["events"][0], kind="clear", t=0.0))
    assert any("not monotonic" in e for e in S.validate_alert_log(bad))
    bad = json.loads(json.dumps(good))
    bad["events"][0]["kind"] = "clear"
    assert any("clear without fire" in e for e in S.validate_alert_log(bad))
    bad = json.loads(json.dumps(good))
    bad["fires"] = 7
    assert any("fires count" in e for e in S.validate_alert_log(bad))
    bad = json.loads(json.dumps(good))
    bad["events"][0]["rule"] = "mystery"
    assert any("unknown rule" in e for e in S.validate_alert_log(bad))



def test_shed_degrade_on_page_fire_and_clear(S):
    eng = _FakeEngine(S)
    wd = S.SLOWatchdog([_rule(S)], degrade_hook=S.ShedDegrade())
    wd.attach_engine(eng)
    _fire_once(wd)
    assert eng.shed_floor == 1 and eng.degrade_hint is True
    snap = eng.metrics.snapshot()
    assert snap["serving_degradations_total"]["series"]["action=shed"] == 1
    wd.step(now=100.0)  # silent window -> clear -> restore
    assert eng.shed_floor is None and eng.degrade_hint is False
    snap = eng.metrics.snapshot()
    assert snap["serving_degradations_total"]["series"]["action=restore"] == 1



def test_ticket_alert_never_sheds(S):
    eng = _FakeEngine(S)
    wd = S.SLOWatchdog([_rule(S, severity="ticket")],
                     degrade_hook=S.ShedDegrade())
    wd.attach_engine(eng)
    _fire_once(wd)
    assert eng.shed_floor is None and eng.degrade_hint is False



def test_shed_persists_until_last_page_clears(S):
    rules = [_rule(S, name="a"), _rule(S, name="b", fast_window_s=1.0)]
    eng = _FakeEngine(S)
    wd = S.SLOWatchdog(rules, degrade_hook=S.ShedDegrade())
    wd.attach_engine(eng)
    wd.observe("ttft", 2.0, t=1.0)
    wd.observe("ttft", 2.0, t=1.5)
    wd.step(now=2.0)  # both fire
    assert wd.firing("a") and wd.firing("b") and eng.shed_floor == 1
    # b's 1s fast window empties first: one page still active -> no undo
    wd.step(now=3.1)
    assert not wd.firing("b") and wd.firing("a")
    assert eng.shed_floor == 1
    wd.step(now=100.0)
    assert not wd.page_active and eng.shed_floor is None





# ---------------------------------------------------------------------------
# one sequence of observations, byte-equal output in both packages
# ---------------------------------------------------------------------------


def _drive(S, seed):
    """Seeded TTFT, gap and tokens-per-step samples on an explicit
    timeline, stepped every few samples, through the default rules with
    the degradation hook on a fake engine, a registry and a tracer."""
    rng = np.random.default_rng(seed)
    reg = S.MetricsRegistry()
    tr = S.Tracer(clock=lambda: 0.0)
    eng = _FakeEngine(S)
    wd = S.SLOWatchdog(S.default_rules(slo_ttft_s=0.02), metrics=reg,
                       tracer=tr, degrade_hook=S.ShedDegrade())
    wd.attach_engine(eng)
    t = 0.0
    sheds = 0
    for i in range(400):
        t += float(rng.exponential(2e-3))
        hot = (i // 60) % 2 == 1  # alternating calm and burning phases
        wd.observe("ttft", float(rng.exponential(0.03 if hot else 0.005)),
                   t=t)
        wd.observe("decode_gap", float(rng.exponential(
            0.01 if hot else 0.001)), t=t)
        wd.observe("tokens_per_step", float(rng.uniform(0, 2)), t=t)
        if i % 3 == 0:
            wd.step(now=t)
            sheds += eng.shed_floor is not None
    return wd, reg, tr, sheds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_sequence_gives_byte_equal_output(seed):
    jw, jreg, jtr, jsheds = _drive(PKGS["repro"], seed)
    pw, preg, ptr, psheds = _drive(PKGS["repro_torch"], seed)
    assert pw.dumps() == jw.dumps()
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert ptr.dumps() == jtr.dumps()
    assert psheds == jsheds > 0  # a page alert fired and shed
    doc = json.loads(pw.dumps())
    assert pwd.validate_alert_log(doc) == [] and doc["fires"] > 1
