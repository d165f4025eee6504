"""The port's HTTP telemetry plane (``repro_torch/serving/server.py``)
against the reference's, on the CPU.

The cases of ``tests/test_server.py`` that run on a fake engine (every
route, 404 / 405 / 500, the lifecycle) run once on each package's modules
(the ``S`` fixture).  Then the port's own contract: its JSON encoder never
reads a tensor's values (on a CUDA tensor that would synchronize the card
from the server's thread), both packages serve the same bytes for one
fake engine, and a port engine scraped on all four routes from another
thread while it serves emits the tokens of the serve without scraping.
"""

import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro.serving.server as jserver
import repro_torch.serving as pserving
import repro_torch.serving.server as pserver
from repro_torch.configs import get_smoke_config
from repro_torch.core import memcom
from repro_torch.models import transformer as tfm

PKGS = {"repro": jserving, "repro_torch": pserving}


@pytest.fixture(params=sorted(PKGS))
def S(request):
    return PKGS[request.param]


#: GETs go straight to 127.0.0.1, whatever proxy the environment names
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(port, path, timeout=5.0):
    """(status, content_type, body) for a GET against the local server."""
    try:
        with _OPENER.open(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], \
                resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], \
            e.read().decode("utf-8")


class _FakeEngine:
    """The exact read-only surface TelemetryServer touches."""

    def __init__(self, S, *, with_watchdog=False, last_step_t=None):
        self.metrics = S.MetricsRegistry()
        self.metrics.counter("demo_total", "demo").inc(3)
        self.clock = S.VirtualClock()
        self.clock.advance(2.5)
        self.tracer = S.Tracer(clock=self.clock)
        self.tracer.span("engine", "decode_step", 1.0, 1.5)
        self.last_step_t = last_step_t
        self.slots = 2
        self.watchdog = None
        if with_watchdog:
            self.watchdog = S.SLOWatchdog(S.default_rules(),
                                          clock=self.clock,
                                          metrics=self.metrics)

    def stats(self):
        return {"engine": {"decode_steps": 7,
                           "np_scalar": np.int64(4)}}


@pytest.fixture()
def served(S):
    eng = _FakeEngine(S, with_watchdog=True, last_step_t=2.0)
    with S.TelemetryServer(eng, port=0) as srv:
        yield eng, srv


# ---------------------------------------------------------------------------
# tests/test_server.py's cases, on both packages
# ---------------------------------------------------------------------------


def test_metrics_endpoint_prometheus_text(S, served):
    eng, srv = served
    status, ctype, body = _get(srv.bound_port, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    assert "demo_total 3" in body
    # the watchdog registers its counter eagerly: scrapeable pre-alert
    assert "serving_alerts_total" in body



def test_healthz_liveness_on_injected_clock(S, served):
    eng, srv = served
    status, ctype, body = _get(srv.bound_port, "/healthz")
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    assert doc["status"] == "ok"
    assert doc["now"] == pytest.approx(2.5)
    assert doc["last_step_t"] == pytest.approx(2.0)
    assert doc["last_step_age_s"] == pytest.approx(0.5)
    assert doc["slots"] == 2
    assert doc["page_active"] is False and doc["alerts"] == 0



def test_healthz_idle_before_first_step(S):
    eng = _FakeEngine(S, last_step_t=None)
    with S.TelemetryServer(eng, port=0) as srv:
        doc = json.loads(_get(srv.bound_port, "/healthz")[2])
    assert doc["status"] == "idle"
    assert doc["last_step_age_s"] is None
    assert "page_active" not in doc  # no watchdog attached



def test_debug_state_jsonifies_numpy(S, served):
    eng, srv = served
    status, ctype, body = _get(srv.bound_port, "/debug/state")
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    assert doc["engine"]["decode_steps"] == 7
    assert doc["engine"]["np_scalar"] == 4  # .item()'d, not repr'd



def test_debug_trace_is_valid_chrome_trace(S, served):
    eng, srv = served
    status, _, body = _get(srv.bound_port, "/debug/trace")
    assert status == 200
    trace = json.loads(body)
    assert S.validate_chrome_trace(trace, require_spans=("decode_step",)) == []



def test_unknown_route_404_and_post_405(S, served):
    eng, srv = served
    status, _, body = _get(srv.bound_port, "/nope")
    assert status == 404 and "/nope" in body
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.bound_port}/metrics", data=b"x",
        method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _OPENER.open(req, timeout=5)
    assert ei.value.code == 405



def test_route_exception_becomes_500(S):
    eng = _FakeEngine(S)
    eng.stats = lambda: (_ for _ in ()).throw(KeyError("boom"))
    with S.TelemetryServer(eng, port=0) as srv:
        status, _, body = _get(srv.bound_port, "/debug/state")
    assert status == 500 and "KeyError" in body



def test_lifecycle_restart_guard_and_stop_idempotent(S):
    eng = _FakeEngine(S)
    srv = S.TelemetryServer(eng, port=0)
    port = srv.start()
    assert port == srv.bound_port and port > 0
    with pytest.raises(RuntimeError):
        srv.start()
    srv.stop()
    srv.stop()  # idempotent
    # the port is released: a fresh server can bind it again
    srv2 = S.TelemetryServer(eng, port=port)
    assert srv2.start() == port
    srv2.stop()





# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------


class _Untouchable(torch.Tensor):
    """A tensor whose values must not be read (as a CUDA tensor's must
    not be from the server's thread)."""

    def item(self):
        raise AssertionError("read a tensor's value")

    def tolist(self):
        raise AssertionError("read a tensor's values")

    def __repr__(self):
        raise AssertionError("repr reads a tensor's values")


def test_the_encoder_never_reads_a_tensor():
    t = torch.Tensor._make_subclass(_Untouchable, torch.zeros(2, 3))
    out = json.loads(json.dumps({"t": t, "n": np.float32(0.5),
                                 "i": np.int64(4)},
                                default=pserver._jsonable))
    assert out["n"] == 0.5 and out["i"] == 4
    assert "(2, 3)" in out["t"] and "cpu" in out["t"]


def test_both_packages_serve_the_same_bytes():
    bodies = {}
    for name, S in PKGS.items():
        eng = _FakeEngine(S, with_watchdog=True, last_step_t=2.0)
        with S.TelemetryServer(eng, port=0) as srv:
            bodies[name] = [_get(srv.bound_port, path)
                            for path in ("/metrics", "/healthz",
                                         "/debug/state", "/debug/trace",
                                         "/nope")]
    assert bodies["repro_torch"] == bodies["repro"]
    assert pserver._STATUS_TEXT == jserver._STATUS_TEXT


@pytest.fixture(scope="module")
def port_models():
    cfg = get_smoke_config("smollm-135m")
    target = tfm.init_params(cfg, 0, device="cpu")
    return cfg, target, memcom.init_memcom(cfg, target, 1)


def _serve(models, disk_dir, server=False, scrapes=None):
    """The churn scenario of ``tests/test_traffic.py`` on the port engine
    with a tracer, a registry and a watchdog; with ``server`` every route
    is scraped from this thread while another one serves."""
    cfg, target, mc = models
    m = cfg.memcom.num_memory_tokens
    trace = pserving.generate_trace(
        pserving.TrafficConfig(num_tasks=5, num_requests=12,
                               context_tokens=24, rate_rps=300.0,
                               priority_classes=2), seed=0)
    reqs = [pserving.Request(tokens=r.tokens, max_new=r.max_new,
                             raw_shots=r.raw_shots, priority=r.priority,
                             arrival_s=r.arrival_s, uid=i)
            for i, r in enumerate(trace.requests)]
    eng = pserving.ServingEngine(
        cfg, target, slots=2, max_len=m + 32, compressor=mc, device="cpu",
        compile_token_budget=8, prefix_capacity=2, host_capacity=2,
        disk_dir=str(disk_dir), promote_layer_budget=1,
        clock=pserving.VirtualClock(), priority_aging_s=0.05,
        tracer=pserving.Tracer(), metrics=pserving.MetricsRegistry(),
        watchdog=pserving.SLOWatchdog(pserving.default_rules(),
                                      metrics=None))
    if not server:
        out = eng.serve(reqs)
        return [out[r.uid].tolist() for r in reqs]
    with pserving.TelemetryServer(eng, port=0) as srv:
        box = {}

        def _run():
            box["out"] = eng.serve(reqs)

        t = threading.Thread(target=_run)
        t.start()
        while t.is_alive():
            for path in ("/healthz", "/metrics", "/debug/state",
                         "/debug/trace"):
                scrapes.append((path, _get(srv.bound_port, path)[0]))
        t.join()
        doc = json.loads(_get(srv.bound_port, "/debug/state")[2])
        assert doc["engine"]["decode_steps"] > 0
        trace_doc = json.loads(_get(srv.bound_port, "/debug/trace")[2])
        assert pserving.validate_chrome_trace(
            trace_doc, require_spans=("decode_step", "admission")) == []
    return [box["out"][r.uid].tolist() for r in reqs]


def test_live_scrape_does_not_perturb_tokens(port_models, tmp_path):
    plain = _serve(port_models, tmp_path / "plain")
    scrapes = []
    scraped = _serve(port_models, tmp_path / "scraped", server=True,
                     scrapes=scrapes)
    assert scraped == plain
    assert scrapes and all(s == 200 for _, s in scrapes)


def test_launcher_serves_http_and_bounds_the_flight_recorder(tmp_path,
                                                             capsys):
    """``--http-port 0`` binds a free port for the serve (printed) and
    stops it after; ``--flight-recorder N`` keeps the last N events in
    the ``--trace-out`` file; ``--metrics-out`` writes the registry."""
    from repro_torch.launch import serve

    trace_path = tmp_path / "t" / "trace.json"
    prom_path = tmp_path / "m" / "metrics.prom"
    serve.main(["--arch", "smollm-135m", "--smoke", "--requests", "3",
                "--tasks", "2", "--slots", "2", "--max-new", "4",
                "--http-port", "0", "--flight-recorder", "8",
                "--trace-out", str(trace_path), "--metrics-out",
                str(prom_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[edge] http telemetry on 127.0.0.1:" in out
    trace = json.loads(trace_path.read_text())
    assert pserving.validate_chrome_trace(trace) == []
    assert len([e for e in trace["traceEvents"] if e["ph"] != "M"]) == 8
    assert trace["otherData"]["dropped_events"] > 0
    assert "serving_engine_decode_steps" in prom_path.read_text()
    assert not [t for t in threading.enumerate()
                if t.name == "telemetry-http"]
