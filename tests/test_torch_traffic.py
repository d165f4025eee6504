"""The port's traffic harness against the JAX package's, on the CPU.

* ``generate_trace``: the same ``(TrafficConfig, seed)`` gives the same
  catalog, task picks, arrival times, prompts, budgets and priorities in
  both packages, byte for byte, for Poisson and ON-OFF arrivals and
  several seeds;
* ``slo_metrics`` and ``Histogram`` (its percentiles, snapshot and text
  exposition) give the same numbers on one log;
* the launchers' ``--fused-step``, ``--spec-draft`` / ``--spec-k``,
  ``--traffic`` and ``--stats`` flags and their checks, the traffic mode
  with the SLO watchdog firing page alerts and shedding admissions (the
  same alert log and byte-equal ``--trace-out`` / ``--metrics-out``
  files), and the checks of the observability and autotuner flags;
* the churn scenario of ``tests/test_traffic.py`` (5 tasks over 2 HBM
  prefixes, 2 host rows and a disk tier, online compiles of 8 tokens a
  step, two priority classes with aging) served by both engines on a
  ``VirtualClock``, in the classic loop and with the fused step: the same
  tokens, ``request_log``, ``trace``, engine counters and SLO JSON.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import TrafficConfig as JTrafficConfig
from repro.serving import generate_trace as jgenerate_trace
from repro.serving import slo_metrics as jslo_metrics
from repro.serving.clock import VirtualClock as JClock
from repro.serving.telemetry import Histogram as JHistogram
from repro.serving.traffic import zipf_weights as jzipf_weights
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.serving import (Histogram, Request, ServingEngine,
                                 TrafficConfig, VirtualClock, generate_trace,
                                 slo_metrics)
from repro_torch.serving.traffic import zipf_weights

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist

#: tests/test_traffic.py's churn scenario: the catalog (5 tasks) exceeds
#: prefix_capacity (2) and host_capacity (2), so demotes, spills,
#: promotions and online compiles all fire, at a rate that queues
CHURN = dict(num_tasks=5, num_requests=12, context_tokens=24, rate_rps=300.0,
             priority_classes=2)


def _fingerprint(trace):
    return ([c.tobytes() for c in trace.catalog], trace.task_ids,
            [(r.arrival_s, r.tokens.tobytes(), r.max_new, r.priority,
              r.raw_shots.tobytes(), r.prefix) for r in trace.requests])


@pytest.mark.parametrize("seed", [0, 7, 31])
@pytest.mark.parametrize("process", ["poisson", "onoff"])
def test_generate_trace_matches_jax(process, seed):
    kw = dict(num_tasks=4, num_requests=20, context_tokens=16,
              process=process, priority_classes=2,
              priority_weights=(0.3, 0.7))
    want = jgenerate_trace(JTrafficConfig(**kw), seed)
    got = generate_trace(TrafficConfig(**kw), seed)
    assert _fingerprint(got) == _fingerprint(want)
    assert _fingerprint(got) != _fingerprint(
        generate_trace(TrafficConfig(**kw), seed + 1))
    np.testing.assert_array_equal(zipf_weights(8, 1.2),
                                  jzipf_weights(8, 1.2))


def test_traffic_config_checks_match_jax():
    for bad in (dict(process="burst"), dict(num_tasks=0), dict(rate_rps=0),
                dict(zipf_alpha=0), dict(context_tokens=3),
                dict(priority_classes=0),
                dict(priority_classes=2, priority_weights=(1.0,))):
        with pytest.raises(ValueError) as want:
            JTrafficConfig(**bad)
        with pytest.raises(ValueError) as got:
            TrafficConfig(**bad)
        assert str(got.value) == str(want.value)


def test_slo_metrics_and_histogram_match_jax():
    """One log with unfinished requests, two classes and preemptions, and
    gap samples across the buckets (and past the last): the same
    scoreboard, and the same histogram percentiles, snapshot and text."""
    rng = np.random.default_rng(4)
    log = {}
    for uid in range(30):
        arrival = float(rng.uniform(0, 0.5))
        done = uid % 7 != 3
        first = arrival + float(rng.exponential(0.01))
        log[uid] = {"priority": uid % 2, "arrival_s": arrival,
                    "first_token_s": first if done else None,
                    "finish_s": first + float(rng.exponential(0.05))
                    if done else None,
                    "tokens": int(rng.integers(1, 9)) if done else 0,
                    "preemptions": int(rng.integers(0, 2))}
    gaps = list(rng.exponential(3e-3, 200)) + [12.0, 0.0]
    for kw in (dict(slo_ttft_s=0.02), dict(slo_ttft_s=0.005, devices=4)):
        want = jslo_metrics(log, gap_samples=gaps, **kw)
        got = slo_metrics(log, gap_samples=gaps, **kw)
        assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                             sort_keys=True)
    assert slo_metrics({}, slo_ttft_s=0.02) == jslo_metrics({},
                                                            slo_ttft_s=0.02)
    h, jh = Histogram("gap", labelnames=("k",)), JHistogram(
        "gap", labelnames=("k",))
    for g in gaps:
        h.observe(g, k="a")
        jh.observe(g, k="a")
    for p in (0, 1, 25, 50, 90, 95, 99, 100):
        assert h.percentile(p, k="a") == jh.percentile(p, k="a")
    assert h.snapshot(k="a") == jh.snapshot(k="a")
    assert h.render() == jh.render()
    assert Histogram("one", buckets=(0.1,)).percentile(50) == 0.0
    with pytest.raises(ValueError, match="strictly increasing"):
        Histogram("bad", buckets=(1.0, 1.0))


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("smollm-135m")
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config("smollm-135m")
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    comp = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                  device="cpu")
    return dict(cfg=cfg, params=params, mc=mc, pcfg=pcfg, target=target,
                comp=comp)


def _churn_kw(cfg, disk_dir, fused):
    kw = dict(slots=2, max_len=cfg.memcom.num_memory_tokens + 32,
              compile_token_budget=8, prefix_capacity=2, host_capacity=2,
              disk_dir=str(disk_dir), promote_layer_budget=1,
              priority_aging_s=0.05)
    if fused:
        kw.update(fused_step=True, fused_chunk_tokens=4)
    return kw


def _with_uids(trace, cls):
    """The trace's requests as ``cls`` instances with uids 0..n-1 (uids
    come from a per-package counter and seed the sampling streams)."""
    return [cls(tokens=r.tokens, max_new=r.max_new, raw_shots=r.raw_shots,
                priority=r.priority, arrival_s=r.arrival_s, uid=i)
            for i, r in enumerate(trace.requests)]


@pytest.mark.parametrize("fused", [False, True])
def test_churn_simulation_matches_jax(setup, tmp_path, fused):
    """tests/test_traffic.py:44-68's scenario through both engines."""
    s = setup
    seed = 0
    j = JaxEngine(s["cfg"], s["params"], compressor=s["mc"], clock=JClock(),
                  **_churn_kw(s["cfg"], tmp_path / "jax", fused))
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      compressor=s["comp"], clock=VirtualClock(),
                      **_churn_kw(s["pcfg"], tmp_path / "port", fused))
    want = j.serve(_with_uids(jgenerate_trace(JTrafficConfig(**CHURN), seed),
                              JRequest))
    got = p.serve(_with_uids(generate_trace(TrafficConfig(**CHURN), seed),
                             Request))
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.request_log == j.request_log
    assert p.trace == j.trace
    jst, pst = j.stats(), p.stats()
    assert {k: jst["engine"][k] for k in pst["engine"]} == pst["engine"]
    for key in ("prefix_store", "compiler", "prefix_tiers"):
        assert pst[key] == jst[key], key
    slo = [json.dumps(fn(e.request_log, slo_ttft_s=0.02,
                         gap_samples=e.gap_samples), sort_keys=True)
           for fn, e in ((jslo_metrics, j), (slo_metrics, p))]
    assert slo[0] == slo[1]
    t = pst["prefix_tiers"]
    assert t["demotes"] > 0 and pst["compiler"]["jobs"] > 0
    assert all(e["finish_s"] is not None for e in p.request_log.values())
    if fused:
        assert pst["engine"]["fused_steps"] > 0


# ---------------------------------------------------------------------------
# The launchers' fused, speculative and traffic flags
# ---------------------------------------------------------------------------


def _launch_both(monkeypatch, argv, port_argv=None):
    """Run the JAX launcher (which parses ``sys.argv`` and returns nothing)
    and the port's on the same seeded parameters: the port's models are
    the JAX ones carried across by ``bridge``, seed for seed (the drafter
    of ``--spec-draft ARCH`` comes from seed 1).  ``port_argv`` replaces
    ``argv`` for the port (other output paths).  Returns (the JAX
    engine's tokens per request in order, its SLO watchdog or None, the
    port launcher's metrics)."""
    from repro.data import SyntheticVocab as JVocab
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    size = JVocab().size
    jcfgs = {}
    for arch in {argv[argv.index("--arch") + 1]} | (
            {argv[argv.index("--spec-draft") + 1]} - {"self"}
            if "--spec-draft" in argv else set()):
        jcfg = get_smoke_config(arch).replace(vocab_size=size)
        jcfgs[jcfg.name] = jcfg
    mcs = {}

    def init_params(cfg, seed, device):
        jp = jtfm.init_params(jcfgs[cfg.name], seed)
        return bridge.from_jax_params(cfg, jax.tree.map(np.asarray, jp),
                                      device=device)

    def init_memcom(cfg, target, seed):
        jcfg = jcfgs[cfg.name]
        mc = mcs.setdefault(cfg.name, jmc.init_memcom(
            jcfg, jtfm.init_params(jcfg, 0), seed))
        return bridge.from_jax_memcom(cfg, jax.tree.map(np.asarray, mc),
                                      device=target.device)

    monkeypatch.setattr(serve.tfm, "init_params", init_params)
    monkeypatch.setattr(serve.memcom, "init_memcom", init_memcom)
    want, watchdogs = [], []
    real_serve = JaxEngine.serve

    def spy(self, requests, **kw):
        requests = list(requests)
        out = real_serve(self, requests, **kw)
        want.extend(out[r.uid].tolist() for r in requests)
        watchdogs.append(self.watchdog)
        return out

    monkeypatch.setattr(JaxEngine, "serve", spy)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    metrics = serve.main((argv if port_argv is None else port_argv)
                         + ["--device", "cpu"])
    return want, watchdogs[0], metrics


@pytest.mark.parametrize("draft", ["self", "smollm-135m"])
def test_launcher_fused_speculative_matches_jax(monkeypatch, capsys, draft):
    """``--fused-step --spec-draft ... --spec-k 2 --stats``: the JAX
    launcher's tokens and engine counts."""
    argv = ["--arch", "smollm-135m", "--smoke", "--requests", "5",
            "--tasks", "2", "--slots", "2", "--max-new", "6", "--fused-step",
            "--fused-chunk-tokens", "4", "--spec-draft", draft, "--spec-k",
            "2", "--stats"]
    want, _, metrics = _launch_both(monkeypatch, argv)
    assert metrics["tokens"] == want
    out = capsys.readouterr().out
    jstats = json.loads(out[out.index("[stats]") + 8:].split("\n[", 1)[0]
                        .split("\n[cloud]", 1)[0])
    # the counts; a launch without --traffic runs on the wall clock
    pstats = {k: v for k, v in metrics["stats"]["engine"].items()
              if not k.endswith("_s")}
    assert pstats == {k: jstats["engine"][k] for k in pstats}
    assert pstats["spec_rounds"] > 0
    assert metrics["stats"]["fused"] == jstats["fused"]


@pytest.mark.parametrize("process", ["zipf", "onoff"])
def test_launcher_traffic_matches_jax(monkeypatch, capsys, tmp_path,
                                      process):
    """``--traffic`` on the virtual clock, with both launchers' SLO
    watchdogs firing page alerts (a TTFT SLO of 2 ms) and shedding
    admissions while they hold: the JAX launcher's tokens, alert log and
    SLO numbers, and byte-equal ``--trace-out`` and ``--metrics-out``
    files."""
    argv = ["--arch", "smollm-135m", "--smoke", "--traffic", process,
            "--traffic-requests", "8", "--traffic-tasks", "3",
            "--traffic-rate", "100", "--context-tokens", "24",
            "--slo-ttft", "0.002", "--fused-step", "--seed", "3"]

    def files(d):
        return ["--trace-out", str(d / "trace.json"), "--metrics-out",
                str(d / "metrics.prom")]

    want, jwd, metrics = _launch_both(
        monkeypatch, argv + files(tmp_path / "jax"),
        argv + files(tmp_path / "port"))
    pages = [e for e in jwd.alert_log
             if e["kind"] == "fire" and e["severity"] == "page"]
    assert pages
    assert "serving_degradations_total" in jwd.engine.metrics.names()
    assert metrics["traffic"]["tokens"] == want
    assert metrics["traffic"]["completed"] == 8
    assert json.dumps(metrics["traffic"]["alerts"], sort_keys=True,
                      separators=(",", ":")) == jwd.dumps()
    for name in ("trace.json", "metrics.prom"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    out = capsys.readouterr().out
    jline = [ln for ln in out.splitlines() if "completed," in ln]
    assert len(jline) == 2 and jline[0].split("simulated")[0] \
        == jline[1].split("simulated")[0]
    wline = [ln for ln in out.splitlines() if "[edge] watchdog:" in ln]
    assert len(wline) == 2 and wline[0] == wline[1]


def test_launcher_flag_checks_match_jax(monkeypatch, capsys):
    """The new flags' ``ap.error`` checks: the JAX launcher's messages (up
    to the list of arch ids, which names the port's own configs)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    base = ["--arch", "smollm-135m", "--smoke"]
    for bad in (["--spec-k", "2"], ["--spec-draft", "self"],
                ["--spec-draft", "self", "--spec-k", "2"],
                ["--fused-step", "--fused-chunk-tokens", "0"],
                ["--fused-step", "--spec-draft", "gpt9", "--spec-k", "1"],
["--traffic", "zipf", "--raw-shots"],
                ["--traffic", "onoff", "--classify"],
                # the observability and autotuner flags
                ["--flight-recorder", "0"],
                ["--autotune-budgets"],
                ["--autotune-budgets", "--target-gap", "0.01"],
                ["--http-port", "-1"],
                ["--http-linger", "-1"],
                ["--http-linger", "2"]):
        monkeypatch.setattr(sys, "argv", ["serve"] + base + bad)
        with pytest.raises(SystemExit):
            jserve.main()
        want = capsys.readouterr().err.strip().splitlines()[-1]
        with pytest.raises(SystemExit):
            serve.main(base + bad + ["--device", "cpu"])
        got = capsys.readouterr().err.strip().splitlines()[-1]
        # the arch lists differ: the port has fewer configs
        assert got.split(" one of ")[0] == want.split(" one of ")[0], bad
