"""The port engine's observability against the JAX engine's, on the CPU.

One scenario, ``tests/test_traffic.py``'s churn (5 raw-shot tasks over 2
HBM prefixes, 2 host rows and a disk tier, compiles of 8 tokens a step,
promotions of 1 layer a step, two priority classes with aging), on
smollm-135m-smoke with the JAX weights carried across by ``bridge``, on a
``VirtualClock``, with a ``Tracer``, a ``MetricsRegistry`` and an
``SLOWatchdog`` whose SLOs are tight enough that page alerts fire and
``ShedDegrade`` sheds admissions.  In each engine mode (dense and paged,
classic, fused and fused with self-speculation) both engines give the
same tokens, and byte-equal ``Tracer.dumps()``, ``render_prometheus()``
and ``SLOWatchdog.dumps()``.  On the port alone: two runs of one seed
are byte-identical, the tracer on and off give identical tokens, and
``stats()`` and the tracer's events hold host values only.
"""

import json

import jax
import numpy as np
import pytest
import torch

import repro.serving as J
from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch import serving as P
from repro_torch.configs import get_smoke_config as port_smoke_config

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist

CHURN = dict(num_tasks=5, num_requests=12, context_tokens=24, rate_rps=300.0,
             priority_classes=2)

MODES = {
    "dense": {},
    "paged": dict(kv_layout="paged", block_size=4),
    "fused": dict(fused_step=True, fused_chunk_tokens=4),
    "paged_fused_spec": dict(kv_layout="paged", block_size=4,
                             fused_step=True, fused_chunk_tokens=4,
                             spec_draft="self", spec_k=2),
}


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config("smollm-135m")
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config("smollm-135m")
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    comp = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                  device="cpu")
    return {J: (cfg, params, mc), P: (pcfg, target, comp)}


def run(S, models, disk_dir, mode, *, traced=True, watched=True, seed=0):
    """One churn serve on package ``S``'s engine (``S`` is ``repro.serving``
    or ``repro_torch.serving``).  Returns (engine, tokens in trace order,
    tracer, registry, watchdog)."""
    cfg, target, comp = models[S]
    tracer = S.Tracer() if traced else None
    reg = S.MetricsRegistry()
    wd = (S.SLOWatchdog(S.default_rules(slo_ttft_s=0.0005, slo_gap_s=0.0005),
                        metrics=reg, tracer=tracer,
                        degrade_hook=S.ShedDegrade())
          if watched else None)
    kw = dict(slots=2, max_len=cfg.memcom.num_memory_tokens + 32,
              compressor=comp, compile_token_budget=8, prefix_capacity=2,
              host_capacity=2, disk_dir=str(disk_dir), promote_layer_budget=1,
              clock=S.VirtualClock(), priority_aging_s=0.05, tracer=tracer,
              metrics=reg, watchdog=wd, **MODES[mode])
    if S is P:
        kw["device"] = "cpu"
    eng = S.ServingEngine(cfg, target, **kw)
    trace = S.generate_trace(S.TrafficConfig(**CHURN), seed)
    # uids seed the sampling streams and come from per-package counters
    reqs = [S.Request(tokens=r.tokens, max_new=r.max_new,
                      raw_shots=r.raw_shots, priority=r.priority,
                      arrival_s=r.arrival_s, uid=i)
            for i, r in enumerate(trace.requests)]
    out = eng.serve(reqs)
    return eng, [list(map(int, out[r.uid])) for r in reqs], tracer, reg, wd


def _host_only(x, where="stats"):
    """Walk a stats tree / event list: Python numbers, strings, lists,
    tuples and dicts only (numpy scalars and arrays, tensors are not)."""
    if isinstance(x, dict):
        for k, v in x.items():
            assert isinstance(k, str), (where, k)
            _host_only(v, f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _host_only(v, f"{where}[{i}]")
    else:
        assert x is None or type(x) in (bool, int, float, str), \
            (where, type(x))
        assert not torch.is_tensor(x)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_engine_telemetry_is_byte_equal_to_the_jax_engine_s(
        models, tmp_path, mode):
    je, jtok, jtr, jreg, jwd = run(J, models, tmp_path / "jax", mode)
    pe, ptok, ptr, preg, pwd = run(P, models, tmp_path / "port", mode)
    assert ptok == jtok
    assert pe.trace == je.trace and pe.request_log == je.request_log
    assert ptr.dumps() == jtr.dumps()
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert pwd.dumps() == jwd.dumps()
    # page alerts fired and the hook shed admissions while they held
    pages = [e for e in pwd.alert_log
             if e["kind"] == "fire" and e["severity"] == "page"]
    assert pages
    assert 'serving_degradations_total{action="shed"}' in \
        preg.render_prometheus()
    trace = json.loads(ptr.dumps())
    step = "fused_step" if "fused" in mode else "decode_step"
    assert P.validate_chrome_trace(trace, require_spans=(
        "admission", "waiting_on_prefix", "compile_chunk", step)) == []
    report = P.profile_spans(trace)
    assert P.validate_profile_report(report) == []
    assert json.dumps(report, sort_keys=True) == json.dumps(
        J.profile_spans(json.loads(jtr.dumps())), sort_keys=True)
    if "spec" in mode:
        assert report["counts"]["spec_accepts"] > 0
    st = pe.stats()
    assert {k: v for k, v in st.items() if k != "engine"} == {
        k: v for k, v in je.stats().items() if k != "engine"}
    _host_only(st)
    _host_only(ptr.events(), "events")
    # reset_stats zeroes the engine, store, compiler and tier counters,
    # the gap samples and the autotuner's window, as the reference's
    # does, and leaves the step functions' counts and the live budgets
    for eng in (je, pe):
        eng.reset_stats()
        assert eng.gap_samples == [] and eng._gap_window == []
    assert preg.render_prometheus() == jreg.render_prometheus()
    st = pe.stats()
    assert st["engine"]["decode_steps"] == 0 and not any(
        st["compiler"].values())
    assert st["engine"]["jit_compiles"] == je.stats()["engine"][
        "jit_compiles"] != {}


@pytest.mark.parametrize("mode", ["dense", "paged_fused_spec"])
def test_two_runs_of_one_seed_are_byte_identical(models, tmp_path, mode):
    a = run(P, models, tmp_path / "a", mode)
    b = run(P, models, tmp_path / "b", mode)
    assert a[1] == b[1]
    assert a[2].dumps() == b[2].dumps()
    assert a[3].render_prometheus() == b[3].render_prometheus()
    assert a[4].dumps() == b[4].dumps()
    assert a[2].dumps() != run(P, models, tmp_path / "c", mode,
                               seed=1)[2].dumps()


@pytest.mark.parametrize("watched", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tracer_on_and_off_give_identical_tokens(models, tmp_path, mode,
                                                 watched):
    on = run(P, models, tmp_path / "on", mode, watched=watched)
    off = run(P, models, tmp_path / "off", mode, traced=False,
              watched=watched)
    assert on[1] == off[1]
    assert on[0].trace == off[0].trace
    assert on[3].render_prometheus() == off[3].render_prometheus()
    assert off[0].tracer is P.telemetry.NULL_TRACER
    if mode == "dense" and not watched:
        # unshed, the churn covers the whole span taxonomy
        assert P.validate_chrome_trace(
            on[2].chrome_trace(),
            require_spans=P.telemetry.REQUIRED_SPANS) == []


def test_stats_is_a_deep_copy_of_host_values(models):
    """Mutating what ``stats()`` returned leaves the registry alone; the
    tree is host values in every engine mode."""
    cfg, target, _ = models[P]
    for mode in MODES:
        kw = {k: v for k, v in MODES[mode].items()}
        eng = P.ServingEngine(cfg, target, slots=2,
                              max_len=cfg.memcom.num_memory_tokens + 32,
                              device="cpu", clock=P.VirtualClock(), **kw)
        eng.serve([P.Request(tokens=np.array([5, 6, 7], np.int32),
                             max_new=4)])
        s1 = eng.stats()
        _host_only(s1)
        golden = json.dumps(s1, sort_keys=True)
        s1["engine"]["decode_steps"] = -999
        s1["budgets"]["compile_token_budget"] = -1
        s1["prefix_store"].clear()
        assert json.dumps(eng.stats(), sort_keys=True) == golden
