"""The port engine's budget autotuner against the JAX engine's, on the
CPU.

``autotune_budgets=True`` halves the compile and promote budgets while
the mean decode gap of the last ``autotune_interval`` gaps overshoots
``target_decode_gap_s`` (or a page alert hints so) and doubles them back,
up to 8x their configured values, while it undershoots half of it.  On
``tests/test_traffic.py``'s churn scenario (JAX weights carried across by
``bridge``, a ``VirtualClock``), classic and fused, with targets that
shrink and that grow, the port gives the reference's ``("autotune", ...)``
trace entries, live budgets, ``autotune_shrinks`` / ``autotune_grows``,
step-function counts (each compile width of the fused step is a new
geometry key), tokens, Chrome trace and Prometheus text.  The grow cap
(``tests/test_traffic.py:329-346``), the constructor's checks and the
``stats()`` schema (``tests/test_traffic.py:380-425``) are held too.
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

torch.set_num_threads(1)

CHURN = dict(num_tasks=5, num_requests=12, context_tokens=24, rate_rps=300.0,
             priority_classes=2)


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


def _engine(S, models, disk_dir, **kw):
    cfg, target, comp = models[S]
    base = dict(slots=2, max_len=cfg.memcom.num_memory_tokens + 32,
                compressor=comp, compile_token_budget=8, prefix_capacity=2,
                host_capacity=2, disk_dir=str(disk_dir),
                promote_layer_budget=1, clock=S.VirtualClock(),
                priority_aging_s=0.05)
    base.update(kw)
    if S is P:
        base["device"] = "cpu"
    return S.ServingEngine(cfg, target, **base)


def _serve(S, eng, seed=0):
    trace = S.generate_trace(S.TrafficConfig(**CHURN), seed)
    reqs = [S.Request(tokens=r.tokens, max_new=r.max_new,
                      raw_shots=r.raw_shots, priority=r.priority,
                      arrival_s=r.arrival_s, uid=i)
            for i, r in enumerate(trace.requests)]
    out = eng.serve(reqs)
    return [list(map(int, out[r.uid])) for r in reqs]


#: (fused, target gap, interval, watched): the classic loop's compile
#: chunks open gaps of ~1-20 ms on the clock's cost model, so a 1 ms
#: target shrinks (and grows back between compiles); the fused step carries the chunks in its own window, so its gaps
#: stay under any target and only a page alert's hint (a watchdog with
#: SLOs every TTFT misses) shrinks there
CASES = {
    "classic_shrink_grow": (False, 0.001, 2, False),
    "fused_grow": (True, 0.004, 2, False),
    "fused_watched_shrink": (True, 0.004, 4, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autotuner_matches_the_jax_engine(models, tmp_path, case):
    fused, gap, interval, watched = CASES[case]
    kw = dict(autotune_budgets=True, target_decode_gap_s=gap,
              autotune_interval=interval, compile_token_budget=8,
              promote_layer_budget=2)
    if fused:
        kw.update(fused_step=True, fused_chunk_tokens=4)
    out = {}
    for S in (J, P):
        tr, reg = S.Tracer(), S.MetricsRegistry()
        wd = (S.SLOWatchdog(S.default_rules(slo_ttft_s=0.0005),
                            metrics=reg, tracer=tr,
                            degrade_hook=S.ShedDegrade())
              if watched else None)
        eng = _engine(S, models, tmp_path / S.__name__, tracer=tr,
                      metrics=reg, watchdog=wd, **kw)
        out[S] = (_serve(S, eng), eng, tr, reg)
    (jtok, je, jtr, jreg), (ptok, pe, ptr, preg) = out[J], out[P]
    tune = [e for e in pe.trace if e[0] == "autotune"]
    assert tune == [e for e in je.trace if e[0] == "autotune"] != []
    assert ptok == jtok and pe.trace == je.trace
    jst, pst = je.stats(), pe.stats()
    assert pst["budgets"] == jst["budgets"]
    assert pst["budgets"]["autotune"] is True
    for k in ("autotune_shrinks", "autotune_grows", "jit_compiles"):
        assert pst["engine"][k] == jst["engine"][k], k
    assert ptr.dumps() == jtr.dumps()
    assert preg.render_prometheus() == jreg.render_prometheus()
    e = pst["engine"]
    if "shrink" in case:
        assert e["autotune_shrinks"] > 0
    if "grow" in case:
        assert e["autotune_grows"] > 0
    assert pst["budgets"]["compile_token_budget"] <= 8 * 8
    assert len(tune) == e["autotune_shrinks"] + e["autotune_grows"]
    # the tracer's autotune instants are the trace entries
    inst = [ev["args"] for ev in json.loads(ptr.dumps())["traceEvents"]
            if ev.get("name") == "autotune"]
    assert [(a["action"], a["compile_budget"], a["promote_budget"])
            for a in inst] == [t[1:] for t in tune]
    if fused:
        # each compile width that rode a fused step is its own key: the
        # tuned widths add keys the fixed budget would not have
        fixed = _engine(P, models, tmp_path / "fixed", fused_step=True,
                        fused_chunk_tokens=4, compile_token_budget=8,
                        promote_layer_budget=2)
        _serve(P, fixed)
        assert e["jit_compiles"]["fused"] > fixed.stats()["engine"][
            "jit_compiles"]["fused"]


def test_autotune_grow_caps_at_8x_configured(models):
    """tests/test_traffic.py:329-346 on the port: after shrinks put a
    budget off the power-of-two ladder, growth clamps to 8x the
    configured value."""
    cfg, target, _ = models[P]
    m = cfg.memcom.num_memory_tokens
    eng = P.ServingEngine(cfg, target, slots=1, max_len=m + 32, device="cpu",
                          clock=P.VirtualClock(), autotune_budgets=True,
                          target_decode_gap_s=1.0, compile_token_budget=5,
                          promote_layer_budget=3, autotune_interval=1)
    eng.compile_token_budget, eng.promote_layer_budget = 2, 1
    for _ in range(10):
        eng._gap_window[:] = [0.0]
        eng._autotune_step()
    assert eng.compile_token_budget == 5 * 8
    assert eng.promote_layer_budget == 3 * 8
    assert eng.stats()["engine"]["autotune_grows"] == 5


def test_degrade_hint_shrinks_at_a_healthy_gap(models):
    """A page alert's hint counts as an overshoot."""
    cfg, target, _ = models[P]
    eng = P.ServingEngine(cfg, target, slots=1, max_len=40, device="cpu",
                          clock=P.VirtualClock(), autotune_budgets=True,
                          target_decode_gap_s=1.0, compile_token_budget=8,
                          autotune_interval=1)
    eng.degrade_hint = True
    eng._gap_window[:] = [0.0]
    eng._autotune_step()
    assert eng.compile_token_budget == 4
    assert eng.trace == [("autotune", "shrink", 4, None)]


@pytest.mark.parametrize("bad", [
    dict(autotune_budgets=True, compile_token_budget=8),
    dict(autotune_budgets=True, compile_token_budget=8,
         target_decode_gap_s=0.0),
    dict(autotune_budgets=True, target_decode_gap_s=0.01),
    dict(autotune_budgets=True, compile_token_budget=8,
         target_decode_gap_s=0.01, autotune_interval=0),
])
def test_constructor_checks_match_the_jax_engine(models, bad):
    msgs = []
    for S in (J, P):
        cfg, target, _ = models[S]
        kw = dict(device="cpu") if S is P else {}
        with pytest.raises(ValueError) as e:
            S.ServingEngine(cfg, target, slots=1, max_len=40, **kw, **bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


GOLDEN_ENGINE_KEYS = sorted([
    "prefills", "decode_steps", "tokens_generated",
    "decode_steps_during_compile", "compile_chunks_interleaved",
    "decode_steps_during_promote", "promote_steps_interleaved",
    "decode_gap_max_s", "decode_gap_sum_s", "decode_gaps",
    "decode_time_s", "decode_gap_p50_s", "decode_gap_p99_s",
    "preemptions", "preempted_tokens_refilled",
    "autotune_shrinks", "autotune_grows",
    "fused_steps", "fused_chunks", "fused_prefill_chunks",
    "fused_prefill_tokens", "fused_compile_chunks", "spec_rounds",
    "draft_proposed", "draft_accepted", "accept_rate", "jit_compiles",
])


def test_stats_schema_matches_the_reference(models, tmp_path):
    """tests/test_traffic.py's golden ``stats()`` surface for a paged,
    tiered, compiling engine, on the port (the values are held to the
    JAX engine's in tests/test_torch_engine_telemetry.py)."""
    eng = _engine(P, models, tmp_path, kv_layout="paged")
    _serve(P, eng)
    s = eng.stats()
    assert sorted(s) == ["budgets", "compiler", "engine", "pool",
                         "prefix_store", "prefix_tiers"]
    assert sorted(s["engine"]) == GOLDEN_ENGINE_KEYS
    assert sorted(s["prefix_store"]) == sorted(
        ["hits", "misses", "puts", "evictions"])
    assert sorted(s["compiler"]) == sorted(
        ["jobs", "deduped", "chunks", "tokens", "compiled"])
    assert sorted(s["budgets"]) == sorted(
        ["compile_token_budget", "promote_layer_budget", "autotune"])
    assert sorted(s["pool"]) == sorted(
        ["num_blocks", "block_size", "blocks_used", "blocks_free"])
    json.dumps(s)
