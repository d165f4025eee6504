"""The port's fused serving step and speculative decoding against the JAX
engine's, on the CPU.

Both packages run in one process on the same seeded inputs, the port on
parameters carried across by ``repro_torch.bridge`` and its plain kernels.
Each serving case runs the same requests (explicit uids) through both
engines on a ``VirtualClock`` and requires identical tokens, ``trace``
(admit / join / fused / join_done / decode events), ``request_log`` and
``stats()["engine"]`` (every key, the budget autotuner's two counters
and ``jit_compiles`` included).  The cases mirror
``tests/test_spec_decode.py``: chunked joins, self-speculation (accept
rate 1.0), a cross drafter (seed 123), sampled acceptance at temperature
0.05, ``block_size=4, spec_k=3`` rollbacks across block boundaries, token
conservation over seeded chunk schedules, the per-family compile counts
and a replay that adds none; and beyond it: the fused compile lane (the
compiled O^i within 1e-4 of the offline compress), granite-moe-smoke's
fused lanes (the MoE capacity counts every lane) and mamba2-smoke's
refusal.  Below the engine: ``paged_scatter(valid=)`` (trash routing, the
table column clamp) and ``scatter_rows(valid=)`` near the stripe's end
against the JAX functions, and a decode forward of W lanes with
``lane_valid`` within 1e-4 of the JAX logits and cache (gemma2-2b-smoke
with its softcap, mistral-7b-smoke).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.kernels import jnp_impl
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix)

TOL = 1e-4
PROMPT_LENS = (5, 11, 8, 3, 7, 9)
MAX_NEW = 6
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


def _port(pcfg, jparams):
    return bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")


_SETUPS = {}


def _setup(arch="smollm-135m"):
    if arch not in _SETUPS:
        cfg = get_smoke_config(arch)
        pcfg = port_smoke_config(arch)
        params = jtfm.init_params(cfg, 0)
        rng = np.random.default_rng(0)
        _SETUPS[arch] = dict(
            cfg=cfg, pcfg=pcfg, params=params, target=_port(pcfg, params),
            prompts=[rng.integers(4, cfg.vocab_size, n).astype(np.int32)
                     for n in PROMPT_LENS])
    return _SETUPS[arch]


def _drafter(s, seed):
    """A cross drafter of the same config and vocabulary, another seed,
    for both packages."""
    jp = jtfm.init_params(s["cfg"], seed)
    return (s["cfg"], jp), (s["pcfg"], _port(s["pcfg"], jp))


def _engines(s, draft_seed=None, compressors=None, **kw):
    jkw, pkw = dict(kw), dict(kw)
    if draft_seed is not None:
        jkw["spec_draft"], pkw["spec_draft"] = _drafter(s, draft_seed)
    if compressors is not None:
        jkw["compressor"], pkw["compressor"] = compressors
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(), **jkw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), **pkw)
    return j, p


def _specs(s, idx, uid0, stagger=None, **kw):
    return [dict(tokens=s["prompts"][i], max_new=MAX_NEW, uid=uid0 + n,
                 **({} if stagger is None else {"arrival_s": stagger * n}),
                 **kw)
            for n, i in enumerate(idx)]


def _assert_engine_stats(j, p):
    want, got = j.stats()["engine"], p.stats()["engine"]
    assert got == want
    assert p.stats().get("fused") == j.stats().get("fused")
    return got


def _serve_both(j, p, specs):
    """Serve ``specs`` through both engines: tokens, trace, request_log
    and engine counters identical; returns the port's tokens in order."""
    want = j.serve([JRequest(**x) for x in specs])
    got = p.serve([Request(**x) for x in specs])
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace
    assert p.request_log == j.request_log
    _assert_engine_stats(j, p)
    if p.paged:
        assert p.alloc.snapshot() == j.alloc.snapshot()
        np.testing.assert_array_equal(p.tables, j.tables)
    return [got[x["uid"]].tolist() for x in specs]


@pytest.fixture(scope="module")
def ref():
    """The classic engine's greedy tokens per prompt (port), which every
    fused or speculative greedy run must reproduce."""
    s = _setup()
    eng = ServingEngine(s["pcfg"], s["target"], device="cpu",
                        slots=len(PROMPT_LENS), max_len=40)
    reqs = [Request(tokens=p_, max_new=MAX_NEW) for p_ in s["prompts"]]
    out = eng.serve(reqs)
    return [out[r.uid].tolist() for r in reqs]


LAYOUTS = ["dense", "paged"]


# ---------------------------------------------------------------------------
# Serving against the JAX engine (tests/test_spec_decode.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_joins_match_jax(ref, layout):
    """Staggered arrivals into 2 slots: later requests join while others
    decode and stream in 4-token chunks (tests/test_spec_decode.py:63)."""
    s = _setup()
    j, p = _engines(s, slots=2, max_len=40, kv_layout=layout,
                    fused_step=True, fused_chunk_tokens=4)
    idx = [0, 1, 2, 3, 4]
    got = _serve_both(j, p, _specs(s, idx, 100, stagger=0.002))
    assert got == [ref[i] for i in idx]
    es = p.stats()["engine"]
    assert es["fused_prefill_chunks"] > 0
    assert es["fused_prefill_tokens"] == sum(
        e[3] for e in p.trace if e[0] == "join")


@pytest.mark.parametrize("draft", ["self", "cross"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_speculative_matches_jax(ref, layout, draft):
    """Self-speculation accepts every draft; a drafter of another seed
    (123) mostly misses, so its rejected lanes roll back; the greedy
    tokens are the classic engine's either way
    (tests/test_spec_decode.py:79, :96)."""
    s = _setup()
    kw = (dict(spec_draft="self") if draft == "self"
          else dict(draft_seed=123))
    j, p = _engines(s, slots=2, max_len=40, kv_layout=layout,
                    fused_step=True, spec_k=2, **kw)
    idx = [0, 1, 2]
    assert _serve_both(j, p, _specs(s, idx, 200)) == [ref[i] for i in idx]
    es = p.stats()["engine"]
    assert es["draft_proposed"] > 0
    if draft == "self":
        assert es["accept_rate"] == 1.0
    else:
        assert es["draft_accepted"] < es["draft_proposed"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sampled_acceptance_matches_jax(layout):
    """Leviathan acceptance at temperature 0.05 on each request's own
    stream: the JAX engine's tokens and counters
    (tests/test_spec_decode.py:112)."""
    s = _setup()
    j, p = _engines(s, slots=2, max_len=40, kv_layout=layout,
                    fused_step=True, spec_draft="self", spec_k=2)
    got = _serve_both(j, p, _specs(s, [0, 1, 2], 300, temperature=0.05))
    assert all(len(t) == MAX_NEW for t in got)
    es = p.stats()["engine"]
    assert 0 < es["draft_accepted"] <= es["draft_proposed"]


@pytest.mark.parametrize("draft", ["cross", "self"])
def test_paged_block_boundary_rollback_matches_jax(ref, draft):
    """Blocks of 4 with spec_k = 3: accepted runs straddle block
    boundaries and rejected drafts leave rows in the next block; a
    drafter of seed 7 rolls back at the boundaries, the self drafter
    jumps k + 1 positions a step (tests/test_spec_decode.py:133)."""
    s = _setup()
    kw = (dict(spec_draft="self") if draft == "self"
          else dict(draft_seed=7))
    j, p = _engines(s, slots=2, max_len=40, kv_layout="paged", block_size=4,
                    fused_step=True, spec_k=3, **kw)
    idx = [1, 2, 0, 4]
    assert _serve_both(j, p, _specs(s, idx, 400)) == [ref[i] for i in idx]
    if draft == "self":
        assert p.stats()["engine"]["accept_rate"] == 1.0


_sched = np.random.default_rng(42)
SCHEDULES = [(list(map(int, _sched.integers(0, len(PROMPT_LENS), size=n))),
              int(_sched.choice([2, 4])), float(_sched.choice([0.0005, 0.002])),
              int(_sched.choice([0, 2])))
             for n in (3, 4, 5, 4)]


@pytest.mark.parametrize("idx,chunk,stagger,spec_k", SCHEDULES)
def test_token_conservation_matches_jax(ref, idx, chunk, stagger, spec_k):
    """Seeded chunk schedules (prompt mix, chunk width, arrival stagger,
    with or without speculation): every request emits max_new tokens,
    the classic engine's, every joined prompt token streams once, and
    the decode counter is the output less the first tokens
    (tests/test_spec_decode.py:163)."""
    s = _setup()
    kw = {} if spec_k == 0 else {"spec_draft": "self", "spec_k": spec_k}
    j, p = _engines(s, slots=2, max_len=40, kv_layout="paged",
                    fused_step=True, fused_chunk_tokens=chunk, **kw)
    got = _serve_both(j, p, _specs(s, idx, 500, stagger=stagger))
    assert got == [ref[i] for i in idx]
    es = p.stats()["engine"]
    assert es["tokens_generated"] == len(idx) * MAX_NEW - len(idx)
    assert es["fused_prefill_tokens"] == sum(
        e[3] for e in p.trace if e[0] == "join")


def test_jit_compiles_per_family_and_replay():
    """Six prompt lengths through a fused, self-speculative engine count
    the JAX engine's compilations per family; replaying the workload
    counts none (tests/test_spec_decode.py:221)."""
    s = _setup()
    j, p = _engines(s, slots=2, max_len=48, fused_step=True,
                    fused_chunk_tokens=4, spec_draft="self", spec_k=2)
    idx = list(range(len(PROMPT_LENS)))
    _serve_both(j, p, _specs(s, idx, 600, stagger=0.002))
    jc = p.stats()["engine"]["jit_compiles"]
    assert jc == j.stats()["engine"]["jit_compiles"]
    assert jc.get("fused", 0) <= 2 and jc.get("draft", 0) <= 1
    assert sum(jc.values()) <= 12
    _serve_both(j, p, _specs(s, idx, 700, stagger=0.002))
    assert p.stats()["engine"]["jit_compiles"] == jc
    p.reset_stats()
    assert p.stats()["engine"]["jit_compiles"] == jc
    assert p.stats()["engine"]["decode_steps"] == 0 and not p.gap_samples


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_compile_lane_matches_jax(layout, monkeypatch):
    """A cold task's compile chunks ride the fused steps of a warm task's
    decoding request: the JAX engine's trace, tokens and counters, and
    the compiled O^i within 1e-4 of the offline compress."""
    s = _setup("gemma2-2b")
    mc = jmc.init_memcom(s["cfg"], s["params"], 1)
    comp = bridge.from_jax_memcom(s["pcfg"], jax.tree.map(np.asarray, mc),
                                  device="cpu")
    rng = np.random.default_rng(31)
    warm, cold = (rng.integers(4, s["cfg"].vocab_size, n).astype(np.int32)
                  for n in (40, 48))
    m = s["cfg"].memcom.num_memory_tokens
    j, p = _engines(s, slots=2, max_len=m + 40, kv_layout=layout,
                    compile_token_budget=16, fused_step=True,
                    compressors=(mc, comp))
    j.add_prefix("A", jmaterialize(s["params"], s["cfg"], jmc.compress(
        mc, s["cfg"], jnp.asarray(warm[None]))[0]))
    p.add_prefix("A", materialize_prefix(s["target"], s["pcfg"],
                                         memcom.compress(
                                             comp, s["pcfg"],
                                             torch.as_tensor(warm[None]))[0]))
    omegas = []
    finish = memcom.finish_compress

    def spy(*a, **k):
        out = finish(*a, **k)
        omegas.append(out[0])
        return out

    monkeypatch.setattr(memcom, "finish_compress", spy)
    prompt = s["prompts"][0]
    _serve_both(j, p, [dict(tokens=prompt, max_new=20, prefix="A", uid=800),
                       dict(tokens=prompt, max_new=3, raw_shots=cold,
                            uid=801)])
    es = p.stats()["engine"]
    assert es["fused_compile_chunks"] == 3  # 48 tokens in 16-token chunks
    assert p.stats()["compiler"] == j.stats()["compiler"]
    offline, _ = memcom.compress(comp, s["pcfg"], torch.as_tensor(cold[None]))
    assert len(omegas) == 1
    for got, want in zip(omegas[0], offline):
        np.testing.assert_allclose(got["h"].numpy(), want["h"].numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_fused_lanes_match_jax(layout):
    """granite-moe-smoke is lane-capable: its fused and speculative lanes
    compete for expert capacity, padding lanes included, as the JAX
    lanes do."""
    s = _setup("granite-moe-3b-a800m")
    j, p = _engines(s, slots=2, max_len=40, kv_layout=layout,
                    fused_step=True, fused_chunk_tokens=4,
                    spec_draft="self", spec_k=2)
    got = _serve_both(j, p, _specs(s, [0, 1, 2, 3], 900, stagger=0.002))
    assert all(len(t) == MAX_NEW for t in got)
    assert p.stats()["engine"]["fused_prefill_chunks"] > 0


def test_mamba2_refuses_the_fused_step():
    """A recurrent config cannot absorb padding lanes: both engines raise
    the same error, for the fused step and for a drafter."""
    s = _setup("mamba2-370m")
    for kw in (dict(fused_step=True),
               dict(fused_step=True, spec_draft="self", spec_k=2)):
        with pytest.raises(ValueError) as want:
            JaxEngine(s["cfg"], s["params"], slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            ServingEngine(s["pcfg"], s["target"], device="cpu", slots=2,
                          max_len=32, **kw)
        assert str(got.value) == str(want.value)
    t = _setup()
    for kw in (dict(spec_k=2), dict(spec_draft="self", spec_k=2),
               dict(fused_step=True, fused_chunk_tokens=0)):
        with pytest.raises(ValueError) as want:
            JaxEngine(t["cfg"], t["params"], slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            ServingEngine(t["pcfg"], t["target"], device="cpu", slots=2,
                          max_len=32, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The masked cache writes and the W-lane decode forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["trash", "column_clamp"])
def test_paged_scatter_valid_matches_jnp(case):
    """``trash``: slot 0 writes 3 of 4 lanes across a block boundary, slot
    1 none; the invalid lanes land in block 0 only.  ``column_clamp``:
    one valid lane at the table's last position, the padding lanes past
    the table width must not reach its last column's block
    (tests/test_spec_decode.py:250, :279)."""
    rng = np.random.default_rng(3)
    if case == "trash":
        B, S, bs, nb, H, D = 2, 4, 4, 3, 2, 4
        tables = (np.arange(B * nb).reshape(B, nb) + 1).astype(np.int32)
        starts, valid = [2, 5], [3, 0]
    else:
        B, S, bs, nb, H, D = 1, 4, 2, 2, 1, 2
        tables = np.asarray([[1, 2]], np.int32)
        starts, valid = [3], [1]
    N = B * nb + 1
    pools = [rng.standard_normal((N, bs, H, D)).astype(np.float32)
             for _ in range(2)]
    news = [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2)]
    starts, valid = (np.asarray(x, np.int32) for x in (starts, valid))
    got = ops.paged_scatter([torch.from_numpy(x.copy()) for x in pools],
                            [torch.from_numpy(x) for x in news],
                            torch.from_numpy(tables), torch.from_numpy(starts),
                            valid=torch.from_numpy(valid))
    for g, pool, new in zip(got, pools, news):
        want = np.asarray(jnp_impl.paged_scatter(
            jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
            jnp.asarray(starts), valid=jnp.asarray(valid)))
        # the trash block holds whichever invalid lane came last (the
        # port: the last in lane order, as the reference's CPU scatter);
        # every allocated block must match exactly
        np.testing.assert_array_equal(g.numpy()[1:], want[1:])
        np.testing.assert_array_equal(g.numpy()[0], want[0])
    if case == "column_clamp":
        np.testing.assert_array_equal(got[0].numpy()[1], pools[0][1])
        np.testing.assert_array_equal(got[0].numpy()[2, 1], news[0][0, 0])


@pytest.mark.parametrize("starts,valid", [
    ([6, 8, 0], [3, 2, 0]),    # slot 0's padding lanes cross the end
    ([9, 4, 7], [1, 4, 3]),    # a full window, a lane on the last row
    ([10, 9, 8], [2, 2, 2]),   # valid lanes at and past the end: dropped
])
def test_scatter_rows_valid_matches_jax(starts, valid):
    """The dense masked write near ``max_len``: lanes ``>= valid`` and
    rows ``>= max_len`` dropped, nothing clamped back over valid rows."""
    rng = np.random.default_rng(sum(starts))
    cache = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 4)).astype(np.float32)
    starts, valid = (np.asarray(x, np.int32) for x in (starts, valid))
    want = jattn.scatter_rows(jnp.asarray(cache), jnp.asarray(new),
                              jnp.asarray(starts), valid=jnp.asarray(valid))
    got = attention.scatter_rows(
        torch.from_numpy(cache.copy()), torch.from_numpy(new),
        torch.from_numpy(starts), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ["gemma2-2b", "mistral-7b"])
def test_w_lane_decode_forward_matches_jax(arch, layout):
    """One decode forward of W = 4 lanes over three slots with 3, 1 and 0
    valid lanes behind 9, 13 and 5 seated positions: the valid lanes'
    logits and every cache row within 1e-4 of the JAX forward (the
    trash block aside)."""
    cfg, pcfg = get_smoke_config(arch), port_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    model = _port(pcfg, params)
    rng = np.random.default_rng(11)
    B, W, L, bs = 3, 4, 24, 4
    toks = rng.integers(4, cfg.vocab_size, (B, W)).astype(np.int32)
    starts = np.asarray([9, 13, 5], np.int32)
    valid = np.asarray([3, 1, 0], np.int32)
    kw, pkw = {}, {}
    if layout == "paged":
        nb = L // bs
        tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
        jcache = jtfm.init_paged_cache(cfg, 1 + B * nb, bs, B)
        cache = [{k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in c.items()}
                 for c in bridge.layerwise_to_list(
                     pcfg, jax.tree.map(np.asarray, jcache))]
        kw["block_tables"] = jnp.asarray(tables)
        pkw["block_tables"] = torch.from_numpy(tables)
    else:
        jcache = jtfm.init_cache(cfg, B, L)
        cache = [{k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in c.items()}
                 for c in bridge.layerwise_to_list(
                     pcfg, jax.tree.map(np.asarray, jcache))]
    # fill the caches with the same random rows, so the reads matter
    fills = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in c.items()} for c in cache]
    for c, f in zip(cache, fills):
        for k in c:
            c[k].copy_(torch.from_numpy(f[k]))
    jcache = jax.tree.map(jnp.asarray, bridge.list_to_layerwise(pcfg, fills))
    want, jaux = jtfm.forward(params, cfg, tokens=jnp.asarray(toks),
                              cache=jcache, cache_index=jnp.asarray(starts),
                              decode=True, lane_valid=jnp.asarray(valid),
                              **kw)
    with torch.no_grad():
        got, _ = model(tokens=torch.from_numpy(toks).long(), cache=cache,
                       cache_index=torch.from_numpy(starts), decode=True,
                       lane_valid=torch.from_numpy(valid), **pkw)
    want = np.asarray(want)
    for b in range(B):
        np.testing.assert_allclose(got[b, :valid[b]].numpy(),
                                   want[b, :valid[b]], atol=TOL, rtol=TOL)
    new = bridge.layerwise_to_list(pcfg, jax.tree.map(np.asarray,
                                                     jaux["cache"]))
    first = 1 if layout == "paged" else 0  # block 0 is the trash block
    for g, w in zip(cache, new):
        for k in g:
            np.testing.assert_allclose(g[k].numpy()[first:], w[k][first:],
                                       atol=TOL, rtol=TOL)
