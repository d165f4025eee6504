"""The port's online prefix compiler against the JAX package's, on the CPU.

Both packages run in one process on the same seeded inputs, the port on
parameters carried across by ``repro_torch.bridge`` and its plain kernels;
the JAX engine in its classic loop (``fused_step=False``).  Each case
serves the same requests (explicit uids) through both engines on a
``VirtualClock`` and requires identical greedy tokens, ``trace`` (park /
compile / seat / wake / admit / decode events) and ``request_log``:

* an online compile with a budget behind a warm task's decode steps, a
  second request joining it (single-flight), dense and paged, on
  gemma2-2b-smoke, mistral-7b-smoke and smollm-135m;
* the compiler alone: budgeted chunks, job states, a join, install
  bookkeeping, and its materialized rows within 1e-4 of the JAX
  compiler's;
* mid-compile LRU pressure (paged, ``prefix_capacity=1``): the install
  waits until the seated task's request finishes;
* the install's pin ends with the install;
* ``raw_shots`` without a compressor raises the JAX engine's error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import PrefixCompiler as JCompiler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix)
from repro_torch.serving.compiler import PrefixCompiler, pow2_bucket

TOL = 1e-4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


def _pair(arch):
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(arch)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    comp = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                  device="cpu")
    rng = np.random.default_rng(31)
    shots = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 48, 40)]
    prompt = rng.integers(4, cfg.vocab_size, 5).astype(np.int32)
    return dict(cfg=cfg, params=params, mc=mc, pcfg=pcfg, target=target,
                comp=comp, shots=shots, prompt=prompt,
                m=cfg.memcom.num_memory_tokens)


_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        _SETUPS[arch] = _pair(arch)
    return _SETUPS[arch]


def _offline(s, shots):
    """The offline prefix of ``shots`` in both packages."""
    jkv = jmaterialize(s["params"], s["cfg"],
                       jmc.compress(s["mc"], s["cfg"],
                                    jnp.asarray(shots[None]))[0])
    kv = materialize_prefix(s["target"], s["pcfg"], memcom.compress(
        s["comp"], s["pcfg"], torch.as_tensor(shots[None]))[0])
    return jkv, kv


def _engines(s, compressor=True, **kw):
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(),
                  compressor=s["mc"] if compressor else None, **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(),
                      compressor=s["comp"] if compressor else None, **kw)
    return j, p


def _serve_both(j, p, specs):
    """Serve ``specs`` (Request kwargs with uids) through both engines:
    tokens, trace and request_log identical."""
    want = j.serve([JRequest(**x) for x in specs])
    got = p.serve([Request(**x) for x in specs])
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace
    assert p.request_log == j.request_log
    return got


def _assert_rows_close(jrow, row, cfg):
    """A JAX materialized prefix (Layerwise) against the port's (a
    per-layer list), float32 within TOL."""
    want = bridge.layerwise_to_list(cfg, jax.tree.map(np.asarray, jrow))
    assert len(want) == len(row)
    for w, g in zip(want, row):
        assert sorted(w) == sorted(g)
        for key in w:
            np.testing.assert_allclose(g[key].numpy(), w[key], atol=TOL,
                                       rtol=TOL)


# ---------------------------------------------------------------------------
# Online serving against the JAX engine (tests/test_compiler.py:91, :123,
# :181, :289)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma2-2b", "mistral-7b", "smollm-135m"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_online_compile_matches_jax(arch, layout):
    """A warm task decodes while a cold one compiles in 16-token chunks;
    a second raw-shots request for the cold task joins its job.  Then the
    same task is resident: a third request hits it."""
    s = _setup(arch)
    jkv, kv = _offline(s, s["shots"][0])
    j, p = _engines(s, slots=2, max_len=s["m"] + 40, kv_layout=layout,
                    compile_token_budget=16)
    j.add_prefix("A", jkv)
    p.add_prefix("A", kv)
    cold = s["shots"][1]
    specs = [dict(tokens=s["prompt"], max_new=20, prefix="A", uid=1),
             dict(tokens=s["prompt"], max_new=3, raw_shots=cold, uid=2),
             dict(tokens=s["prompt"][:3], max_new=4, raw_shots=cold.copy(),
                  uid=3)]
    _serve_both(j, p, specs)
    compile_idx = [i for i, e in enumerate(p.trace) if e[0] == "compile"]
    assert len(compile_idx) == 3  # 48 tokens in 16-token chunks
    assert any(e[0] == "decode" for e in
               p.trace[compile_idx[0]:compile_idx[-1]])
    st = p.stats()
    assert st["compiler"] == j.stats()["compiler"]
    assert st["compiler"]["jobs"] == 1 and st["compiler"]["deduped"] == 1
    assert st["prefix_store"] == j.stats()["prefix_store"]
    for key in ("decode_steps_during_compile", "compile_chunks_interleaved"):
        assert st["engine"][key] == j.stats()["engine"][key] == 3
    name = Request(tokens=[1], max_new=1, raw_shots=cold).prefix
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=4, prefix=name,
                            uid=4)])
    assert p.stats()["prefix_store"]["hits"] == 2


@pytest.mark.parametrize("arch", ["gemma2-2b", "mistral-7b", "smollm-135m"])
def test_compiler_unit_budget_states_and_rows(arch):
    """PrefixCompiler alone, beside the JAX one: budgeted chunking, job
    states, a join, install bookkeeping; the materialized rows within
    1e-4 of the JAX compiler's (tests/test_compiler.py:154)."""
    s = _setup(arch)
    toks = s["shots"][0]
    jc = JCompiler(s["mc"], s["cfg"], s["params"])
    pc = PrefixCompiler(s["comp"], s["pcfg"], s["target"])
    jobs = [c.submit("t", toks) for c in (jc, pc)]
    assert jobs[1].status == "queued" and pc.pending()
    assert pc.submit("t", toks) is jobs[1] and pc.stats["deduped"] == 1
    jc.submit("t", toks)
    for c in (jc, pc):
        assert c.step(16) == []  # 16 of 40 tokens
    assert jobs[1].status == "compiling" and jobs[1].consumed == 16
    assert pc.peek_chunk(8)[1:3] == (16, 8)
    for c in (jc, pc):
        assert c.step(None) == ["t"]  # the rest in one chunk
    assert jobs[1].widths == jobs[0].widths == [16, 24]
    assert pc.stats == jc.stats
    assert jobs[1].status == "compiled" and jobs[1].remaining == 0
    assert pc.ready() == ["t"] and not pc.has_compile_work()
    _assert_rows_close(jobs[0].materialized, jobs[1].materialized,
                       s["pcfg"])
    # the online rows equal the offline compress's within the same rule
    _, kv = _offline(s, toks)
    for g, w in zip(jobs[1].materialized, kv):
        for key in w:
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=TOL, rtol=TOL)
    pc.mark_installed("t")
    assert jobs[1].status == "installed" and not pc.pending()
    assert jobs[1].materialized is None
    assert pc.submit("t", toks) is not jobs[1]  # a fresh compile
    with pytest.raises(ValueError, match="empty shot set"):
        pc.submit("e", np.zeros((0,), np.int32))


def test_pow2_bucket_is_the_reference_rule():
    from repro.serving.compiler import pow2_bucket as jbucket

    for n in (0, 1, 2, 3, 7, 8, 9, 100, 1024, 1025):
        for floor in (1, 8, 16):
            assert pow2_bucket(n, floor) == jbucket(n, floor)


# ---------------------------------------------------------------------------
# Capacity pressure (tests/test_compiler.py:219, :261, :280)
# ---------------------------------------------------------------------------


def test_mid_compile_lru_pressure_matches_jax():
    """prefix_capacity=1, paged: task B compiles while A (the sole
    resident prefix) is seated and decoding; B's install waits for A's
    request to finish, then A is evicted and B seats."""
    s = _setup("smollm-135m")
    jkv, kv = _offline(s, s["shots"][0])
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, kv_layout="paged",
                    prefix_capacity=1, compile_token_budget=8)
    j.add_prefix("A", jkv)
    p.add_prefix("A", kv)
    _serve_both(j, p, [
        dict(tokens=s["prompt"], max_new=10, prefix="A", uid=11),
        dict(tokens=s["prompt"], max_new=4, prefix="B",
             raw_shots=s["shots"][2], uid=12)])
    st = p.stats()
    assert st["prefix_store"] == j.stats()["prefix_store"]
    assert st["prefix_store"]["evictions"] >= 1
    assert "B" in p.store and "A" not in p.store
    assert st["engine"]["decode_steps_during_compile"] >= 2
    assert p.alloc.snapshot() == j.alloc.snapshot()


def test_pin_does_not_outlive_install_matches_jax():
    """The LRU pin of a waiting request's prefix lasts only for the
    install: after serve() returns, add_prefix evicts it."""
    s = _setup("smollm-135m")
    j, p = _engines(s, slots=1, max_len=s["m"] + 24, kv_layout="paged",
                    prefix_capacity=1)
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=2,
                            raw_shots=s["shots"][0], uid=21)])
    _serve_both(j, p, [dict(tokens=s["prompt"], max_new=2, uid=22)])
    jkv, kv = _offline(s, s["shots"][2])
    j.add_prefix("C", jkv)
    p.add_prefix("C", kv)  # must LRU-evict, not raise
    assert "C" in p.store and len(p.store) == 1
    assert p.stats()["prefix_store"] == j.stats()["prefix_store"]


def test_raw_shots_without_compressor_raises_like_jax():
    s = _setup("smollm-135m")
    j, p = _engines(s, compressor=False, slots=1, max_len=32)
    raw = np.arange(4, 12, dtype=np.int32)
    for eng, R in ((j, JRequest), (p, Request)):
        with pytest.raises(ValueError, match="compressor"):
            eng.serve([R(tokens=[5], max_new=1, raw_shots=raw)])
    with pytest.raises(ValueError, match="compile_token_budget"):
        ServingEngine(s["pcfg"], s["target"], device="cpu", slots=1,
                      max_len=32, compile_token_budget=0)


def test_compile_chunk_attends_once_over_the_keys_it_sees(monkeypatch):
    """Each chunk makes one causal flash call per layer over exactly the
    cached keys and its own (the one-shot compress's call, row for row),
    never over the rest of the source cache."""
    from repro_torch.kernels import ops

    s = _setup("mistral-7b")
    seen = []
    real = ops.attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], bool(kw["causal"])))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    toks = torch.as_tensor(s["shots"][0][None], dtype=torch.long)  # 40
    state = memcom.begin_compress(s["pcfg"], 1, 40, mc=s["comp"])
    for lo, hi in ((0, 16), (16, 32), (32, 40)):
        state = memcom.compress_chunk(s["comp"], s["pcfg"], state,
                                      toks[:, lo:hi])
    L = s["pcfg"].num_layers
    assert seen == ([(16, 16, True)] * L + [(16, 32, True)] * L
                    + [(8, 40, True)] * L)
