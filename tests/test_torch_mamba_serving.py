"""The port's serving engine on mamba2-370m-smoke (attention-free, three
Mamba2 layers) against the JAX engine, dense and paged, on the CPU.

A Mamba2 layer keeps per-slot conv/ssm state that every prefill continues
and every batched decode step advances (idle slots too).  The JAX engine
therefore prefills a recurrent config exactly (no pad tokens), charges
and reserves that exact width, marks slots dirty, zeroes a dirty slot
before a request that names no prefix, and restores slot 0 before label
scoring.  The port does the same; the tests hold it to identical greedy
tokens, ``trace`` and ``request_log`` (on a virtual clock) and, paged,
identical allocator state and block tables, under refills, stop tokens,
preemption with resume and priority aging; and they carry over the
reference's own recurrent-refill tests (``tests/test_serving.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine, VirtualClock

ARCH = "mamba2-370m"
LAYOUTS = ["dense", "paged"]
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    pcfg = port_smoke_config(ARCH)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    engines = {}

    def pair(layout, slots=3, aging=None):
        """A JAX and a port engine, one per (layout, slots, aging): the
        JAX one compiles once per prompt length."""
        key = (layout, slots, aging)
        if key not in engines:
            kw = dict(slots=slots, max_len=48, kv_layout=layout,
                      priority_aging_s=aging)
            if layout == "paged":
                kw["block_size"] = 4
            j = JaxEngine(cfg, params, clock=JClock(), **kw)
            p = ServingEngine(pcfg, target, device="cpu", clock=VirtualClock(),
                              **kw)
            engines[key] = (j, p)
        return engines[key]

    def port(layout, slots):
        """A fresh port engine (no clock)."""
        kw = dict(block_size=4) if layout == "paged" else {}
        return ServingEngine(pcfg, target, slots=slots, max_len=48,
                             device="cpu", kv_layout=layout, **kw)

    return dict(cfg=cfg, pair=pair, port=port)


def _requests(cfg, seed, n, *, lens=(4, 7, 10), max_new=(2, 7), stops=False,
              **kw):
    """``n`` requests naming no prefix, as (JAX, port) lists with equal
    uids; prompt lengths from ``lens`` (each new length compiles a JAX
    prefill)."""
    rng = np.random.default_rng(seed)
    jr, pr = [], []
    for i in range(n):
        toks = rng.integers(4, cfg.vocab_size,
                            int(rng.choice(lens))).astype(np.int32)
        args = dict(tokens=toks, max_new=int(rng.integers(*max_new)),
                    uid=10_000 * seed + i, **kw)
        if stops and i % 3 == 0:
            args["stop_token"] = int(rng.integers(4, cfg.vocab_size))
        jr.append(JRequest(**args))
        pr.append(Request(**args))
    return jr, pr


def _serve_both(j, p, jr, pr):
    want = j.serve(jr)
    got = p.serve(pr)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace
    assert p.request_log == j.request_log  # charges of the exact width
    if p.paged:
        assert p.alloc.snapshot() == j.alloc.snapshot()
        np.testing.assert_array_equal(p.tables, j.tables)
    np.testing.assert_array_equal(p._dirty, j._dirty)
    return got


def _state(engine):
    return [{k: v.clone() for k, v in c.items()} for c in engine.cache]


def _same_state(a, b, slots=None):
    for ca, cb in zip(a, b):
        for key in ca:
            x, y = ca[key], cb[key]
            if slots is not None:
                x, y = x[slots], y[slots]
            if not torch.equal(x, y):
                return False
    return True


@pytest.mark.parametrize("layout", LAYOUTS)
def test_refill_matches_jax(setup, layout):
    """8 ragged requests over 3 slots, stop tokens on some: slots refill
    mid-decode, each refilled slot from a cleared state."""
    j, p = setup["pair"](layout)
    jr, pr = _requests(setup["cfg"], 1, 8, stops=True)
    _serve_both(j, p, jr, pr)
    assert len([e for e in p.trace if e[0] == "admit"]) == 8
    # a second serve on the same engines starts from dirty slots
    jr, pr = _requests(setup["cfg"], 2, 5)
    _serve_both(j, p, jr, pr)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_preemption_matches_jax(setup, layout):
    """Two class-1 requests fill both slots; a class-0 request arriving
    mid-decode preempts one, which resumes by re-prefilling prompt +
    emitted tokens from a cleared state, token-exact."""
    j, p = setup["pair"](layout, slots=2)
    cfg = setup["cfg"]
    jr, pr = _requests(cfg, 5, 2, max_new=(9, 10), priority=1, arrival_s=0.0)
    ju, pu = _requests(cfg, 6, 1, max_new=(2, 3), priority=0,
                       arrival_s=0.004)
    got = _serve_both(j, p, jr + ju, pr + pu)
    assert p.stats()["engine"]["preemptions"] >= 1
    resumed = [e for e in p.trace if e[0] == "resume"]
    assert resumed
    # the resumed request's stream equals the same request served alone
    uid = resumed[0][1]
    req = next(r for r in pr if r.uid == uid)
    alone = setup["port"](layout, 2).serve(
        [Request(tokens=req.tokens, max_new=req.max_new)])
    np.testing.assert_array_equal(got[uid], next(iter(alone.values())))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_priority_aging_matches_jax(setup, layout):
    """One slot, aging on: a class-2 request ages past a later class-1
    one, which then preempts it on base classes (as in
    tests/test_torch_paged.py)."""
    j, p = setup["pair"](layout, slots=1, aging=0.00314159)
    cfg = setup["cfg"]
    ja, pa_ = _requests(cfg, 12, 1, max_new=(9, 10), priority=0,
                        arrival_s=0.0)
    jb, pb = _requests(cfg, 13, 1, max_new=(4, 5), priority=2, arrival_s=0.0)
    jc, pc = _requests(cfg, 14, 1, max_new=(3, 4), priority=1,
                       arrival_s=0.001)
    _serve_both(j, p, ja + jb + jc, pa_ + pb + pc)
    admits = [e[1] for e in p.trace if e[0] == "admit"]
    assert admits[:2] == [pa_[0].uid, pb[0].uid]
    assert p.stats()["engine"]["preemptions"] >= 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_recurrent_refill_without_prefix_is_context_free(setup, layout):
    """tests/test_serving.py:197 in the port: a no-prefix request refilled
    into a used slot must not continue the previous occupant's state."""
    rng = np.random.default_rng(0)
    vocab = setup["cfg"].vocab_size
    p1 = rng.integers(4, vocab, 6).astype(np.int32)
    p2 = rng.integers(4, vocab, 6).astype(np.int32)
    eng = setup["port"](layout, 1)
    out = eng.serve([Request(tokens=p1, max_new=3),
                     Request(tokens=p2, max_new=3)])
    want = setup["port"](layout, 1).serve([Request(tokens=p2, max_new=3)])
    np.testing.assert_array_equal(list(out.values())[1],
                                  list(want.values())[0])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_recurrent_idle_slot_not_polluted_across_serves(setup, layout):
    """tests/test_serving.py:213 in the port: the batched decode step
    advances every slot's state, idle ones included, so a later admission
    into a slot that merely sat idle must still start from a clean
    state."""
    rng = np.random.default_rng(0)
    vocab = setup["cfg"].vocab_size
    p1 = rng.integers(4, vocab, 6).astype(np.int32)
    p2 = rng.integers(4, vocab, 6).astype(np.int32)
    eng = setup["port"](layout, 2)
    eng.serve([Request(tokens=p1, max_new=3)])  # slot 1 idles through decode
    assert eng._dirty.all()
    out = eng.serve([Request(tokens=p1, max_new=3),
                     Request(tokens=p2, max_new=3)])
    want = setup["port"](layout, 2).serve([Request(tokens=p1, max_new=3),
                                           Request(tokens=p2, max_new=3)])
    for got, exp in zip(sorted(out), sorted(want)):
        np.testing.assert_array_equal(out[got], want[exp])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_score_labels_after_serve_matches_jax(setup, layout):
    """After a serve every slot is dirty: label scoring restores slot 0
    (zeroes its state: no prefix) and scores from there, as the JAX engine
    does; the one-shot prefill then leaves every slot's state, and the
    paged allocator, as they were."""
    j, p = setup["pair"](layout)
    cfg = setup["cfg"]
    jr, pr = _requests(cfg, 7, 4)
    _serve_both(j, p, jr, pr)
    before = _state(p)
    alloc = p.alloc.snapshot() if p.paged else None
    rng = np.random.default_rng(3)
    labels = np.arange(10, 40)
    for n in (5, 8):
        query = rng.integers(4, cfg.vocab_size, n).astype(np.int32)
        ctx = np.empty((0,), np.int32)
        assert p.score_labels(ctx, query, labels) == \
            j.score_labels(ctx, query, labels)
    after = _state(p)
    assert _same_state(before, after, slots=slice(1, None))
    for c in after:  # slot 0 restored to the empty context
        assert not any(bool(x[0].any()) for x in c.values())
    if p.paged:
        assert p.alloc.snapshot() == alloc
    np.testing.assert_array_equal(p._dirty, j._dirty)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_shot_prefill_leaves_recurrent_state_untouched(setup, layout):
    """``persist=False`` (the scoring prefill) runs on clones of the slot's
    conv/ssm rows; ``persist=True`` writes the slot and marks it dirty."""
    eng = setup["port"](layout, 2)
    rng = np.random.default_rng(9)
    vocab = setup["cfg"].vocab_size
    eng.serve([Request(tokens=rng.integers(4, vocab, 7).astype(np.int32),
                       max_new=3) for _ in range(2)])
    before = _state(eng)
    toks = rng.integers(4, vocab, 9).astype(np.int32)
    eng._dirty[:] = False
    eng._prefill_slot(1, toks, persist=False)
    assert _same_state(before, _state(eng))
    assert not eng._dirty.any()
    eng._prefill_slot(1, toks)
    assert _same_state(before, _state(eng), slots=slice(0, 1))
    assert not _same_state(before, _state(eng), slots=slice(1, 2))
    assert eng._dirty.tolist() == [False, True]


def test_serve_cli_exits_for_a_config_without_memcom():
    """The launcher serves MemCom configs only; like the JAX launcher it
    exits with a message for mamba2-370m before building a model."""
    with pytest.raises(SystemExit, match="attention-free"):
        serve.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu"])
