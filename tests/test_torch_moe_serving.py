"""The port's serving engine on granite-moe-smoke (E = 5 experts, top-2)
against the JAX engine, dense and paged, on the CPU.

A MoE layer's capacity ``C = ceil8(int(1.25 * N * k / E))`` counts every
token of the forward pass.  The JAX engine prefills a prompt of ``n``
tokens at the padded width ``_bucket(n)`` (token 0 behind the prompt), and
its batched decode step runs every slot, idle ones included.  The port
does both the same way for a config with a MoE layer; the tests hold it
to identical greedy tokens, ``trace`` and ``request_log`` (on a virtual
clock) for a 12-token prompt (bucket 16), a 17-token prompt (bucket 32),
label scoring, and 12-slot serves whose decode steps carry more than 8
lanes, one of them with 8 idle lanes ahead of 4 active ones.

The witness shows why the padding is needed.  Pad tokens sort after the
real ones inside each expert, so they never take a real token's row; what
moves the real drops is the capacity itself.  At 12 tokens C is 8 at both
widths and the real tokens' drops are the same; at 17 tokens the exact
prefill has C = 8 where the padded one has C = 16, and it drops real
tokens that the reference keeps, which changes the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.models import moe
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix)

ARCH = "granite-moe-3b-a800m"
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(ARCH)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    compressor = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                        device="cpu")
    rng = np.random.default_rng(31)
    src = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    kvs = []
    for t in range(2):
        jprefix, _ = jmc.compress(mc, cfg, jnp.asarray(src[t:t + 1]))
        prefix, _ = memcom.compress(
            compressor, pcfg, torch.as_tensor(src[t:t + 1], dtype=torch.long))
        kvs.append((jmaterialize(params, cfg, jprefix),
                    materialize_prefix(target, pcfg, prefix)))
    m = cfg.memcom.num_memory_tokens
    engines = {}

    def pair(layout, slots=4, block_size=4):
        """A JAX and a port engine with both tasks registered, one per
        (layout, slots, block size): the JAX one compiles once."""
        key = (layout, slots, block_size)
        if key not in engines:
            kw = dict(slots=slots, max_len=m + 48, kv_layout=layout)
            if layout == "paged":
                kw["block_size"] = block_size
            j = JaxEngine(cfg, params, clock=JClock(), **kw)
            p = ServingEngine(pcfg, target, device="cpu", clock=VirtualClock(),
                              **kw)
            for t, (jkv, kv) in enumerate(kvs):
                j.add_prefix(f"task{t}", jkv)
                p.add_prefix(f"task{t}", kv)
            engines[key] = (j, p)
        return engines[key]

    return dict(cfg=cfg, pcfg=pcfg, params=params, target=target, kvs=kvs,
                m=m, pair=pair)


def _requests(cfg, seed, lens, max_new, **kw):
    rng = np.random.default_rng(seed)
    jr, pr = [], []
    for i, n in enumerate(lens):
        args = dict(tokens=rng.integers(4, cfg.vocab_size, n).astype(np.int32),
                    max_new=int(max_new[i % len(max_new)]),
                    prefix=f"task{i % 2}", uid=10_000 * seed + i, **kw)
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
    assert p.request_log == j.request_log
    if p.paged:
        assert p.alloc.snapshot() == j.alloc.snapshot()
        np.testing.assert_array_equal(p.tables, j.tables)
    return got


LAYOUTS = ["dense", "paged"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [12, 17])
def test_prompt_prefill_matches_jax(setup, layout, n):
    """Four requests of an n-token prompt over four slots: the prefill at
    the bucket width, then decode."""
    j, p = setup["pair"](layout)
    jr, pr = _requests(setup["cfg"], n, [n] * 4, [5, 3, 6, 4])
    _serve_both(j, p, jr, pr)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_score_labels_matches_jax(setup, layout):
    j, p = setup["pair"](layout)
    rng = np.random.default_rng(3)
    labels = np.arange(10, 40)
    for t, n in ((0, 12), (1, 17)):
        j.seat_prefix(0, f"task{t}")
        p.seat_prefix(0, f"task{t}")
        query = rng.integers(4, setup["cfg"].vocab_size, n).astype(np.int32)
        ctx = np.empty((0,), np.int32)
        assert p.score_labels(ctx, query, labels) == \
            j.score_labels(ctx, query, labels)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_twelve_slot_serve_matches_jax(setup, layout):
    """16 ragged requests over 12 slots: decode steps of up to 12 lanes
    (C = 8 for 24 assignments over 5 experts), requests finishing at
    different steps so idle lanes sit between active ones, and refills."""
    j, p = setup["pair"](layout, slots=12)
    lens = [3, 9, 12, 5, 17, 7, 4, 11, 6, 8, 10, 13, 5, 9, 3, 12]
    jr, pr = _requests(setup["cfg"], 40, lens, [2, 7, 4, 9, 3, 6, 5, 8])
    _serve_both(j, p, jr, pr)
    steps = [e[1] for e in p.trace if e[0] == "decode"]
    assert max(steps) > 8 and min(steps) < 12


@pytest.mark.parametrize("layout", LAYOUTS)
def test_idle_lanes_ahead_of_active_ones_match_jax(setup, layout):
    """12 requests in 12 slots: slots 0-7 stop after 2 tokens, 8-11 run on
    for 14, so most decode steps put 8 idle lanes ahead of 4 active ones
    in the dispatch sort.  An idle lane consumes its last token again at
    its last length, and writes its K/V through its own table as the JAX
    step does; routing those writes to the trash block instead changes
    the idle lanes' experts and then the active lanes' tokens (caught on
    the paged layout at this seed)."""
    j, p = setup["pair"](layout, slots=12)
    lens = [3, 9, 12, 5, 17, 7, 4, 11, 6, 8, 10, 13]
    jr, pr = _requests(setup["cfg"], 42, lens, [2] * 8 + [14] * 4)
    _serve_both(j, p, jr, pr)
    assert [e[1] for e in p.trace if e[0] == "decode"][1:] == [4] * 12


def _kept_sets(model, toks, width, base, kv):
    """Forward an n-token prompt padded to ``width`` behind a seated
    prefix; returns the last real row's logits and, per MoE layer, the
    set of (token, choice) assignments of the real tokens that were
    kept."""
    n = len(toks)
    padded = np.zeros((1, width), np.int64)
    padded[0, :n] = toks
    kept = []
    orig = moe._dispatch

    def spy(xf, ids, E, k, C):
        out = orig(xf, ids, E, k, C)
        keep, _, order = out[1]
        flat = order[0][keep[0]]  # kept assignments, token * k + choice
        kept.append({int(a) for a in flat if int(a) // k < n})
        return out

    moe._dispatch = spy
    try:
        with torch.no_grad():
            logits, _ = model(tokens=torch.as_tensor(padded), prefix=kv,
                              mask_offset=base)
    finally:
        moe._dispatch = orig
    return logits[0, n - 1], kept


def test_witness_exact_width_prefill_drops_other_tokens(setup):
    """At 17 tokens (bucket 32) an exact-width prefill keeps fewer real
    assignments than the padded one and its logits move far past the
    1e-4 parity bound; the padded row is the JAX engine's.  At 12 tokens
    (bucket 16, C = 8 either way) the real tokens' drops are the same."""
    pcfg, target, m = setup["pcfg"], setup["target"], setup["m"]
    kv = setup["kvs"][0][1]
    rng = np.random.default_rng(17)
    toks = rng.integers(4, pcfg.vocab_size, 17).astype(np.int32)
    exact, kept_exact = _kept_sets(target, toks, 17, m, kv)
    padded, kept_padded = _kept_sets(target, toks, 32, m, kv)
    assert moe._capacity(pcfg.moe, 17) == 8
    assert moe._capacity(pcfg.moe, 32) == 16
    assert kept_exact != kept_padded
    assert all(a <= b for a, b in zip(kept_exact, kept_padded))
    assert float((exact - padded).abs().max()) > 1e-2
    j, p = setup["pair"]("dense")
    j.seat_prefix(0, "task0")
    p.seat_prefix(0, "task0")
    row = p._prefill_slot(0, toks, persist=False)
    torch.testing.assert_close(row, padded, rtol=0, atol=0)
    want = j._prefill_slot(0, toks, persist=False)
    np.testing.assert_allclose(row.numpy(), want, atol=1e-4, rtol=1e-4)
    toks12 = toks[:12]
    _, kept_exact = _kept_sets(target, toks12, 12, m, kv)
    _, kept_padded = _kept_sets(target, toks12, 16, m, kv)
    assert kept_exact == kept_padded
