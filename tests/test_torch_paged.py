"""The port's paged-KV serving path against the JAX package's, on the CPU.

* Kernel level: the plain ``paged_decode_attention_ref`` (what a CPU
  tensor runs, and what the Hopper kernel is held to on the card) against
  the Pallas ``paged_flash_decode`` in interpret mode and the
  ``jnp_impl.paged_decode_attention_lengths`` oracle, within 1e-5 in
  float32 (the three sum in different orders); ``paged_scatter`` /
  ``paged_gather`` equal to their jnp counterparts.
* Engine level: the port's paged ``ServingEngine.serve`` against the JAX
  paged engine on both smoke configs, parameters carried by
  ``repro_torch.bridge``, requests with explicit uids, one virtual clock
  per engine: greedy tokens, the ``trace`` (admit / decode / preempt /
  resume events) and the ``request_log`` (first-token and finish times
  on the virtual clock) identical — under refill, a prefix that ends on a
  block boundary, a shared tail block copied on write, an admission gate
  that defers requests, preemption by a higher class, and priority aging.
  Label scoring leaves every prefix block bit-identical.  The port's
  paged engine equals its dense one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.kernels import jnp_impl
from repro.kernels.paged_attention import paged_flash_decode as pallas_paged
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import ops, plain
from repro_torch.kernels import paged_attention as pa
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix)

TOL = 1e-5
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------


def _pool(rng, B, nb, bs, Hkv, D, extra=3):
    """A pool of B*nb shuffled blocks plus spares (block 0 = trash, filled
    with large values a masked read would show)."""
    N = B * nb + 1 + extra
    k = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    k[0] = 50.0
    v[0] = 50.0
    tables = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb)
    return k, v, tables.astype(np.int32)


PAGED_CASES = [
    # (Hq, Hkv, S, bs, nb, lengths, softcap)
    (4, 2, 1, 4, 5, [1, 8, 20], 0.0),       # GQA; a length of 1, boundary, full
    (4, 1, 1, 4, 5, [3, 12, 17], 50.0),     # MQA, softcap
    (4, 2, 3, 4, 5, [3, 9, 20], 50.0),      # S = 3 rows per slot
    (4, 2, 3, 3, 6, [1, 2, 18], 0.0),       # fully-masked rows (length < S)
    (8, 2, 1, 8, 3, [24, 5, 16], 50.0),     # G = 4, boundaries
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_plain_matches_pallas_and_jnp(case):
    Hq, Hkv, S, bs, nb, lengths, cap = case
    rng = np.random.default_rng(sum(lengths) + S)
    B, D = len(lengths), 16
    k, v, tables = _pool(rng, B, nb, bs, Hkv, D)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    unused = np.zeros_like(tables)  # columns past each length name block 0
    for b, n in enumerate(lengths):
        unused[b, :-(-n // bs)] = tables[b, :-(-n // bs)]
    kw = dict(softcap=cap, scale=D ** -0.5)
    got = plain.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_tables=torch.from_numpy(unused), lengths=torch.from_numpy(lens),
        **kw).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jkw = dict(block_tables=jnp.asarray(unused), lengths=jnp.asarray(lens),
               **kw)
    want = np.asarray(jnp_impl.paged_decode_attention_lengths(*jargs, **jkw))
    kernel = np.asarray(pallas_paged(*jargs, interpret=True, **jkw))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, kernel, atol=TOL, rtol=TOL)
    qpos = lens[:, None] - S + np.arange(S)[None]
    assert np.all(got[qpos < 0] == 0)  # rows that see no key give 0
    # the CPU path of the wrapper and of ops is the plain version
    for fn in (pa.paged_flash_decode, ops.paged_decode_attention):
        out = fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), block_tables=torch.from_numpy(unused),
                 lengths=torch.from_numpy(lens), **kw)
        np.testing.assert_array_equal(out.numpy(), got)


@pytest.mark.parametrize("case", ["own_blocks", "shared_rows"])
def test_paged_scatter_and_gather_match_jnp(case):
    """K and V written through the tables in one call.  ``own_blocks``:
    slot 1 straddles two blocks, slot 2 ends in its table's last column.
    ``shared_rows``: slots 1 and 2 hold trash-only tables (released
    slots) and slot 0 a shared block, so several lanes name one row and
    the last lane in (slot, position) order must win, as in the
    reference's sequential scatter."""
    rng = np.random.default_rng(5)
    B, S, bs, nb, H, D = 3, 3, 4, 3, 2, 8
    k, v, tables = _pool(rng, B, nb, bs, H, D)
    new_k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    new_v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    starts = np.array([0, 5, 9], np.int32)
    if case == "shared_rows":
        tables[1:] = 0
        tables[0, 1] = 0
        starts = np.array([2, 1, 5], np.int32)  # slot 0 crosses into block 0
    pools = (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    got = ops.paged_scatter(pools, (torch.from_numpy(new_k),
                                    torch.from_numpy(new_v)),
                            torch.from_numpy(tables), torch.from_numpy(starts))
    assert got[0] is pools[0] and got[1] is pools[1]  # in place
    for pool, pool_np, new in zip(got, (k, v), (new_k, new_v)):
        want = jnp_impl.paged_scatter(jnp.asarray(pool_np), jnp.asarray(new),
                                      jnp.asarray(tables), jnp.asarray(starts))
        np.testing.assert_array_equal(pool.numpy(), np.asarray(want))
    if case == "shared_rows":
        # block 0 row 1: slot 1 lane 0 and slot 2 lane 0 (position 5)
        # name it; slot 2 comes last
        np.testing.assert_array_equal(got[0].numpy()[0, 1], new_k[2, 0])
        np.testing.assert_array_equal(got[1].numpy()[0, 2], new_v[2, 1])
    np.testing.assert_array_equal(
        ops.paged_gather(got[0], torch.from_numpy(tables)).numpy(),
        np.asarray(jnp_impl.paged_gather(jnp.asarray(got[0].numpy()),
                                         jnp.asarray(tables))))


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

SLOTS = 4


@pytest.fixture(scope="module", params=["gemma2-2b", "mistral-7b"])
def setup(request):
    cfg = get_smoke_config(request.param)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(request.param)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    compressor = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                        device="cpu")
    rng = np.random.default_rng(21)
    src = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    kvs = []
    for t in range(2):
        jprefix, _ = jmc.compress(mc, cfg, jnp.asarray(src[t:t + 1]))
        prefix, _ = memcom.compress(
            compressor, pcfg, torch.as_tensor(src[t:t + 1], dtype=torch.long))
        kvs.append((jmaterialize(params, cfg, jprefix),
                    materialize_prefix(target, pcfg, prefix)))
    m = cfg.memcom.num_memory_tokens
    engines = {}

    def pair(block_size, num_blocks=None, slots=SLOTS, max_len=m + 24,
             aging=None):
        """A JAX and a port paged engine with both tasks registered, one
        per (block_size, num_blocks, slots, max_len, aging): the JAX one
        compiles once."""
        key = (block_size, num_blocks, slots, max_len, aging)
        if key not in engines:
            kw = dict(slots=slots, max_len=max_len, kv_layout="paged",
                      block_size=block_size, num_blocks=num_blocks,
                      priority_aging_s=aging)
            j = JaxEngine(cfg, params, clock=JClock(), **kw)
            p = ServingEngine(pcfg, target, device="cpu", clock=VirtualClock(),
                              **kw)
            for t, (jkv, kv) in enumerate(kvs):
                j.add_prefix(f"task{t}", jkv)
                p.add_prefix(f"task{t}", kv)
            engines[key] = (j, p)
        return engines[key]

    return dict(cfg=cfg, pcfg=pcfg, target=target, kvs=kvs, m=m, pair=pair)


def _requests(cfg, seed, n, *, stops=False, prompt=(3, 10), max_new=(2, 7),
              **kw):
    """``n`` requests round-robin over the two tasks, as (JAX, port)
    lists with equal uids."""
    rng = np.random.default_rng(seed)
    jr, pr = [], []
    for i in range(n):
        toks = rng.integers(4, cfg.vocab_size,
                            int(rng.integers(*prompt))).astype(np.int32)
        args = dict(tokens=toks, max_new=int(rng.integers(*max_new)),
                    prefix=f"task{i % 2}", uid=10_000 * seed + i, **kw)
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
    assert p.request_log == j.request_log  # finish events on the clock
    assert p.alloc.snapshot() == j.alloc.snapshot()
    np.testing.assert_array_equal(p.tables, j.tables)
    return got


def test_paged_refill_matches_jax(setup):
    """10 requests over 4 slots and 2 tasks, stop tokens on some: slots
    refill mid-decode."""
    j, p = setup["pair"](8)
    jr, pr = _requests(setup["cfg"], 1, 10, stops=True)
    _serve_both(j, p, jr, pr)
    assert len([e for e in p.trace if e[0] == "admit"]) == 10
    assert p.stats()["engine"]["tokens_generated"] > 0


def test_paged_prefix_on_block_boundary_matches_jax(setup):
    """block_size 4: m = 8 ends on a block boundary, nothing is copied."""
    j, p = setup["pair"](4)
    jr, pr = _requests(setup["cfg"], 2, 6)
    _serve_both(j, p, jr, pr)
    shared = set(p.store.blocks("task0")) | set(p.store.blocks("task1"))
    assert len(shared) == 2 * setup["m"] // 4


def test_paged_shared_tail_copy_on_write_matches_jax(setup):
    """block_size 3: the prefix's third block is partial and shared, so
    every slot's first prompt token copies it on write; the store's
    blocks keep the prefix."""
    j, p = setup["pair"](3)
    before = [[x[key][p.store.blocks(f"task{t}")].clone()
               for x in p.cache for key in ("k", "v")] for t in range(2)]
    jr, pr = _requests(setup["cfg"], 3, 6)
    _serve_both(j, p, jr, pr)
    for t in range(2):
        tail = p.store.blocks(f"task{t}")[-1]
        for s in range(SLOTS):
            if p._seated[s] == f"task{t}":
                assert p._slot_blocks[s][2] != tail  # the private copy
        after = [x[key][p.store.blocks(f"task{t}")]
                 for x in p.cache for key in ("k", "v")]
        for a, b in zip(before[t], after):
            assert torch.equal(a, b)


def test_paged_admission_gate_defers_like_jax(setup):
    """A pool with room for about one request window beside the two
    prefixes: admissions wait for blocks, in the same order as JAX."""
    m = setup["m"]
    j, p = setup["pair"](8, num_blocks=1 + 2 + 3)
    jr, pr = _requests(setup["cfg"], 4, 5, prompt=(3, 8), max_new=(2, 6))
    _serve_both(j, p, jr, pr)
    # fewer slots ever decoded together than there are slots: the gate held
    assert max(e[1] for e in p.trace if e[0] == "decode") < SLOTS
    assert p.alloc.used_count >= 2 * (m // 8)


def test_paged_preemption_matches_jax(setup):
    """Two priority classes on timed arrivals: a class-0 request arriving
    while class-1 requests fill the slots preempts one; it resumes
    token-exact."""
    j, p = setup["pair"](4, slots=2)
    cfg = setup["cfg"]
    jr, pr = _requests(cfg, 5, 2, max_new=(9, 10), priority=1, arrival_s=0.0)
    ju, pu = _requests(cfg, 6, 1, max_new=(2, 3), priority=0,
                       arrival_s=0.004)
    _serve_both(j, p, jr + ju, pr + pu)
    assert p.stats()["engine"]["preemptions"] >= 1
    assert any(e[0] == "resume" for e in p.trace)


def test_paged_priority_aging_matches_jax(setup):
    """One slot, aging on: a class-2 request queued behind a running
    class-0 one has aged to class 0 by the time the slot frees, so it is
    admitted ahead of a later class-1 request (which then preempts it, on
    base classes).  The interval is no divisor of the clock's charges, so
    the port's exact interval count and the reference's floor agree."""
    j, p = setup["pair"](4, slots=1, aging=0.00314159)
    cfg = setup["cfg"]
    ja, pa_ = _requests(cfg, 12, 1, max_new=(9, 10), priority=0, arrival_s=0.0)
    jb, pb = _requests(cfg, 13, 1, max_new=(4, 5), priority=2, arrival_s=0.0)
    jc, pc = _requests(cfg, 14, 1, max_new=(3, 4), priority=1,
                       arrival_s=0.001)
    _serve_both(j, p, ja + jb + jc, pa_ + pb + pc)
    admits = [e[1] for e in p.trace if e[0] == "admit"]
    assert admits[:2] == [pa_[0].uid, pb[0].uid]  # aged past the class-1 one
    assert p.stats()["engine"]["preemptions"] >= 1


def test_paged_score_labels_leaves_prefix_blocks_unchanged(setup):
    j, p = setup["pair"](3)
    labels = np.arange(10, 40)
    query = np.arange(5, 12, dtype=np.int32)
    for t in range(2):
        j.seat_prefix(0, f"task{t}")
        p.seat_prefix(0, f"task{t}")
        pool = [x[key].clone() for x in p.cache for key in ("k", "v")]
        snap, table = p.alloc.snapshot(), p.tables.copy()
        want = j.score_labels(np.empty((0,), np.int32), query, labels)
        got = p.score_labels(np.empty((0,), np.int32), query, labels)
        assert got == want
        assert p.alloc.snapshot() == snap
        np.testing.assert_array_equal(p.tables, table)
        held = sorted({b for blocks in p._slot_blocks for b in blocks}
                      | {b for n in p.store.names() for b in p.store.blocks(n)})
        for a, b in zip(pool, (x[key] for x in p.cache for key in ("k", "v"))):
            assert torch.equal(a[held], b[held])


@pytest.mark.parametrize("block_size", [3, 4])
def test_paged_port_equals_dense_port(setup, block_size):
    pcfg, target, m = setup["pcfg"], setup["target"], setup["m"]
    outs = []
    for layout in ("dense", "paged"):
        eng = ServingEngine(pcfg, target, slots=SLOTS, max_len=m + 24,
                            device="cpu", kv_layout=layout,
                            block_size=block_size)
        for t, (_, kv) in enumerate(setup["kvs"]):
            eng.add_prefix(f"task{t}", kv)
        _, reqs = _requests(setup["cfg"], 7 + block_size, 7, stops=True)
        out = eng.serve(reqs)
        outs.append([out[r.uid].tolist() for r in reqs])
    assert outs[0] == outs[1]


def test_per_slot_stop_token_stops_that_slot_alone(setup):
    """A slot hitting its stop token terminates alone, right after
    emitting it; the other slot's tokens are unchanged.  The stop token is
    the first of slot 0's free-running stream that occurs nowhere earlier
    in that stream nor anywhere in slot 1's."""
    pcfg, target, m = setup["pcfg"], setup["target"], setup["m"]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(4, pcfg.vocab_size, n).astype(np.int32)
               for n in (6, 9)]

    def run(stop):
        eng = ServingEngine(pcfg, target, slots=2, max_len=m + 24,
                            device="cpu", kv_layout="paged", block_size=4)
        for t, (_, kv) in enumerate(setup["kvs"]):
            eng.add_prefix(f"task{t}", kv)
        reqs = [Request(tokens=p, max_new=6, prefix=f"task{i}",
                        stop_token=stop) for i, p in enumerate(prompts)]
        out = eng.serve(reqs)
        return [out[r.uid].tolist() for r in reqs]

    free = run(None)
    i = next(i for i, tok in enumerate(free[0])
             if tok not in free[0][:i] and tok not in free[1])
    out = run(free[0][i])
    assert out[0] == free[0][:i + 1]
    assert out[1] == free[1]
