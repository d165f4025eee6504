"""The paged decode kernel's position plan and split merge, on the CPU.

``kernels/paged_attention.py`` states the Hopper kernel's plan once:
``num_splits`` (the host's split count, from shapes alone) and
``split_plan`` (the positions each split of a slot walks, cut from the
slot's own length).  ``plain.paged_decode_split_ref`` computes each
split's partial by that plan, reading only the table entries of its
positions, and merges the partials through
``plain.combine_attention_partials``.  Held here, in float32 within 1e-4
(the three sum in different orders), to ``plain.paged_decode_attention_ref``
and to the Pallas ``paged_flash_decode`` in interpret mode, over slots of
0-600 positions in a 4096-position table; and the plan's properties, and
the source's statement of the same plan and constants.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.paged_attention import paged_flash_decode as pallas_paged
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plain

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "paged_attention.cu")
TOL = 1e-4
TABLE = 4096  # positions a table holds, far above the longest slot
SMS = 132     # an H100's multiprocessors
torch.set_num_threads(1)


def _case(rng, lengths, S, G, bs, softcap, Hkv=2, D=16):
    """Pools of shuffled blocks (block 0 = trash, filled with large values
    that a masked read would show); slot 2 shares slot 0's first blocks
    (a task prefix).  Returns the inputs and two tables: entries past each
    length name block 0 in ``tables`` and a block far outside the pool in
    ``poisoned``, which only a reader that never touches them survives."""
    B, nb = len(lengths), TABLE // bs
    used = [-(-n // bs) for n in lengths]
    N = 1 + sum(used)
    k = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    k[0] = 50.0
    v[0] = 50.0
    order = rng.permutation(N - 1) + 1
    tables = np.zeros((B, nb), np.int32)
    poisoned = np.full((B, nb), N + 10 ** 6, np.int32)
    start = 0
    for b, u in enumerate(used):
        tables[b, :u] = poisoned[b, :u] = order[start:start + u]
        start += u
    if B > 2:
        shared = min(used[0], used[2]) - 1
        if shared > 0:
            tables[2, :shared] = poisoned[2, :shared] = tables[0, :shared]
    q = rng.standard_normal((B, S, G * Hkv, D)).astype(np.float32)
    return q, k, v, tables, poisoned, np.asarray(lengths, np.int32)


def _torch(*a):
    return [torch.from_numpy(x) for x in a]


@settings(max_examples=10, deadline=None)
@given(lengths=st.lists(st.integers(0, 600), min_size=3, max_size=3),
       S=st.sampled_from([1, 3]), G=st.integers(1, 4),
       bs=st.sampled_from([8, 12, 16]), softcap=st.sampled_from([0.0, 50.0]),
       seed=st.integers(0, 2 ** 16))
def test_split_ref_matches_plain_and_pallas(lengths, S, G, bs, softcap, seed):
    rng = np.random.default_rng(seed)
    q, k, v, tables, poisoned, lens = _case(rng, lengths, S, G, bs, softcap)
    kw = dict(softcap=softcap, scale=q.shape[-1] ** -0.5)
    tq, tk, tv, tt, tp, tl = _torch(q, k, v, tables, poisoned, lens)
    want = plain.paged_decode_attention_ref(tq, tk, tv, block_tables=tt,
                                            lengths=tl, **kw).numpy()
    kernel = np.asarray(pallas_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_tables=jnp.asarray(tables), lengths=jnp.asarray(lens),
        interpret=True, **kw))
    np.testing.assert_allclose(want, kernel, atol=TOL, rtol=TOL)
    B, _, Hq, _ = q.shape
    nsplit = pa.num_splits(B, S, Hq, 2, tables.shape[1], bs, SMS)
    for n in sorted({1, 2, nsplit}):
        got = plain.paged_decode_split_ref(tq, tk, tv, block_tables=tp,
                                           lengths=tl, nsplit=n, **kw).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        qpos = lens[:, None] - S + np.arange(S)[None]
        assert np.all(got[qpos < 0] == 0)  # rows that see no key give 0


@pytest.mark.parametrize("lengths,S,nsplit", [
    ([524, 520, 516], 1, 9),    # gemma2-2b decode lengths, 9 splits
    ([0, 1, 33], 3, 5),         # empty slot, masked rows, splits left empty
    ([600, 12, 0], 1, 16),      # more splits than a short slot has tiles
])
def test_split_ref_at_fixed_plans(lengths, S, nsplit):
    rng = np.random.default_rng(sum(lengths) + nsplit)
    q, k, v, tables, poisoned, lens = _case(rng, lengths, S, 2, 16, 50.0)
    tq, tk, tv, tt, tp, tl = _torch(q, k, v, tables, poisoned, lens)
    want = plain.paged_decode_attention_ref(tq, tk, tv, block_tables=tt,
                                            lengths=tl, softcap=50.0)
    got = plain.paged_decode_split_ref(tq, tk, tv, block_tables=tp,
                                       lengths=tl, nsplit=nsplit,
                                       softcap=50.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


@settings(max_examples=300, deadline=None)
@given(length=st.integers(-3, 5000), bs=st.sampled_from([1, 8, 12, 16]),
       cols=st.integers(0, 600), nsplit=st.integers(1, 40))
def test_split_plan_covers_each_position_once(length, bs, cols, nsplit):
    nb = max(1, -(-max(length, 0) // bs) + cols - 300)  # tables short or long
    plan = pa.split_plan(length, bs, nb, nsplit)
    L = min(max(length, 0), nb * bs)
    assert len(plan) == nsplit
    assert plan[0][0] == 0 and plan[-1][1] == L
    for (lo, hi), (nxt, _) in zip(plan, plan[1:] + [(L, L)]):
        assert lo <= hi == nxt   # consecutive: each position once
    share = -(-(-(-L // nsplit)) // pa.TK) * pa.TK  # ceil(L / n), whole tiles
    assert all(hi - lo <= share for lo, hi in plan)
    assert all(hi <= max(length, 0) for _, hi in plan)  # never past the length
    # only the last non-empty split may end inside a tile
    assert all((hi - lo) % pa.TK == 0 for lo, hi in plan if hi < L)


def test_num_splits_reads_shapes_only():
    # gemma2-2b (8/4 heads), granite (24/8), S = 3, a 4096-position table
    assert pa.num_splits(4, 1, 8, 4, 36, 16, SMS) == 9
    assert pa.num_splits(4, 1, 24, 8, 36, 16, SMS) == 9
    assert pa.num_splits(4, 3, 8, 4, 36, 16, SMS) == 9
    assert pa.num_splits(4, 1, 8, 4, 256, 16, SMS) == pa.MAX_SPLITS
    assert pa.num_splits(1, 1, 8, 1, 256, 16, SMS) == pa.MAX_SPLITS
    assert pa.num_splits(4, 1, 8, 4, 4, 16, SMS) == 1     # two tiles: no split
    assert pa.num_splits(72, 1, 8, 4, 36, 16, SMS) == 1   # grid fills the card
    assert pa.num_splits(4, 1, 8, 4, 5, 16, SMS) == 2     # tiles of the table


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 80), S=st.integers(1, 8), G=st.integers(1, 8),
       Hkv=st.integers(1, 16), nb=st.integers(1, 600),
       bs=st.sampled_from([8, 12, 16]))
def test_num_splits_aims_at_two_waves(B, S, G, Hkv, nb, bs):
    n = pa.num_splits(B, S, G * Hkv, Hkv, nb, bs, SMS)
    blocks = -(-S * G // pa.RMAX) * Hkv * B
    pairs = -(-nb * bs // (2 * pa.TK))  # chunks of two tiles in the table
    assert 1 <= n <= max(1, min(pairs, pa.MAX_SPLITS))
    if n > 1:
        assert (n - 1) * blocks < 2 * SMS
        assert n * blocks >= 2 * SMS or n in (pairs, pa.MAX_SPLITS)


def test_source_states_the_same_plan():
    """The kernel derives its positions as ``split_plan`` does and is
    built with the constants the wrapper states."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TK") == pa.TK and const("RMAX") == pa.RMAX
    assert const("MAX_SPLITS") == pa.MAX_SPLITS
    for line in (
            "const int L = min(max(len, 0), nb * bs);",
            "const int chunk = ((L + nsplit - 1) / nsplit + TK - 1) / TK * TK;",
            "const int p_lo = min(L, split * chunk);",
            "const int p_hi = min(L, p_lo + chunk);",
            "RING_BYTES / (TILE * static_cast<int>(sizeof(T))), MIN_STAGES,"):
        assert line in src, line
    # the ring's stages (Cfg::STAGES): in bf16 at the main paths' head dims
    # the whole two-tile chunk of a split is in flight at once
    def stages(D, elt):
        return min(max(const("RING_BYTES") // (2 * pa.TK * D * elt),
                       const("MIN_STAGES")), const("MAX_STAGES"))

    assert [stages(D, 2) for D in (64, 128, 256)] == [8, 4, 2]
    assert [stages(D, 4) for D in (64, 128, 256)] == [4, 2, 2]
