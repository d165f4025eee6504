"""The flash wrapper's choice of kernel and the kernels' tile rule, on the CPU.

``kernels/flash_attention.py::variant_for`` picks the CUDA kernel of a
call (``"wgmma"``: bf16 on Hopper's wgmma; ``"mma_sync"``: bf16 calls
that split the KV axis more than 4 ways; ``"float32"``), and ``tile_class``
restates the rule by which the bf16 kernels skip a KV tile or compute it
without a mask.  Neither needs a card, so both are held here: the
dispatch over dtype, head dim, Skv and split count, and the tile
rule against the dense mask of ``plain.attention_ref``'s contract (a
skipped tile has no visible pair, a mask-free tile no masked one).  So
are the backward's: ``bwd_variant_for`` (by dtype, head dim and the two
sides' tile counts) and ``bwd_plan``, the block order of the wgmma
backward's one launch: both halves of every (KV tile, KV head, batch)
and every (query tile, KV head, batch) once, heaviest first by the
visible tile pairs a block walks, counted from the dense mask, and each
half of a KV tile's walk holding its share of them (``bwd_mid``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import plain

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"
SOURCE = CSRC / "tile_class.cuh"
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"


# (dtype, head dim, Skv, nsplit) -> variant; nsplit is the split count
# flash_attention_splits gives on a 132-SM H100 (chip_smoke.py prints it)
DISPATCH = [
    (torch.bfloat16, 256, 3072, 1, "wgmma"),     # gemma2-2b source prefill
    (torch.bfloat16, 64, 3072, 1, "wgmma"),      # granite source prefill
    (torch.bfloat16, 128, 6144, 1, "wgmma"),     # mistral-7b source prefill
    (torch.bfloat16, 256, 12, 1, "wgmma"),       # prompt self, 24 rows
    (torch.bfloat16, 256, 512, 4, "wgmma"),      # gemma2-2b Memory-LLM
    (torch.bfloat16, 64, 512, 2, "wgmma"),       # granite Memory-LLM
    (torch.bfloat16, 128, 512, 2, "wgmma"),      # mistral-7b self 1x512
    (torch.bfloat16, 256, 2048, 2, "wgmma"),     # gemma2-2b self 1x2048
    (torch.bfloat16, 256, 568, 3, "wgmma"),      # decode over 32 slots
    (torch.bfloat16, 256, 568, 1, "wgmma"),      # decode over 72 slots
    (torch.bfloat16, 256, 568, 9, "mma_sync"),   # decode over 4 slots
    (torch.bfloat16, 64, 568, 9, "mma_sync"),    # granite decode
    (torch.bfloat16, 128, 568, 9, "mma_sync"),   # mistral-7b decode
    (torch.bfloat16, 64, 2048, 8, "mma_sync"),   # granite decode, 2048 cache
    (torch.bfloat16, 256, 512, 16, "mma_sync"),  # prompt vs 512 prefix
    (torch.bfloat16, 256, 2048, 64, "mma_sync"),  # 64 rows vs 2048 prefix
    (torch.bfloat16, 256, 8192, 16, "mma_sync"),  # decode, 8192 cache
    (torch.bfloat16, 256, 640, 5, "mma_sync"),   # one split past the rule
    (torch.bfloat16, 32, 3072, 1, "mma_sync"),   # no wgmma head dim
    (torch.bfloat16, 96, 3072, 1, "mma_sync"),
    (torch.bfloat16, 128, 65536, 1, "wgmma"),    # the longest Skv
    (torch.bfloat16, 128, 65537, 1, "mma_sync"),  # past the tile table
    (torch.float32, 256, 3072, 1, "float32"),
    (torch.float32, 64, 64, 2, "float32"),
    (torch.float32, 32, 80, 4, "float32"),
]


@pytest.mark.parametrize("dtype,hd,skv,nsplit,want", DISPATCH)
def test_variant_for(dtype, hd, skv, nsplit, want):
    assert fa.variant_for(dtype, hd, skv, nsplit) == want


# (dtype, key width, value width, Skv, nsplit) -> forward variant, and
# (folded query rows) -> backward variant: MLA's pairs
DV_DISPATCH = [
    (torch.bfloat16, 192, 128, 3072, 1, 6144, "wgmma", "wgmma"),  # source
    (torch.bfloat16, 192, 128, 1024, 1, 1024, "wgmma", "wgmma"),  # Memory
    (torch.bfloat16, 192, 128, 1024, 3, 16, "wgmma", "wgmma"),    # prompt
    (torch.bfloat16, 192, 128, 1100, 17, 4, "mma_sync", "wgmma"),
    (torch.bfloat16, 192, 128, 65537, 1, 64, "mma_sync", "mma_sync"),
    (torch.bfloat16, 576, 512, 1100, 17, 128, "mma_sync", "mma_sync"),
    (torch.bfloat16, 576, 512, 1100, 1, 128, "mma_sync", "mma_sync"),
    (torch.float32, 192, 128, 1024, 1, 1024, "float32", "float32"),
]


@pytest.mark.parametrize("dtype,D,Dv,skv,nsplit,rows,fwd,bwd", DV_DISPATCH)
def test_variant_for_value_widths(dtype, D, Dv, skv, nsplit, rows, fwd, bwd):
    """(192, 128) takes both wgmma kernels (the forward up to
    ``WGMMA_MAX_SPLITS``), (576, 512) neither; the backward's pick at a
    pair the wgmma kernel does not take is the mma.sync one, which itself
    refuses Dv != D (``flash_attention_bwd`` raises before any launch)."""
    assert fa.variant_for(dtype, D, skv, nsplit, Dv) == fwd
    assert fa.bwd_variant_for(dtype, D, rows, skv, Dv) == bwd
    assert fa.wgmma_takes(dtype, D, skv, Dv) == (
        dtype == torch.bfloat16 and (D, Dv) == (192, 128)
        and skv <= fa.WGMMA_MAX_SKV)
    if (D, Dv) in fa.BWD_BLOCKS_PER_SM:
        assert fa.bwd_split(1, rows, skv, 128, 128, D, True, 132,
                            dv=Dv) in (1, 2)


@pytest.mark.parametrize("variant", [None, "wgmma", "mma_sync"])
def test_cpu_tensors_go_to_the_plain_version_uncounted(variant):
    rng = np.random.default_rng(0)
    B, Sq, Skv, Hq, Hkv, D = 1, 70, 70, 6, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, h, D))
                                .astype(np.float32)).bfloat16()
               for n, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    pos = torch.arange(Skv, dtype=torch.int32)[None]
    before = (fa.launches, fa.wgmma_launches)
    out, lse = fa.flash_attention(q, k, v, q_pos=pos, kv_pos=pos,
                                  return_lse=True, variant=variant)
    ref, ref_lse = plain.attention_ref(q, k, v, q_pos=pos, kv_pos=pos,
                                       return_lse=True)
    assert (fa.launches, fa.wgmma_launches) == before
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def _dense_visible(kv_tile, q_rows, causal):
    kv = np.asarray(kv_tile)[None, :]
    q = np.asarray(q_rows)[:, None]
    vis = kv >= 0
    return vis & (kv <= q) if causal else np.broadcast_to(vis, (len(q_rows),
                                                                 len(kv_tile)))


@st.composite
def _tile_and_block(draw):
    G = draw(st.sampled_from([1, 2, 3, 4]))
    n_pos = draw(st.integers(1, 64 // G + 1))
    q_start = draw(st.integers(-4, 80))
    q_pos = q_start + np.sort(draw(st.lists(st.integers(0, 40), min_size=n_pos,
                                            max_size=n_pos)))
    # a block's rows: (position, head) pairs, cut at a random row and length
    rows = np.repeat(q_pos, G)
    lo = draw(st.integers(0, len(rows) - 1))
    q_rows = rows[lo:lo + draw(st.integers(1, 64))]
    kv_start = draw(st.integers(-8, 120))
    kv = kv_start + np.arange(64)
    holes = draw(st.lists(st.booleans(), min_size=64, max_size=64))
    kv = np.where(holes, -1, kv)
    if draw(st.booleans()):  # a tile cut at the end of the problem
        kv[draw(st.integers(0, 64)):] = -1
    return kv, q_rows, draw(st.booleans())


@settings(max_examples=300, deadline=None)
@given(_tile_and_block())
def test_tile_class_against_the_dense_mask(case):
    kv, q_rows, causal = case
    vis = _dense_visible(kv, q_rows, causal)
    verdict = fa.tile_class(kv, q_rows, causal)
    if verdict == "skipped":
        assert not vis.any()
    elif verdict == "mask_free":
        assert vis.all()
    else:
        assert verdict == "masked"


@pytest.mark.parametrize("kv,q_rows,causal,want", [
    ([-1] * 64, [0, 1], False, "skipped"),
    (list(range(64, 128)), list(range(64)), True, "skipped"),
    (list(range(64)), list(range(64, 128)), True, "mask_free"),
    (list(range(64)), list(range(64)), True, "masked"),       # the diagonal
    (list(range(64, 128)), list(range(64)), False, "mask_free"),
    ([0] * 63 + [-1], [5], False, "masked"),                  # one hole
    (list(range(60)) + [-1] * 4, [100], True, "masked"),      # cut at Skv
    ([-1] * 63 + [7], [7, 7, 7], True, "masked"),
])
def test_tile_class_cases(kv, q_rows, causal, want):
    assert fa.tile_class(kv, q_rows, causal) == want


def test_source_states_the_same_rule():
    """The kernels' ``tile_class`` tests what the Python restatement
    tests, in the same order."""
    src = SOURCE.read_text()
    body = re.search(r"int tile_class\(Span s, QRange q, int causal\) \{(.*?)\n\}",
                     src, re.S).group(1)
    lines = [ln.strip() for ln in body.strip().splitlines()]
    assert lines == [
        "if (s.lo == INT_MAX || (causal && s.lo > q.hi)) return kSkip;",
        "if (s.holes == 0 && (!causal || s.hi <= q.lo)) return kFree;",
        "return kMasked;"]


# (dtype, head dim, folded query rows Sq * Hq / Hkv, Skv) -> variant
BWD_DISPATCH = [
    (torch.bfloat16, 256, 1024, 512, "wgmma"),    # gemma2-2b training
    (torch.bfloat16, 256, 6144, 3072, "wgmma"),   # source (Phase 2)
    (torch.bfloat16, 64, 1536, 512, "wgmma"),     # granite
    (torch.bfloat16, 128, 2048, 512, "wgmma"),    # mistral-7b
    (torch.bfloat16, 256, 80, 130, "wgmma"),      # ragged
    (torch.bfloat16, 128, 65536, 65536, "wgmma"),  # the longest sides
    (torch.bfloat16, 128, 65537, 64, "mma_sync"),  # past the tile table
    (torch.bfloat16, 128, 64, 65537, "mma_sync"),
    (torch.bfloat16, 32, 512, 512, "mma_sync"),   # no wgmma head dim
    (torch.float32, 256, 1024, 512, "float32"),
    (torch.float32, 32, 96, 96, "float32"),
]


@pytest.mark.parametrize("dtype,hd,rows,skv,want", BWD_DISPATCH)
def test_bwd_variant_for(dtype, hd, rows, skv, want):
    assert fa.bwd_variant_for(dtype, hd, rows, skv) == want


@pytest.mark.parametrize("variant", [None, "wgmma", "mma_sync"])
def test_cpu_backward_goes_to_the_plain_version_uncounted(variant):
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv, D = 1, 40, 4, 2, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, h, D))
                                    .astype(np.float32)).bfloat16()
                   for h in (Hq, Hkv, Hkv, Hq))
    pos = torch.arange(S, dtype=torch.int32)[None]
    out, lse = plain.attention_ref(q, k, v, q_pos=pos, kv_pos=pos,
                                   return_lse=True)
    before = (fa.bwd_launches, fa.bwd_wgmma_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_pos=pos,
                                 kv_pos=pos, variant=variant)
    want = plain.attention_bwd_ref(q, k, v, out, lse, do, q_pos=pos,
                                   kv_pos=pos)
    assert (fa.bwd_launches, fa.bwd_wgmma_launches) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _tile_pairs(Sq, Skv, Hq, Hkv, causal):
    """Visible (query tile, KV tile) pairs from the dense mask, with q
    positions end-aligned to the kv positions (the training shapes: q s
    at s + Skv - Sq, kv j at j): (B = 1) -> bool (nq, nkv)."""
    G, T = Hq // Hkv, fa.BWD_TILE
    rows = Sq * G
    nq, nkv = -(-rows // T), -(-Skv // T)
    qp = np.arange(rows) // G + Skv - Sq
    vis = np.ones((rows, Skv), bool)
    if causal:
        vis = np.arange(Skv)[None, :] <= qp[:, None]
    pad = np.zeros((nq * T, nkv * T), bool)
    pad[:rows, :Skv] = vis
    return pad.reshape(nq, T, nkv, T).any(axis=(1, 3))


# (B, Sq, Skv, Hq, Hkv, causal): the training shapes (gemma2-2b's three,
# the source, granite's and mistral-7b's) and ragged ones
PLAN_SHAPES = [
    (2, 512, 512, 8, 4, True), (2, 512, 512, 8, 4, False),
    (1, 3072, 3072, 8, 4, True), (2, 512, 512, 24, 8, True),
    (2, 512, 512, 32, 8, True), (3, 70, 70, 6, 2, True),
    (2, 70, 45, 6, 2, True), (2, 45, 70, 6, 2, True),
    (2, 37, 53, 4, 2, False), (1, 200, 130, 8, 4, True),
    (1, 1, 700, 8, 1, True), (1, 700, 1, 8, 8, True), (2, 64, 64, 3, 1, True),
]


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("with_dq", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_bwd_plan_covers_every_tile_once_heaviest_first(shape, with_dq,
                                                        split):
    B, Sq, Skv, Hq, Hkv, causal = shape
    G, T = Hq // Hkv, fa.BWD_TILE
    nq, nkv = -(-Sq * G // T), -(-Skv // T)
    if split == 2 and nq < 2:
        split = 1   # one query tile: nothing to split
    blocks = fa.bwd_launch_plan(B, Sq, Skv, Hq, Hkv, causal, split, with_dq)
    want = {("kv", t, p, hk, b) for t in range(nkv) for p in range(split)
            for hk in range(Hkv) for b in range(B)}
    if with_dq:
        want |= {("q", u, 0, hk, b) for u in range(nq) for hk in range(Hkv)
                 for b in range(B)}
    assert len(blocks) == len(want) and set(blocks) == want
    # a slot's blocks are adjacent, KV heads fastest
    per = Hkv * B
    for i in range(0, len(blocks), per):
        assert [(blk[3], blk[4]) for blk in blocks[i:i + per]] == [
            (hk, b) for b in range(B) for hk in range(Hkv)]
        assert len({blk[:3] for blk in blocks[i:i + per]}) == 1
    pairs = _tile_pairs(Sq, Skv, Hq, Hkv, causal)
    for t in range(nkv):  # part 0 holds the larger half of what t sees
        mid, seen = fa.bwd_mid(Sq, Skv, Hq, Hkv, causal, t), int(
            pairs[:, t].sum())
        assert int(pairs[:mid, t].sum()) == -(-seen // 2)
        assert int(pairs[mid:, t].sum()) == seen // 2
    if not with_dq:
        return
    weight = {("kv", t, p): fa.BWD_KV_COST * -(-int(pairs[:, t].sum())
                                                 // split)
              for t in range(nkv) for p in range(split)}
    weight.update({("q", u, 0): fa.BWD_Q_COST * int(pairs[u].sum())
                   for u in range(nq)})
    w = [weight[blk[:3]] for blk in blocks[::per]]
    assert w == sorted(w, reverse=True), w


# (B, Sq, Skv, Hq, Hkv, head dim, causal) -> split on a 132-SM H100: the
# shapes whose heaviest KV walk outlasts the mean load (causal, or several
# blocks an SM) split; a prompt against its prefix and the 3072-token
# source, evenly loaded, do not (PERF.md section 6 times both ways)
SPLITS = [
    ((2, 512, 512, 8, 4, 256, True), 2),     # Memory-LLM, prompt self
    ((2, 512, 512, 8, 4, 256, False), 1),    # prompt vs prefix
    ((1, 3072, 3072, 8, 4, 256, True), 1),   # source
    ((2, 512, 512, 24, 8, 64, True), 2),     # granite
    ((2, 512, 512, 32, 8, 128, True), 2),    # mistral-7b
    ((1, 40, 70, 8, 4, 256, True), 2),       # few blocks: the walk sets it
    ((2, 10, 70, 8, 4, 256, True), 1),       # one query tile
]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_bwd_split(shape, want):
    assert fa.bwd_split(*shape, 132) == want


def test_bwd_source_states_the_plan_constants():
    """The tile, the table, the two costs, the split rule's ratio and the
    resident blocks the kernel's plan uses are the wrapper's."""
    src = BWD_SOURCE.read_text()
    for name, value in (("WB", fa.BWD_TILE),
                        ("BW_MAXT", fa.BWD_WGMMA_MAX_TILES),
                        ("KV_COST", fa.BWD_KV_COST),
                        ("Q_COST", fa.BWD_Q_COST)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert (f"constexpr int SPLIT_NUM = {fa.BWD_SPLIT_NUM}, SPLIT_DEN = "
            f"{fa.BWD_SPLIT_DEN};") in src
    per_sm = fa.BWD_BLOCKS_PER_SM
    assert (f"return D == 64 ? {per_sm[64, 64]} : D == 128 ? "
            f"{per_sm[128, 128]} : {per_sm[256, 256]};") in src
    # the source keys its resident blocks by the key width: (192, 128)
    # falls to the last case, as D 256 does
    assert per_sm[192, 128] == per_sm[256, 256]
    assert set(per_sm) == set(fa.WGMMA_HEAD_DIMS)
