"""The flash wrapper's choice of kernel and the kernels' tile rule, on the CPU.

``kernels/flash_attention.py::variant_for`` picks the CUDA kernel of a
call (``"wgmma"``: bf16 on Hopper's wgmma; ``"mma_sync"``: bf16 calls
that split the KV axis more than 4 ways; ``"float32"``), and ``tile_class``
restates the rule by which both bf16 kernels skip a KV tile or compute it
without a mask.  Neither needs a card, so both are held here: the
dispatch over dtype, head dim, Skv and split count, and the tile
rule against the dense mask of ``plain.attention_ref``'s contract (a
skipped tile has no visible pair, a mask-free tile no masked one).
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

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention.cu")


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
