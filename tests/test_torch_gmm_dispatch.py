"""The gmm wrapper's choice of kernel, on the CPU.

``kernels/moe_gmm.py::variant_for`` picks the CUDA kernel of a call
(``"rows"``: bf16 with few rows; ``"wgmma"``: bf16 above; ``"mma_sync"``:
bf16 whose rows are not whole 16-byte copies; ``"float32"``), and
``takes`` says which shapes each kernel computes at all.  Neither needs a
card, so both are held here, with the thresholds the source states, the
plain version for CPU tensors whatever the variant, and a forced variant
that does not take a shape.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gmm, plain

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "moe_gmm.cu")

BF16, F32 = torch.bfloat16, torch.float32
ROWS_CUT = moe_gmm.ROWS_MAX_C


def _want(C):
    return "rows" if C <= ROWS_CUT else "wgmma"


# (dtype, C, D, F, aligned) -> variant, at granite's widths and ragged ones
DISPATCH = [
    *((BF16, C, 1536, 512, True, _want(C))
      for C in (1, 8, 9, 16, 17, 32, 33, 63, 64, 65, 128, 768)),
    *((BF16, C, 512, 1536, True, _want(C)) for C in (8, 128, 768)),
    (BF16, 8, 96, 64, True, "rows"),          # granite-moe-smoke
    (BF16, 40, 1544, 520, True, "wgmma"),     # D, F multiples of 8 only
    (BF16, 8, 19, 512, True, "mma_sync"),     # D not a multiple of 8
    (BF16, 768, 1536, 7, True, "mma_sync"),   # F not a multiple of 8
    (BF16, 8, 1536, 512, False, "mma_sync"),  # a base off 16 bytes
    (BF16, 768, 1536, 512, False, "mma_sync"),
    (F32, 8, 1536, 512, True, "float32"),
    (F32, 768, 512, 1536, True, "float32"),
    (F32, 13, 19, 7, False, "float32"),
]


@pytest.mark.parametrize("dtype,C,D,F,aligned,want", DISPATCH)
def test_variant_for(dtype, C, D, F, aligned, want):
    assert moe_gmm.variant_for(dtype, C, D, F, aligned) == want


def test_granite_main_path_shapes():
    """Decode and the prompt prefill (C = 8) go to the rows kernel, the
    Memory-LLM (C = 128) and the source prefill (C = 768) to wgmma."""
    assert ROWS_CUT < 128
    for D, F in ((1536, 512), (512, 1536)):
        assert moe_gmm.variant_for(BF16, 8, D, F, True) == "rows"
        assert moe_gmm.variant_for(BF16, 128, D, F, True) == "wgmma"
        assert moe_gmm.variant_for(BF16, 768, D, F, True) == "wgmma"


# (variant, dtype, E, C, D, F, aligned) -> whether the kernel takes it
TAKES = [
    ("rows", BF16, 40, 32, 1536, 512, True, True),
    ("rows", BF16, 40, 33, 1536, 512, True, False),
    ("rows", BF16, 40, 64, 1536, 512, True, False),
    ("rows", BF16, 1, 1, 8, 8, True, True),
    ("rows", BF16, 40, 8, 1536, 512, False, False),
    ("rows", BF16, 40, 8, 1540, 512, True, False),
    ("rows", F32, 40, 8, 1536, 512, True, False),
    ("wgmma", BF16, 40, 768, 1536, 512, True, True),
    ("wgmma", BF16, 1, 1, 8, 8, True, True),
    ("wgmma", BF16, 40, 768, 1536, 516, True, False),
    ("wgmma", BF16, 40, 768, 1536, 512, False, False),
    ("wgmma", F32, 40, 768, 1536, 512, True, False),
    ("mma_sync", BF16, 2, 13, 19, 7, False, True),
    ("mma_sync", F32, 2, 13, 19, 7, True, False),
    ("float32", F32, 2, 13, 19, 7, False, True),
    ("float32", BF16, 2, 13, 19, 7, True, False),
    # the grid: E on its own axis, C in 64-row tiles
    *((v, BF16, 65535, 8, 64, 64, True, True)
      for v in ("rows", "wgmma", "mma_sync")),
    *((v, BF16, 65536, 8, 64, 64, True, False)
      for v in ("rows", "wgmma", "mma_sync")),
    ("wgmma", BF16, 1, 64 * 65535, 64, 64, True, True),
    ("wgmma", BF16, 1, 64 * 65535 + 1, 64, 64, True, False),
]


@pytest.mark.parametrize("variant,dtype,E,C,D,F,aligned,want", TAKES)
def test_takes(variant, dtype, E, C, D, F, aligned, want):
    assert moe_gmm.takes(variant, dtype, E, C, D, F, aligned) is want


@pytest.mark.parametrize("dtype,C,D,F,aligned,want", DISPATCH)
def test_the_chosen_variant_takes_the_call(dtype, C, D, F, aligned, want):
    for E in (1, 40):
        assert moe_gmm.takes(want, dtype, E, C, D, F, aligned)


def test_source_states_the_same_thresholds():
    """The rows kernel's widest call and the dispatch rule in the header
    comment are the wrapper's."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int ROWS_MAX_C = (\d+);", src)
               .group(1)) == moe_gmm.ROWS_MAX_C
    rule = re.search(r'go to "rows" for C <= (\d+)\s*//\s*and to "wgmma" '
                     r'above', src)
    assert rule is not None and int(rule.group(1)) == ROWS_CUT
    # one rows instance per 8-row column tile, up to ROWS_MAX_C
    tiles = [int(n) for n in re.findall(r"launch_rows<(\d+)>\(", src)]
    assert 8 * max(tiles) == moe_gmm.ROWS_MAX_C


def _pair(rng, E, C, D, F, dtype=BF16):
    x = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32))
    return x.to(dtype), (w * D ** -0.5).to(dtype)


@pytest.mark.parametrize("variant", [None, "wgmma", "rows", "mma_sync"])
def test_cpu_tensors_go_to_the_plain_version_uncounted(variant):
    x, w = _pair(np.random.default_rng(0), 3, 8, 64, 24)
    before = (moe_gmm.launches, moe_gmm.wgmma_launches,
              moe_gmm.rows_launches)
    out = moe_gmm.gmm(x, w, variant=variant)
    assert (moe_gmm.launches, moe_gmm.wgmma_launches,
            moe_gmm.rows_launches) == before
    assert torch.equal(out, plain.gmm_ref(x, w))


@pytest.mark.parametrize("variant,shape,dtype,shift", [
    ("rows", (2, 33, 64, 64), BF16, False),    # past the rows kernel's C
    ("rows", (2, 8, 60, 64), BF16, False),     # D not a multiple of 8
    ("wgmma", (2, 8, 64, 60), BF16, False),    # F not a multiple of 8
    ("wgmma", (2, 8, 64, 64), BF16, True),     # x off a 16-byte boundary
    ("rows", (2, 8, 64, 64), BF16, True),
    ("wgmma", (2, 8, 64, 64), F32, False),     # bf16 kernels
    ("rows", (2, 8, 64, 64), F32, False),
    ("mma_sync", (2, 8, 64, 64), F32, False),
])
def test_a_forced_variant_raises_on_a_shape_it_does_not_take(
        variant, shape, dtype, shift):
    E, C, D, F = shape
    x, w = _pair(np.random.default_rng(1), E, C, D, F, dtype)
    if shift:  # contiguous, one element past an aligned base
        flat = torch.zeros(x.numel() + 1, dtype=dtype)
        x = flat[1:].view(E, C, D).copy_(x)
        assert x.data_ptr() % 16
    with pytest.raises(NotImplementedError):
        moe_gmm.gmm(x, w, variant=variant)
    # unforced, the call goes to the plain version
    assert torch.equal(moe_gmm.gmm(x, w), plain.gmm_ref(x, w))


def test_an_unknown_variant_raises():
    x, w = _pair(np.random.default_rng(2), 1, 8, 8, 8)
    with pytest.raises(ValueError):
        moe_gmm.gmm(x, w, variant="tma")
