"""The ssd wrapper's choice of kernel, on the CPU.

``kernels/ssd_scan.py::variant_for`` picks the CUDA kernel of a call
(``"chunked"``: bf16 at P 64, N 128 with 16-byte aligned x, B, C and
initial state;
``"sequential"``: float32 and the other bf16 shapes), and ``takes`` says
which shapes each kernel computes at all.  Neither needs a card, so both
are held here, with the limits the source states, the plain version for
CPU tensors whatever the variant, and a forced variant that does not take
a shape.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, plain, ssd_scan

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "ssd_scan.cu")

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, S, P, N, aligned) -> variant
CUT = ssd_scan.CHUNKED_MIN_S
DISPATCH = [
    *((BF16, S, 64, 128, True, "chunked" if S >= CUT else "sequential")
      for S in (1, 12, CUT - 1, CUT, CUT + 1, 1000, 3076, 3084, 6144)),
    (BF16, 3084, 64, 128, False, "sequential"),  # a base off 16 bytes
    (BF16, 3084, 32, 128, True, "sequential"),   # P the chunked tiles miss
    (BF16, 3084, 128, 128, True, "sequential"),
    (BF16, 3084, 64, 64, True, "sequential"),    # N the chunked tiles miss
    (BF16, 3084, 64, 256, True, "sequential"),
    (BF16, 70, 16, 16, True, "sequential"),      # mamba2-370m-smoke widths
    (F32, 3084, 64, 128, True, "sequential"),    # float32: the one kernel
    (F32, 12, 16, 16, False, "sequential"),
]


@pytest.mark.parametrize("dtype,S,P,N,aligned,want", DISPATCH)
def test_variant_for(dtype, S, P, N, aligned, want):
    assert ssd_scan.variant_for(dtype, S, P, N, aligned) == want


def test_mamba2_370m_prefills_go_to_the_chunked_variant():
    """Every prefill of a many-shot prompt (3076-3084 tokens) goes to the
    chunked variant; a cut above the shortest main-path prompt would send
    a prefill to the sequential kernel."""
    assert 0 < CUT <= 3076
    for S in (3076, 3080, 3084):
        assert ssd_scan.variant_for(BF16, S, 64, 128, True) == "chunked"


@pytest.mark.parametrize("dtype,S,P,N,aligned,want", DISPATCH)
def test_the_chosen_variant_takes_the_call(dtype, S, P, N, aligned, want):
    assert ssd_scan.takes(want, dtype, P, N, aligned)


# (variant, dtype, P, N, aligned) -> whether the kernel takes it
TAKES = [
    ("chunked", BF16, 64, 128, True, True),
    ("chunked", BF16, 64, 128, False, False),
    ("chunked", F32, 64, 128, True, False),
    ("chunked", BF16, 16, 128, True, False),
    ("chunked", BF16, 64, 16, True, False),
    ("chunked", BF16, 128, 256, True, False),
    ("sequential", BF16, 64, 128, True, True),
    ("sequential", BF16, 64, 128, False, True),
    ("sequential", F32, 64, 128, False, True),
    ("sequential", BF16, 40, 4, True, True),    # N from 4
    ("sequential", BF16, 40, 256, True, True),  # to N_MAX
    ("sequential", BF16, 40, 260, True, False),
    ("sequential", F32, 40, 6, True, False),    # N a multiple of 4
    ("sequential", torch.float16, 64, 128, True, False),
]


@pytest.mark.parametrize("variant,dtype,P,N,aligned,want", TAKES)
def test_takes(variant, dtype, P, N, aligned, want):
    assert ssd_scan.takes(variant, dtype, P, N, aligned) is want


def test_source_states_the_same_limits():
    """The chunked instance's P and N, its chunk length, and the
    sequential kernel's largest N in csrc/ssd_scan.cu are the wrapper's."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("P_"), const("N_")) == (ssd_scan.CHUNKED_P,
                                          ssd_scan.CHUNKED_N)
    assert const("NMAX") == ssd_scan.N_MAX
    # one chunk length, which sizes the wrapper's scratch
    assert const("Q_") == ssd_scan.CHUNK_Q
    assert "constexpr int Q = Q_;" in src


def _inputs(rng, B, S, H, P, G, N, dtype=BF16):
    f = np.float32
    t = [torch.from_numpy((rng.standard_normal(s) * 0.5).astype(f))
         for s in ((B, S, H, P), (B, S, G, N), (B, S, G, N))]
    dt = torch.from_numpy(np.abs(rng.standard_normal((B, S, H))).astype(f))
    A = -torch.from_numpy(np.abs(rng.standard_normal(H)).astype(f))
    h0 = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(f))
    return t[0].to(dtype), dt, A, t[1].to(dtype), t[2].to(dtype), h0


@pytest.mark.parametrize("variant", [None, "chunked", "sequential"])
def test_cpu_tensors_go_to_the_plain_version_uncounted(rng, variant):
    x, dt, A, Bm, Cm, h0 = _inputs(rng, 1, 40, 4, 64, 1, 128)
    before = (ssd_scan.launches, ssd_scan.chunked_launches)
    y, hf = ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0, chunk=16,
                         variant=variant)
    assert (ssd_scan.launches, ssd_scan.chunked_launches) == before
    y_ref, hf_ref = plain.ssd_ref(x, dt, A, Bm, Cm, init_state=h0, chunk=16)
    assert torch.equal(y, y_ref) and torch.equal(hf, hf_ref)
    if variant is None:  # the dispatcher too
        y2, hf2 = ops.ssd(x, dt, A, Bm, Cm, init_state=h0, chunk=16)
        assert torch.equal(y2, y_ref) and torch.equal(hf2, hf_ref)


def _shifted(t):
    """t's values, contiguous, one element past an aligned base."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape).copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("variant,shape,dtype,shift", [
    ("chunked", (1, 20, 4, 64, 1, 128), F32, False),   # bf16 only
    ("chunked", (1, 20, 4, 32, 1, 128), BF16, False),  # P
    ("chunked", (1, 20, 4, 64, 2, 64), BF16, False),   # N
    ("chunked", (1, 20, 4, 64, 1, 128), BF16, True),   # x off 16 bytes
    ("sequential", (1, 20, 4, 16, 1, 6), BF16, False),  # N not 4k
    ("sequential", (1, 20, 4, 16, 1, 260), F32, False),  # N past N_MAX
])
def test_a_forced_variant_raises_on_a_shape_it_does_not_take(
        rng, variant, shape, dtype, shift):
    x, dt, A, Bm, Cm, h0 = _inputs(rng, *shape, dtype=dtype)
    if shift:
        x = _shifted(x)
    with pytest.raises(NotImplementedError):
        ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0, variant=variant)
    # unforced, the call goes to the plain version
    y, hf = ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0)
    y_ref, hf_ref = plain.ssd_ref(x, dt, A, Bm, Cm, init_state=h0)
    assert torch.equal(y, y_ref) and torch.equal(hf, hf_ref)


def test_an_unknown_variant_raises(rng):
    x, dt, A, Bm, Cm, h0 = _inputs(rng, 1, 8, 2, 64, 1, 128)
    with pytest.raises(ValueError):
        ssd_scan.ssd(x, dt, A, Bm, Cm, variant="tma")


def test_an_initial_state_off_16_bytes_is_not_taken_by_the_chunked_variant(
        rng):
    """The state pass reads the initial state by 16 bytes, so a contiguous
    one that starts off a 16-byte boundary goes to the sequential kernel,
    and a forced chunked call raises."""
    x, dt, A, Bm, Cm, h0 = _inputs(rng, 1, 20, 4, 64, 1, 128)
    assert ssd_scan._aligned(x, Bm, Cm, h0)
    assert ssd_scan._aligned(x, Bm, Cm, None)
    h0 = _shifted(h0)
    assert not ssd_scan._aligned(x, Bm, Cm, h0)
    with pytest.raises(NotImplementedError):
        ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0, variant="chunked")
    y, hf = ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0,
                         variant="sequential")
    y_ref, hf_ref = plain.ssd_ref(x, dt, A, Bm, Cm, init_state=h0)
    assert torch.equal(y, y_ref) and torch.equal(hf, hf_ref)
