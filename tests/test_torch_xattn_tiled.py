"""``plain.memcom_xattn_tiled`` — the wgmma ``memcom_xattn`` variant's
arithmetic restated on the CPU (per-tile row maxima m_j and sums l_j, P~
= exp(S - m_j) rounded to bf16, the row's scales c_j = exp(m_j - m_row) /
l_row, zero 100 or more below the row's maximum, c_j P~ rounded again,
and the output summed as splits of T) — against the JAX package's oracle
``ref.memcom_xattn_ref`` and its Pallas kernel run in interpret mode
(``block_m=16``, ``block_t=32``), on the same numpy inputs.

Tolerances: without the bf16 rounding points (``round_p=False``) float32
2e-5 absolute and relative, as ``tests/test_torch_kernels.py`` holds the
plain versions; with them, the kernels' bf16 rule: 2e-2 absolute and 2e-2
of each element's scale (``plain.scaled_err``: |ref| + the rms of ref's
row).  Splits of T change only the order of float32 sums: 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import memcom_xattn as jmx
from repro.kernels import ref
from repro_torch.kernels import plain

torch.set_num_threads(1)  # small shapes: threads only contend with xdist
TOL = 2e-5
BF16_TOL = 2e-2

# (B, M, T, D, block_t): T not a multiple of the tile, T shorter than one
# tile, B 2, and the kernel's own tile of 128 columns
CASES = [(1, 16, 100, 64, 32), (1, 8, 20, 32, 32), (2, 24, 96, 64, 32),
         (1, 20, 300, 64, 128)]


def _inputs(rng, B, M, T, D, spread=False):
    q = (rng.standard_normal((B, M, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    if spread:
        # every row's logits over keys 0-31 sit ~150 above the rest, and
        # odd rows' over keys 64-95 too: their other tiles' maxima lie
        # more than 100 below the row's, so those tiles' c_j are 0
        q[..., 0] = 8.0
        k[:, :32, 0] = 150.0 * D ** 0.5 / 8.0
        q[:, 1::2, 1] = 8.0
        k[:, 64:96, 1] = 150.0 * D ** 0.5 / 8.0
    return q, k, v


def _t(x):
    return torch.from_numpy(np.array(x))


def _oracles(q, k, v):
    want = np.asarray(ref.memcom_xattn_ref(q, k, v))
    pallas = np.asarray(jmx.memcom_xattn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_m=16,
        block_t=32, interpret=True))
    return want, pallas


def _assert_bf16_rule(got, want):
    got, want = _t(got), _t(want)
    e = float((got - want).abs().max())
    s = plain.scaled_err(got, want)
    assert e <= BF16_TOL and s <= BF16_TOL, (e, s)


@pytest.mark.parametrize("round_p", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_tiled_matches_ref_and_pallas(rng, case, round_p):
    B, M, T, D, block_t = case
    q, k, v = _inputs(rng, B, M, T, D)
    got = plain.memcom_xattn_tiled(_t(q), _t(k), _t(v), block_t=block_t,
                                   round_p=round_p).numpy()
    assert got.shape == (B, M, D) and np.isfinite(got).all()
    for want in _oracles(q, k, v):
        if round_p:
            _assert_bf16_rule(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("round_p", [False, True])
def test_tile_maxima_far_apart_give_zero_scales(rng, round_p):
    """Rows whose tiles' maxima differ by more than 100: the low tiles'
    c_j are 0 (the oracle's weights there are ~e^-150), the output is
    finite and matches."""
    q, k, v = _inputs(rng, 1, 16, 160, 64, spread=True)
    got = plain.memcom_xattn_tiled(_t(q), _t(k), _t(v), block_t=32,
                                   round_p=round_p)
    assert bool(torch.isfinite(got).all())
    # no cut: the same to float32 rounding (the cut drops only e^-150)
    uncut = plain.memcom_xattn_tiled(_t(q), _t(k), _t(v), block_t=32,
                                     round_p=round_p, cut=float("inf"))
    np.testing.assert_allclose(got.numpy(), uncut.numpy(), atol=1e-6,
                               rtol=1e-6)
    for want in _oracles(q, k, v):
        if round_p:
            _assert_bf16_rule(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("round_p", [False, True])
def test_splits_of_t_give_the_same_sum(rng, round_p):
    """T = 300 (5 slabs of 64) summed as 1, 2 and 3 splits: the same
    output up to the order of float32 sums."""
    q, k, v = (_t(x) for x in _inputs(rng, 2, 12, 300, 64))
    outs = [plain.memcom_xattn_tiled(q, k, v, round_p=round_p, splits=n)
            for n in (1, 2, 3)]
    for out in outs[1:]:
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_bf16_inputs_round_where_the_kernel_rounds(rng):
    """bf16 q, k, v: float32 inside, the output rounded once to bf16, and
    within the bf16 rule of the float32 oracle on the same rounded
    inputs."""
    q, k, v = _inputs(rng, 1, 16, 100, 64)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = plain.memcom_xattn_tiled(qb, kb, vb, block_t=32)
    assert got.dtype == torch.bfloat16
    want = ref.memcom_xattn_ref(*(x.float().numpy() for x in (qb, kb, vb)))
    _assert_bf16_rule(got.float().numpy(), np.asarray(want))
