"""The chunked Hopper ``ssd`` kernel's three phases, restated on the CPU,
against the JAX package.

``plain.ssd_chunk_parallel`` restates ``csrc/ssd_scan.cu``'s chunked
variant: chunk states in parallel, the serial state pass, chunk outputs in
parallel, at the kernel's chunk length (``ssd_scan.CHUNK_Q``), with its
warp-scan cumsum order and its rounding points (x∘seg and the entering
state as hi/lo bf16 pairs, W below the diagonal as three bf16 terms, the
diagonal term added exactly and y's sum rounded to odd).  It is held to
the sequential oracle
``ref.ssd_ref``, to ``jnp_impl.ssd_chunked`` and to the Pallas
``ssd_scan.ssd`` in interpret mode, on inputs drawn from numpy under a
seed: float32 within 1e-4 (``assert_allclose``, absolute and relative:
the forms sum in other orders), bf16 within 2e-2 as max abs error and as
``plain.scaled_err`` (the kernel's gates on the card).  S runs through 1,
Q - 1, Q, Q + 1 and 2Q - 1; one case has two groups, one no initial
state, one dt·|A| = 25 a token (the decay sums past 100 within a chunk:
the result must be finite and within the gates); one case is at
mamba2-370m's head widths (P 64, N 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jnp_impl, ref, ssd_scan as jssd
from repro_torch.kernels import plain, ssd_scan

Q = ssd_scan.CHUNK_Q
F32_TOL = 1e-4
BF16_TOL = 2e-2
torch.set_num_threads(1)  # small shapes: threads only contend with xdist


def _inputs(rng, B, S, H, P, G, N, *, init=True, big=False):
    """dt and A as a seeded Mamba2 layer makes them (softplus of unit
    normals; -exp of U(-1, 1)), or dt·|A| = 25 a token (``big``); B and C
    scaled so that C·B is O(1)."""
    f = np.float32
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(f)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5 * N ** -0.25).astype(f)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5 * N ** -0.25).astype(f)
    if big:
        dt = np.full((B, S, H), 5.0, f)
        A = np.full((H,), -5.0, f)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
        A = -np.exp(rng.uniform(-1, 1, H)).astype(f)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(f) if init else None
    return x, dt, A, Bm, Cm, h0


CASES = {
    # name: (B, S, H, P, G, N, initial state, dt·|A| = 25)
    "S1": (2, 1, 4, 16, 1, 32, True, False),
    "S=Q-1": (1, Q - 1, 4, 16, 1, 32, True, False),
    "S=Q": (1, Q, 4, 16, 1, 32, True, False),
    "S=Q+1": (2, Q + 1, 4, 16, 1, 32, True, False),
    "S=2Q-1": (1, 2 * Q - 1, 4, 16, 1, 32, True, False),
    "G2": (1, Q + 37, 4, 16, 2, 32, True, False),
    "no_initial_state": (2, Q + 5, 4, 16, 1, 32, False, False),
    "decay_past_100": (1, 2 * Q, 4, 16, 1, 32, True, True),
    "mamba2_370m_widths": (1, Q + 9, 2, 64, 1, 128, True, False),
}


def _jax(name, x, dt, A, Bm, Cm, h0):
    j = [None if a is None else jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)]
    if name == "ref":
        return ref.ssd_ref(*j[:5], init_state=j[5])
    if name == "jnp_chunked":
        return jnp_impl.ssd_chunked(*j[:5], init_state=j[5], chunk=Q)
    return jssd.ssd(*j[:5], init_state=j[5], chunk=64, interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_restated_phases_match_the_jax_package(rng, case, dtype):
    B, S, H, P, G, N, init, big = CASES[case]
    x, dt, A, Bm, Cm, h0 = _inputs(rng, B, S, H, P, G, N, init=init, big=big)
    if dtype == "bfloat16":  # the JAX functions get the same bf16 values
        x, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in
                     (x, Bm, Cm))
    t = [None if a is None else torch.from_numpy(np.asarray(a, np.float32))
         for a in (x, dt, A, Bm, Cm, h0)]
    tdt = getattr(torch, dtype)
    y, hf = plain.ssd_chunk_parallel(t[0].to(tdt), t[1], t[2], t[3].to(tdt),
                                     t[4].to(tdt), init_state=t[5])
    assert y.dtype == tdt and hf.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(hf.shape) == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all() & torch.isfinite(hf).all())
    for fn in ("ref", "jnp_chunked", "pallas_interpret"):
        y_j, hf_j = _jax(fn, x, dt, A, Bm, Cm, h0)
        y_j = torch.from_numpy(np.array(y_j, np.float32))
        hf_j = torch.from_numpy(np.array(hf_j, np.float32))
        for got, want in ((y, y_j), (hf, hf_j)):
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           atol=F32_TOL, rtol=F32_TOL,
                                           err_msg=fn)
            else:
                err = float((got.float() - want).abs().max())
                scaled = plain.scaled_err(got, want)
                assert err <= BF16_TOL and scaled <= BF16_TOL, (
                    f"{fn}: max abs err {err:.3e}, scaled {scaled:.3e}")


def test_warp_scan_cumsum_matches_cumsum_in_another_order(rng):
    """The kernel's cumsum order (lanes of Q/32 tokens, a Hillis-Steele
    scan over the lanes' totals) gives torch.cumsum's sums to float32
    rounding, at dt·|A| = 25 a token too, where |cum| reaches 25·Q."""
    for scale in (0.7, 25.0):
        a = torch.from_numpy((-rng.uniform(0, 2 * scale, (6, Q)))
                             .astype(np.float32))
        got = plain._chunk_cumsum(a)
        want = torch.cumsum(a.double(), dim=-1)
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=Q * 2 ** -24, atol=0)


def test_round_to_odd_gives_bf16_the_rounding_of_the_exact_sum():
    """Just above and below a bf16 tie (4 + 2^-6, halfway between 4 and
    4 + 2^-5), float32 rounds to the tie and bf16's round to even then
    goes to 4 both times; rounded to odd first, each value goes to its
    own nearest bf16 neighbour.  Exact float32 values stay as they are."""
    tie = 4.0 + 2.0 ** -6
    v = torch.tensor([tie + 2.0 ** -40, tie - 2.0 ** -40, -(tie + 2.0 ** -40),
                      tie, 1.5, 0.0], dtype=torch.float64)
    assert v.float()[:2].tolist() == [tie, tie]
    assert v.float()[:2].bfloat16().tolist() == [4.0, 4.0]
    got = plain._round_to_odd(v)
    assert got.dtype == torch.float32
    assert got.bfloat16().tolist() == [4.0 + 2.0 ** -5, 4.0,
                                       -(4.0 + 2.0 ** -5), 4.0, 1.5, 0.0]
    assert got[3:].tolist() == [tie, 1.5, 0.0]
