"""``plain.memcom_xattn_bwd_tiled`` — the wgmma ``memcom_xattn`` backward's
arithmetic restated on the CPU (D_i = rowsum(dO o O) from the forward's
output, P = exp(S - lse) from the forward's lse, dS = P o (dP - D_i), P
and dS rounded to bf16, dQ summed as splits of T) — against the gradient
JAX forms for the JAX package's oracle ``ref.memcom_xattn_ref``
(``jax.vjp``), on the same numpy inputs; and the port's forward lse
(``return_lse``) against ``jax.nn.logsumexp`` of JAX's scaled logits.

Tolerances: without the bf16 rounding points (``round_p=False``) float32,
2e-5 of max(1, the largest gradient), as ``tests/test_torch_backward.py``
holds the plain backward; with them, the bf16 gradients' rule
``plain.grad_err`` <= 2e-2.  lse: 1e-5 of max(1, |lse|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import memcom_xattn as mx
from repro_torch.kernels import plain

torch.set_num_threads(1)  # small shapes: threads only contend with xdist
TOL = 2e-5
BF16_TOL = 2e-2

# (B, M, T, D): ragged M and T (T past one and two 128-column tiles, T not
# a multiple of 8 or 64), B 2, a single key
SHAPES = [(2, 40, 300, 128), (1, 17, 99, 64), (2, 24, 260, 64),
          (1, 8, 1, 32), (1, 33, 130, 64)]


def _inputs(rng, B, M, T, D):
    def draw(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return draw(B, M, D), draw(B, T, D), draw(B, T, D), draw(B, M, D)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_grads(q, k, v, do):
    _, vjp = jax.vjp(ref.memcom_xattn_ref, q, k, v)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, do, **kw):
    out, lse = mx.memcom_xattn(_t(q), _t(k), _t(v), return_lse=True)
    return plain.memcom_xattn_bwd_tiled(_t(q), _t(k), _t(v), out, lse,
                                        _t(do), **kw)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_unrounded_restatement_is_jax_vjp(rng, shape, splits):
    """Without its bf16 rounding points the restatement is the gradient
    JAX forms, at any split of T (float32 sums in another order)."""
    q, k, v, do = _inputs(rng, *shape)
    want = _jax_grads(q, k, v, do)
    got = _port(q, k, v, do, round_p=False, splits=splits)
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        e = float((g - _t(w)).abs().max())
        assert e <= TOL * scale, f"{name}: {e:.3e}"


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] > 1])
def test_rounded_restatement_is_within_the_bf16_rule(rng, shape):
    """P and dS rounded to bf16 where the kernels round them: each
    gradient within ``plain.grad_err`` 2e-2 of JAX's.  Not at T = 1: there
    the softmax has no gradient, JAX's dq and dk are exactly 0 (a scale of
    0 for ``grad_err``), and D_i taken from O leaves float32 noise (~1e-7,
    held to 2e-5 by the unrounded test)."""
    q, k, v, do = _inputs(rng, *shape)
    want = _jax_grads(q, k, v, do)
    got = _port(q, k, v, do, splits=mx.bwd_num_splits(*shape))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert plain.grad_err(g, _t(w)) <= BF16_TOL, name


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_lse_is_jax_logsumexp(rng, shape):
    q, k, v, _ = _inputs(rng, *shape)
    D = shape[3]
    logits = jnp.einsum("bmd,btd->bmt", q, k) * D ** -0.5
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    out, lse = mx.memcom_xattn(_t(q), _t(k), _t(v), return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == shape[:2]
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float((lse - _t(want)).abs().max()) <= bound
    assert torch.equal(out, mx.memcom_xattn(_t(q), _t(k), _t(v)))


def test_rowsum_of_do_and_out_is_rowsum_of_p_and_dp(rng):
    """The identity the D_i pass rests on: rowsum(dO o O) =
    rowsum(P o dP), with O the forward's output (float32 here)."""
    q, k, v, do = _inputs(rng, 2, 24, 260, 64)
    qt, kt, vt, dot = (_t(x) for x in (q, k, v, do))
    out = mx.memcom_xattn(qt, kt, vt)
    p = torch.softmax(torch.einsum("bmd,btd->bmt", qt, kt) * 64 ** -0.5, -1)
    dp = torch.einsum("bmd,btd->bmt", dot, vt)
    a, b = (dot * out).sum(-1), (p * dp).sum(-1)
    assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max()))


def test_the_cpu_backward_takes_out_and_lse_and_launches_nothing(rng):
    """``memcom_xattn_bwd`` on CPU tensors is ``plain.memcom_xattn_bwd_ref``
    whatever out and lse say, and counts no launch."""
    q, k, v, do = (_t(x) for x in _inputs(rng, 1, 17, 99, 64))
    out, lse = mx.memcom_xattn(q, k, v, return_lse=True)
    before = (mx.bwd_launches, mx.bwd_wgmma_launches)
    got = mx.memcom_xattn_bwd(q, k, v, out, lse, do)
    assert (mx.bwd_launches, mx.bwd_wgmma_launches) == before
    want = plain.memcom_xattn_bwd_ref(q, k, v, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
