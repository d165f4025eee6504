"""The ssd backward: ``plain.ssd_bwd_ref`` (the recurrence written out)
and ``plain.ssd_bwd_chunked`` (the backward kernel's two walks and chunk
products, restated) against ``jax.vjp`` of the JAX package's sequential
oracle ``ref.ssd_ref`` and of ``jnp_impl.ssd_chunked``, and against the
plain forward's autograd; and the routing of the wrapper's CUDA branch
through ``ssd_scan.Ssd``.

At dt·|A| = 25 a token the oracle is ``ref.ssd_ref``: ``jax.grad``
through ``jnp_impl.ssd_chunked`` gives non-finite ddt and dA there (it
exponentiates the masked upper triangle, e^{+…} = inf, and the VJP
multiplies 0 by inf), a behaviour of the reference recorded by its own
test and not carried over.

Routing runs without a card: the inputs are a tensor subclass whose
``is_cuda`` is True and the forward and backward launches are swapped for
the plain versions.  The real kernel is held to the plain version on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: float32 1e-4 of max(1, the largest gradient) (the frameworks
and forms sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jnp_impl
from repro.kernels import ref as jref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, plain, ssd_scan
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _inputs(rng, B=2, S=37, H=4, P=8, G=2, N=16, decay=None, h0=True):
    """dt·|A| = ``decay`` a token when given (the decay sums past 88
    within a 32-token chunk at 25)."""
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    dt = (rng.uniform(0.01, 0.1, (B, S, H)) if decay is None
          else np.broadcast_to(decay / -A, (B, S, H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    init = (rng.standard_normal((B, H, P, N)).astype(np.float32) if h0
            else None)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dhf = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm, init), dy, dhf


def _jax_grads(fn, ins, dy, dhf):
    x, dt, A, Bm, Cm, init = (None if a is None else jnp.asarray(a)
                              for a in ins)
    if init is None:
        _, vjp = jax.vjp(lambda *a: fn(*a), x, dt, A, Bm, Cm)
    else:
        _, vjp = jax.vjp(lambda *a: fn(*a[:5], init_state=a[5]), x, dt, A,
                         Bm, Cm, init)
    Bsz, _, H, P = x.shape
    dh = (jnp.zeros((Bsz, H, P, Bm.shape[-1]), jnp.float32) if dhf is None
          else jnp.asarray(dhf))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), dh))]


def _torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, dtype=np.float64)
        assert np.isfinite(w).all(), name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=TOL * scale, err_msg=name)


CASES = [  # (G, S, decay, initial state, final-state cotangent)
    (1, 37, None, True, True),
    (2, 37, None, True, True),
    (2, 64, None, False, True),
    (1, 100, None, True, False),
    (2, 100, None, False, False),
    (2, 70, 25.0, True, True),
    (1, 41, 25.0, False, True),
]


@pytest.mark.parametrize("G,S,decay,h0,with_dhf", CASES)
def test_plain_ssd_bwd_matches_jax_vjp_of_the_sequential_oracle(
        rng, G, S, decay, h0, with_dhf):
    ins, dy, dhf = _inputs(rng, S=S, G=G, decay=decay, h0=h0)
    dhf = dhf if with_dhf else None
    want = _jax_grads(jref.ssd_ref, ins, dy, dhf)
    t_ins = [_torch(a) for a in ins]
    for fn in (plain.ssd_bwd_ref, plain.ssd_bwd_chunked):
        got = fn(*t_ins, _torch(dy), _torch(dhf))
        assert (got[5] is None) == (not h0)
        _close([g for g in got if g is not None], want)


@pytest.mark.parametrize("G,S,h0", [(1, 37, True), (2, 100, False)])
def test_plain_ssd_bwd_matches_jax_vjp_of_the_chunked_form(rng, G, S, h0):
    ins, dy, dhf = _inputs(rng, S=S, G=G, h0=h0)
    want = _jax_grads(lambda *a, **k: jnp_impl.ssd_chunked(*a, chunk=16,
                                                           **k),
                      ins, dy, dhf)
    got = plain.ssd_bwd_ref(*[_torch(a) for a in ins], _torch(dy),
                            _torch(dhf))
    _close([g for g in got if g is not None], want)


def test_jax_chunked_ssd_gradient_is_not_finite_at_large_decay(rng):
    """The reference's own behaviour, recorded: at dt·|A| = 25 a token
    ``jax.vjp`` of ``jnp_impl.ssd_chunked`` gives non-finite ddt and dA
    (its ``where(tri, exp(decay), 0)`` exponentiates the upper triangle),
    while the sequential oracle's and the port's are finite."""
    ins, dy, dhf = _inputs(rng, S=128, G=1, decay=25.0)
    chunked = _jax_grads(lambda *a, **k: jnp_impl.ssd_chunked(*a, chunk=64,
                                                              **k),
                         ins, dy, dhf)
    assert not np.isfinite(chunked[1]).all()
    assert not np.isfinite(chunked[2]).all()
    assert all(np.isfinite(g).all() for g in
               _jax_grads(jref.ssd_ref, ins, dy, dhf))
    got = plain.ssd_bwd_ref(*[_torch(a) for a in ins], _torch(dy),
                            _torch(dhf))
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.parametrize("decay", [None, 25.0])
def test_plain_ssd_bwd_matches_the_plain_forward_autograd(rng, decay):
    """In float64, against the autograd of the per-token form (chunk 1):
    through chunks, autograd differentiates differences of cumsums, and at
    dt·|A| = 25 a token that alone strays ~1e-10 from dA (scale 6e-6),
    where the two written-out forms agree to 1e-21."""
    ins, dy, dhf = _inputs(rng, S=45, G=2, decay=decay)
    t_ins = [torch.from_numpy(a.astype(np.float64)) for a in ins]
    leaves = [t.clone().requires_grad_(True) for t in t_ins]
    y, hf = plain.ssd_ref(*leaves[:5], init_state=leaves[5], chunk=1)
    dy64, dhf64 = (torch.from_numpy(a.astype(np.float64)) for a in (dy, dhf))
    want = torch.autograd.grad((y * dy64).sum() + (hf * dhf64).sum(), leaves)
    for fn in (plain.ssd_bwd_ref, plain.ssd_bwd_chunked):
        got = fn(*t_ins, dy64, dhf64)
        for name, g, w in zip(NAMES, got, want):
            scale = max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= 1e-10 * scale, name


def test_plain_ssd_bwd_chunked_bf16_inputs(rng):
    """bf16 inputs: both forms sum in float32 and round the same
    gradients to bf16 (x, B and C) within one bf16 step of each other."""
    ins, dy, dhf = _inputs(rng, S=50, G=2, P=20)
    t_ins = [_torch(a) for a in ins]
    for i in (0, 3, 4):
        t_ins[i] = t_ins[i].to(torch.bfloat16)
    dyb = _torch(dy).to(torch.bfloat16)
    ref_ = plain.ssd_bwd_ref(*t_ins, dyb, _torch(dhf))
    got = plain.ssd_bwd_chunked(*t_ins, dyb, _torch(dhf))
    for name, g, w in zip(NAMES, got, ref_):
        assert g.dtype == w.dtype, name
        assert plain.grad_err(g, w) <= 1e-2, name


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(t, grad):
    return torch.Tensor._make_subclass(_LooksCuda, t, grad)


def _spy(monkeypatch):
    """The forward and backward launches replaced by the plain versions;
    returns the list of calls."""
    calls = []

    def launch(x, dt, A, Bm, Cm, init_state, variant):
        calls.append("fwd")
        plain_in = [None if t is None else torch.Tensor(t)
                    for t in (x, dt, A, Bm, Cm, init_state)]
        return plain.ssd_ref(*plain_in[:5], init_state=plain_in[5])

    def bwd_launch(x, dt, A, Bm, Cm, init_state, dy, dhf, need_dh0):
        calls.append(("bwd", dhf is not None, need_dh0))
        g = plain.ssd_bwd_ref(x, dt, A, Bm, Cm, init_state, dy, dhf)
        return g[:5] + (g[5] if need_dh0 else None,)

    monkeypatch.setattr(ssd_scan, "_launch", launch)
    monkeypatch.setattr(ssd_scan, "_bwd_launch", bwd_launch)
    return calls


@pytest.mark.parametrize("needs", range(6))
def test_ssd_cuda_call_with_grad_goes_through_the_function(rng, monkeypatch,
                                                           needs):
    """Any one of x, dt, A, Bm, Cm and the initial state requiring grad:
    the call is recorded, its backward launches once and gives that
    input the plain backward's gradient."""
    calls = _spy(monkeypatch)
    ins, dy, dhf = _inputs(rng, S=20, G=2)
    t_ins = [_torch(a) for a in ins]
    fakes = [_fake(t, i == needs) for i, t in enumerate(t_ins)]
    y, hf = ssd_scan.ssd(*fakes[:5], init_state=fakes[5])
    assert y.grad_fn is not None and calls == ["fwd"]
    (g,) = torch.autograd.grad([y, hf], [fakes[needs]],
                               [_torch(dy), _torch(dhf)])
    assert calls == ["fwd", ("bwd", True, needs == 5)]
    want = plain.ssd_bwd_ref(*t_ins, _torch(dy), _torch(dhf))[needs]
    assert torch.equal(torch.Tensor(g), want)


def test_ssd_cuda_call_unused_outputs_and_no_grad(rng, monkeypatch):
    """An unused final state reaches the backward as None (a zero
    cotangent, no tensor made), an unused y as zeros; under no_grad, or
    with no input requiring grad, the call is the forward launch alone."""
    calls = _spy(monkeypatch)
    ins, dy, dhf = _inputs(rng, S=20, G=1, h0=False)
    t_ins = [_torch(a) for a in ins[:5]]
    x = _fake(t_ins[0], True)
    y, _ = ssd_scan.ssd(x, *t_ins[1:])
    (gx,) = torch.autograd.grad(y, [x], _torch(dy))
    assert calls[-1] == ("bwd", False, False)
    assert torch.equal(torch.Tensor(gx), plain.ssd_bwd_ref(
        *t_ins, None, _torch(dy), None)[0])
    _, hf = ssd_scan.ssd(x, *t_ins[1:])
    (gx,) = torch.autograd.grad(hf, [x], _torch(dhf))
    assert calls[-1] == ("bwd", True, False)
    assert torch.equal(torch.Tensor(gx), plain.ssd_bwd_ref(
        *t_ins, None, torch.zeros_like(t_ins[0]), _torch(dhf))[0])
    n = len(calls)
    with torch.no_grad():
        y, _ = ssd_scan.ssd(x, *t_ins[1:])
    assert y.grad_fn is None
    y, _ = ssd_scan.ssd(*[_fake(t, False) for t in t_ins])
    assert y.grad_fn is None and calls[n:] == ["fwd", "fwd"]


def test_lm_step_makes_one_ssd_backward_call_a_layer(rng, monkeypatch):
    """mamba2-370m (smoke) next-token loss with every ``ssd`` call routed
    through ``Ssd`` (launches swapped for the plain versions): one
    backward call per Mamba2 layer, no final-state cotangent, no initial
    state, and the loss and gradients of the plain path."""
    cfg = get_smoke_config("mamba2-370m")
    model = tfm.init_params(cfg, 0, device="cpu")
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)))

    def grads():
        from repro_torch.core import memcom
        logits, _ = model(tokens=toks)
        loss = memcom.next_token_loss(logits, toks)
        return loss, torch.autograd.grad(loss, list(params.values()),
                                         allow_unused=True,
                                         materialize_grads=True)

    loss_p, g_p = grads()
    calls = _spy(monkeypatch)
    monkeypatch.setattr(ops._ssd, "ssd", lambda x, dt, A, Bm, Cm,
                        init_state=None, chunk=256: (
        ssd_scan.Ssd.apply(x, dt, A, Bm, Cm, init_state, None)
        if torch.is_grad_enabled() else
        ssd_scan._launch(x, dt, A, Bm, Cm, init_state, None)))
    loss_k, g_k = grads()
    layers = sum(d.mixer == "mamba" for d in cfg.layout.descriptors())
    assert calls.count(("bwd", False, False)) == layers
    assert calls.count("fwd") == layers and len(calls) == 2 * layers
    np.testing.assert_allclose(float(loss_k.detach()),
                               float(loss_p.detach()), rtol=1e-6)
    for name, a, b in zip(params, g_k, g_p):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= TOL * scale, name
