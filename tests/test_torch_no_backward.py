"""The gmm and ssd wrappers refuse a call autograd would record.

Their kernels have no backward yet.  A CUDA call that fills a fresh
output through ctypes returns it without a ``grad_fn``, so a call made
with gradients enabled where an input requires grad would leave those
inputs without a gradient and raise nothing.  The wrappers raise
``NotImplementedError`` for that call instead; under ``torch.no_grad``,
or with no input requiring grad, the call reaches the launch.  A CPU call
still goes to the plain version and its autograd.

On the CPU the launch is monkeypatched and the inputs are a tensor
subclass whose ``is_cuda`` is True; the ``cuda``-marked tests run the real
kernels on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gmm, ssd_scan


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(t, grad):
    return torch.Tensor._make_subclass(_LooksCuda, t, grad)


def _gmm_inputs(rng, device="cpu", dtype=torch.float32):
    x = torch.as_tensor(rng.standard_normal((2, 8, 16)), dtype=dtype)
    w = torch.as_tensor(rng.standard_normal((2, 16, 24)), dtype=dtype)
    return x.to(device), w.to(device)


def _ssd_inputs(rng, device="cpu", dtype=torch.float32, S=12):
    B, H, P, G, N = 1, 2, 8, 1, 16
    x = torch.as_tensor(rng.standard_normal((B, S, H, P)), dtype=dtype)
    dt = torch.as_tensor(rng.uniform(0.01, 0.1, (B, S, H)),
                         dtype=torch.float32)
    A = torch.as_tensor(-rng.uniform(0.5, 2.0, (H,)), dtype=torch.float32)
    Bm = torch.as_tensor(rng.standard_normal((B, S, G, N)), dtype=dtype)
    Cm = torch.as_tensor(rng.standard_normal((B, S, G, N)), dtype=dtype)
    h0 = torch.as_tensor(rng.standard_normal((B, H, P, N)),
                         dtype=torch.float32)
    return [t.to(device) for t in (x, dt, A, Bm, Cm, h0)]


def _spy(monkeypatch, module):
    calls = []

    def launch(*a):
        calls.append(a)
        return "launched"

    monkeypatch.setattr(module, "_launch", launch)
    return calls


@pytest.mark.parametrize("needs", ["x", "w"])
def test_gmm_refuses_a_cuda_call_autograd_would_record(rng, monkeypatch,
                                                       needs):
    calls = _spy(monkeypatch, moe_gmm)
    x, w = _gmm_inputs(rng)
    fx, fw = _fake(x, needs == "x"), _fake(w, needs == "w")
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        moe_gmm.gmm(fx, fw)
    assert calls == []
    with torch.no_grad():
        assert moe_gmm.gmm(fx, fw) == "launched"
    assert moe_gmm.gmm(_fake(x, False), _fake(w, False)) == "launched"
    assert len(calls) == 2


@pytest.mark.parametrize("needs", range(6))
def test_ssd_refuses_a_cuda_call_autograd_would_record(rng, monkeypatch,
                                                       needs):
    """Any one of x, dt, A, Bm, Cm and the initial state requiring grad."""
    calls = _spy(monkeypatch, ssd_scan)
    ins = _ssd_inputs(rng)
    fakes = [_fake(t, i == needs) for i, t in enumerate(ins)]
    x, dt, A, Bm, Cm, h0 = fakes
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0)
    assert calls == []
    with torch.no_grad():
        assert ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0) == "launched"
    plain_in = [_fake(t, False) for t in ins]
    assert ssd_scan.ssd(*plain_in[:5], init_state=plain_in[5]) == "launched"
    assert ssd_scan.ssd(*plain_in[:5]) == "launched"  # no initial state
    assert len(calls) == 3


def test_cpu_calls_keep_the_plain_autograd(rng, monkeypatch):
    """A CPU call with gradients goes to the plain version, launches
    nothing and differentiates."""
    calls = _spy(monkeypatch, moe_gmm) + _spy(monkeypatch, ssd_scan)
    x, w = (t.requires_grad_(True) for t in _gmm_inputs(rng))
    moe_gmm.gmm(x, w).sum().backward()
    assert float(w.grad.abs().max()) > 0
    ins = [t.requires_grad_(True) for t in _ssd_inputs(rng)]
    y, h = ssd_scan.ssd(*ins[:5], init_state=ins[5])
    (y.sum() + h.sum()).backward()
    assert all(float(t.grad.abs().max()) > 0 for t in (ins[0], ins[3]))
    assert calls == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_on_the_card_raises_with_grad_and_launches_without(cuda, rng,
                                                               dtype):
    x, w = _gmm_inputs(rng, "cuda", dtype)
    before = moe_gmm.launches
    with pytest.raises(NotImplementedError):
        moe_gmm.gmm(x, w.requires_grad_(True))
    assert moe_gmm.launches == before
    with torch.no_grad():
        out = moe_gmm.gmm(x, w)
    assert moe_gmm.launches == before + 1 and out.grad_fn is None
    want = torch.bmm(x.float(), w.detach().float())
    assert float((out.float() - want).abs().max()) < 0.1 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [12, 300])
def test_ssd_on_the_card_raises_with_grad_and_launches_without(cuda, rng,
                                                               S):
    ins = _ssd_inputs(rng, "cuda", torch.float32, S=S)
    before = ssd_scan.launches
    with pytest.raises(NotImplementedError):
        ssd_scan.ssd(ins[0].requires_grad_(True), *ins[1:5],
                     init_state=ins[5])
    assert ssd_scan.launches == before
    with torch.no_grad():
        y, h = ssd_scan.ssd(*ins[:5], init_state=ins[5])
    assert ssd_scan.launches == before + 1
    assert y.grad_fn is None and bool(torch.isfinite(y).all())
