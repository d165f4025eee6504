"""The gmm backward: ``plain.gmm_bwd_ref`` against ``jax.vjp`` of the JAX
package's ``ref.gmm_ref`` and against the plain forward's autograd, and
the routing of the wrapper's CUDA branch through ``moe_gmm.Gmm``.

The routing runs without a card: the inputs are a tensor subclass whose
``is_cuda`` is True, and the forward and backward launches are
monkeypatched with the plain versions (counting their calls).  The
backward's dispatch (``bwd_variant_for`` / ``bwd_takes``, forced
variants) runs likewise, with the ctypes kernel, the device guard and the
stream swapped for stand-ins that record the variant launched.  The real
kernels are held to the plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: float32 1e-4 of max(1, the largest gradient) (the frameworks
sum in different orders).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import moe_gmm, ops, plain, ssd_scan
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
TOL = 1e-4


def _close(got, want):
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("E,C,D,F", [(1, 1, 1, 1), (3, 8, 16, 24),
                                     (5, 33, 40, 17), (2, 130, 72, 136)])
def test_plain_gmm_bwd_matches_jax_vjp(rng, E, C, D, F):
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    _, vjp = jax.vjp(jref.gmm_ref, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = plain.gmm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(dy))
    _close(dx, jdx)
    _close(dw, jdw)
    # and the plain forward's autograd, each product on its own
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    gx, gw = torch.autograd.grad(plain.gmm_ref(tx, tw), (tx, tw),
                                 torch.from_numpy(dy))
    _close(dx, gx)
    _close(dw, gw)
    only_dx = plain.gmm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(dy), need_dw=False)
    assert only_dx[1] is None and torch.equal(only_dx[0], dx)


def test_plain_gmm_bwd_bf16_is_the_float32_sum_rounded(rng):
    x, w, dy = (torch.as_tensor(rng.standard_normal(s), dtype=torch.bfloat16)
                for s in ((4, 24, 32), (4, 32, 16), (4, 24, 16)))
    dx, dw = plain.gmm_bwd_ref(x, w, dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx, torch.einsum("ecf,edf->ecd", dy.float(),
                                        w.float()).to(torch.bfloat16))
    assert torch.equal(dw, torch.einsum("ecd,ecf->edf", x.float(),
                                        dy.float()).to(torch.bfloat16))


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
    returns the list of calls ("fwd", or ("bwd", need_dx, need_dw))."""
    calls = []

    def launch(x, w, variant):
        calls.append("fwd")
        return plain.gmm_ref(torch.Tensor(x), torch.Tensor(w))

    def bwd_launch(x, w, dy, need_dx, need_dw):
        calls.append(("bwd", need_dx, need_dw))
        return plain.gmm_bwd_ref(x, w, dy, need_dx, need_dw)

    monkeypatch.setattr(moe_gmm, "_launch", launch)
    monkeypatch.setattr(moe_gmm, "_bwd_launch", bwd_launch)
    return calls


@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_gmm_cuda_call_with_grad_goes_through_the_function(rng, monkeypatch,
                                                           needs):
    """The backward launches the products of the inputs that need a
    gradient and nothing else; the gradients are the plain backward's."""
    calls = _spy(monkeypatch)
    x = torch.as_tensor(rng.standard_normal((2, 8, 16)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((2, 16, 24)), dtype=torch.float32)
    dy = torch.as_tensor(rng.standard_normal((2, 8, 24)), dtype=torch.float32)
    need_x, need_w = needs in ("x", "both"), needs in ("w", "both")
    fx, fw = _fake(x, need_x), _fake(w, need_w)
    out = moe_gmm.gmm(fx, fw)
    assert out.grad_fn is not None and calls == ["fwd"]
    leaves = [t for t, n in ((fx, need_x), (fw, need_w)) if n]
    grads = torch.autograd.grad(out, leaves, dy)
    assert calls == ["fwd", ("bwd", need_x, need_w)]
    want = plain.gmm_bwd_ref(x, w, dy)
    for g, wnt in zip(grads, [wt for wt, n in zip(want, (need_x, need_w))
                              if n]):
        assert torch.equal(torch.Tensor(g), wnt)


def test_gmm_cuda_call_without_grad_is_the_forward_launch(rng, monkeypatch):
    calls = _spy(monkeypatch)
    x = torch.as_tensor(rng.standard_normal((2, 8, 16)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((2, 16, 24)), dtype=torch.float32)
    with torch.no_grad():
        out = moe_gmm.gmm(_fake(x, False), _fake(w, True))
    assert out.grad_fn is None
    out = moe_gmm.gmm(_fake(x, False), _fake(w, False))
    assert out.grad_fn is None and calls == ["fwd", "fwd"]


def test_cpu_calls_keep_the_plain_autograd(rng, monkeypatch):
    """A CPU call with gradients goes to the plain version, launches
    nothing and differentiates."""
    calls = []
    for mod in (moe_gmm, ssd_scan):
        for name in ("_launch", "_bwd_launch"):
            monkeypatch.setattr(mod, name,
                                lambda *a, _n=name: calls.append(_n))
    x = torch.as_tensor(rng.standard_normal((2, 8, 16)),
                        dtype=torch.float32).requires_grad_(True)
    w = torch.as_tensor(rng.standard_normal((2, 16, 24)),
                        dtype=torch.float32).requires_grad_(True)
    moe_gmm.gmm(x, w).sum().backward()
    assert float(w.grad.abs().max()) > 0
    B, S, H, P, G, N = 1, 12, 2, 8, 1, 16
    ins = [torch.as_tensor(a, dtype=torch.float32).requires_grad_(True)
           for a in (rng.standard_normal((B, S, H, P)),
                     rng.uniform(0.01, 0.1, (B, S, H)),
                     -rng.uniform(0.5, 2.0, (H,)),
                     rng.standard_normal((B, S, G, N)),
                     rng.standard_normal((B, S, G, N)),
                     rng.standard_normal((B, H, P, N)))]
    y, h = ssd_scan.ssd(*ins[:5], init_state=ins[5])
    (y.sum() + h.sum()).backward()
    assert all(float(t.grad.abs().max()) > 0 for t in (ins[0], ins[3]))
    assert calls == []


def _moe_layers(cfg):
    return [d.mlp == "moe" for d in cfg.layout.descriptors()]


def test_phase1_step_makes_the_gmm_backward_calls_chip_smoke_requires(
        rng, monkeypatch):
    """granite-moe-3b-a800m (smoke) Phase 1 with every ``gmm`` call routed
    through ``Gmm`` (launches swapped for the plain versions): dX alone,
    3 products x (the target's MoE layers + the Memory-LLM's less its
    last, whose output no loss term reads), and the loss and gradients of
    the plain path."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    target = tfm.init_params(cfg, 0, device="cpu")
    mc = memcom.init_memcom(cfg, target, 1)
    trained = memcom.set_trainable(mc, 1)
    batch = {"source": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 24))),
             "target": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 12))),
             "target_mask": torch.ones(2, 12)}

    def grads():
        loss, _ = memcom.memcom_loss(mc, target, cfg, batch)
        return loss, torch.autograd.grad(loss, list(trained.values()),
                                         allow_unused=True,
                                         materialize_grads=True)

    loss_p, g_p = grads()
    calls = _spy(monkeypatch)
    monkeypatch.setattr(ops._gmm, "gmm", lambda x, w: (
        moe_gmm.Gmm.apply(x, w, None)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
        else moe_gmm._launch(x, w, None)))
    loss_k, g_k = grads()
    moe = _moe_layers(cfg)
    want = 3 * (2 * sum(moe) - int(moe[-1]))
    assert calls.count(("bwd", True, False)) == want
    assert len([c for c in calls if c != "fwd"]) == want
    assert float(loss_k.detach()) == float(loss_p.detach())
    for a, b in zip(g_k, g_p):
        _close(a, b.numpy())


# ---- the backward's dispatch -----------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,C,D,F,aligned,want", [
    (BF16, 256, 1536, 512, True, "wgmma"),   # granite Phase 1, both ways
    (BF16, 256, 512, 1536, True, "wgmma"),
    (BF16, 1536, 1536, 512, True, "wgmma"),  # the source (Phase 2)
    (BF16, 8, 96, 64, True, "wgmma"),        # granite-moe-smoke
    (BF16, 37, 40, 24, True, "wgmma"),       # ragged C
    (BF16, 256, 1536, 500, True, "mma_sync"),  # F not a multiple of 8
    (BF16, 256, 1532, 512, True, "mma_sync"),  # D not a multiple of 8
    (BF16, 256, 1536, 512, False, "mma_sync"),  # off 16 bytes
    (F32, 256, 1536, 512, True, "float32"),
])
def test_bwd_variant_for(dtype, C, D, F, aligned, want):
    assert moe_gmm.bwd_variant_for(dtype, C, D, F, aligned) == want
    assert moe_gmm.bwd_takes(want, dtype, 40, C, D, F, aligned)


@pytest.mark.parametrize("variant,dtype,E,C,D,F,aligned,want", [
    ("wgmma", BF16, 40, 256, 1536, 512, True, True),
    ("wgmma", BF16, 40, 0, 1536, 512, True, True),     # no rows
    ("wgmma", BF16, 40, 256, 1536, 512, False, False),
    ("wgmma", BF16, 40, 256, 1536, 508, True, False),
    ("wgmma", F32, 40, 256, 1536, 512, True, False),
    ("wgmma", BF16, 65536, 8, 64, 64, True, False),    # past the grid's E
    ("mma_sync", BF16, 3, 13, 19, 7, False, True),
    ("mma_sync", F32, 3, 13, 19, 7, True, False),
    ("float32", F32, 3, 13, 19, 7, False, True),
    ("float32", BF16, 3, 13, 19, 7, True, False),
])
def test_bwd_takes(variant, dtype, E, C, D, F, aligned, want):
    assert moe_gmm.bwd_takes(variant, dtype, E, C, D, F, aligned) is want


def test_bwd_takes_an_unknown_variant_raises():
    with pytest.raises(ValueError):
        moe_gmm.bwd_takes("rows", BF16, 1, 8, 8, 8, True)


def _bf16_triple(rng, E, C, D, F, dtype=BF16):
    return tuple(torch.as_tensor(rng.standard_normal(s), dtype=F32).to(dtype)
                 for s in ((E, C, D), (E, D, F), (E, C, F)))


@pytest.mark.parametrize("variant,shape,dtype,shift", [
    ("wgmma", (2, 8, 64, 60), BF16, False),    # F not a multiple of 8
    ("wgmma", (2, 8, 60, 64), BF16, False),    # D not a multiple of 8
    ("wgmma", (2, 8, 64, 64), BF16, True),     # dy off a 16-byte boundary
    ("wgmma", (2, 8, 64, 64), F32, False),     # the bf16 kernels
    ("mma_sync", (2, 8, 64, 64), F32, False),
])
def test_a_forced_backward_variant_raises_on_a_call_it_does_not_take(
        rng, variant, shape, dtype, shift):
    x, w, dy = _bf16_triple(rng, *shape, dtype)
    if shift:  # contiguous, one element past an aligned base
        flat = torch.zeros(dy.numel() + 1, dtype=dtype)
        dy = flat[1:].view(dy.shape).copy_(dy)
        assert dy.data_ptr() % 16
    with pytest.raises(NotImplementedError):
        moe_gmm.gmm_bwd(x, w, dy, variant=variant)
    # unforced, a CPU call goes to the plain version
    for g, want in zip(moe_gmm.gmm_bwd(x, w, dy),
                       plain.gmm_bwd_ref(x, w, dy)):
        assert torch.equal(g, want)


def test_a_forced_backward_variant_on_the_cpu_is_the_plain_version(rng):
    x, w, dy = _bf16_triple(rng, 3, 8, 64, 24)
    before = (moe_gmm.bwd_launches, moe_gmm.bwd_wgmma_launches)
    for variant in ("wgmma", "mma_sync"):
        got = moe_gmm.gmm_bwd(x, w, dy, variant=variant)
        for g, want in zip(got, plain.gmm_bwd_ref(x, w, dy)):
            assert torch.equal(g, want)
    assert (moe_gmm.bwd_launches, moe_gmm.bwd_wgmma_launches) == before
    with pytest.raises(ValueError):
        moe_gmm.gmm_bwd(x, w, dy, variant="rows")


class _Stream:
    cuda_stream = 0


@pytest.fixture
def bwd_kernel(monkeypatch):
    """The backward's ctypes kernel replaced by a stand-in that records
    (need dx, need dw, variant code) and launches nothing."""
    calls = []

    def fn(x, w, dy, dx, dw, E, C, D, F, dtype, variant, stream):
        calls.append((dx is not None, dw is not None, variant))
        return 0

    monkeypatch.setattr(moe_gmm, "_bwd_kernel", lambda: fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    return calls


@pytest.mark.parametrize("shape,dtype,variant,code,want", [
    ((2, 8, 64, 64), BF16, None, 1, "wgmma"),
    ((2, 8, 64, 60), BF16, None, 0, "mma_sync"),
    ((2, 8, 64, 64), BF16, "mma_sync", 0, "mma_sync"),
    ((2, 8, 64, 64), F32, None, 0, "float32"),
])
def test_the_backward_counters_follow_the_launched_variant(
        rng, bwd_kernel, shape, dtype, variant, code, want):
    x, w, dy = (torch.Tensor._make_subclass(_LooksCuda, t)
                for t in _bf16_triple(rng, *shape, dtype))
    for need in ((True, False), (False, True), (True, True)):
        before = (moe_gmm.bwd_launches, moe_gmm.bwd_dx_launches,
                  moe_gmm.bwd_dw_launches, moe_gmm.bwd_wgmma_launches)
        dx, dw = moe_gmm.gmm_bwd(x, w, dy, need_dx=need[0],
                                 need_dw=need[1], variant=variant)
        assert bwd_kernel[-1] == (*need, code)
        assert (dx is not None, dw is not None) == need
        assert (moe_gmm.bwd_launches, moe_gmm.bwd_dx_launches,
                moe_gmm.bwd_dw_launches, moe_gmm.bwd_wgmma_launches) == (
            before[0] + 1, before[1] + need[0], before[2] + need[1],
            before[3] + (want == "wgmma"))
