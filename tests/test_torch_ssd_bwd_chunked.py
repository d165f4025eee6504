"""The chunked ssd backward: ``plain.ssd_bwd_chunk_parallel`` (the chunked
Hopper backward's six phases, order and hi/lo rounding points, restated)
against ``jax.vjp`` of the JAX package's sequential oracle
``ref.ssd_ref`` at bf16 inputs and against ``plain.ssd_bwd_ref`` in
float64 with the rounding off; the wrapper's backward dispatch
(``bwd_variant_for`` / ``bwd_takes``, forced variants) and its counters.

At dt·|A| = 25 a token the oracle is ``ref.ssd_ref``: the JAX chunked
form's gradient is not finite there (``tests/test_torch_ssd_bwd.py``
records it).

The counters run the wrapper's CUDA branch without a card: the inputs
are a tensor subclass whose ``is_cuda`` is True, and the ctypes kernels,
the device guard and the stream are swapped for stand-ins that record
the call.  The kernels themselves are held to the plain versions on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerances: bf16 inputs, ``plain.grad_err`` at most 2e-2 per gradient
(the rule ``chip_smoke.py`` holds the kernels to); float64 without
rounding, 1e-10 of max(1, the largest gradient).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import plain, ssd_scan

torch.set_num_threads(1)
BF16, F32 = torch.bfloat16, torch.float32
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _inputs(rng, B=1, S=300, H=4, P=64, G=1, N=128, decay=None, h0=True,
            dhf=True):
    """As a seeded Mamba2 layer makes them: dt·|A| = ``decay`` a token
    when given (the decay sums past 88 within four tokens at 25)."""
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    dt = (rng.uniform(0.01, 0.1, (B, S, H)) if decay is None
          else np.broadcast_to(decay / -A, (B, S, H))).astype(np.float32)
    scale = 0.5 * N ** -0.25
    Bm = (rng.standard_normal((B, S, G, N)) * scale).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * scale).astype(np.float32)
    init = (rng.standard_normal((B, H, P, N)).astype(np.float32) if h0
            else None)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, P, N)).astype(np.float32) if dhf else None
    return [x, dt, A, Bm, Cm, init], dy, dh


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _jax_grads(ins, dy, dhf):
    x, dt, A, Bm, Cm, init = (None if a is None else jnp.asarray(a)
                              for a in ins)
    if init is None:
        _, vjp = jax.vjp(lambda *a: jref.ssd_ref(*a), x, dt, A, Bm, Cm)
    else:
        _, vjp = jax.vjp(lambda *a: jref.ssd_ref(*a[:5], init_state=a[5]),
                         x, dt, A, Bm, Cm, init)
    Bsz, _, H, P = x.shape
    dh = (jnp.zeros((Bsz, H, P, Bm.shape[-1]), jnp.float32) if dhf is None
          else jnp.asarray(dhf))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), dh))]


CASES = [  # (B, S, G, dt·|A|, initial state, final-state cotangent)
    (1, 300, 1, None, False, False),  # S past two chunks, not a multiple
    (1, 200, 2, None, True, True),    # two groups, h0 and dhf
    (1, 150, 2, 25.0, True, True),    # dt·|A| = 25 a token
]


@pytest.mark.parametrize("B,S,G,decay,h0,dhf", CASES)
def test_restatement_at_bf16_matches_jax_vjp_of_the_oracle(rng, B, S, G,
                                                           decay, h0, dhf):
    """bf16 x, B, C and dy (the oracle gets the same values in float32):
    every gradient within the 2e-2 rule, finite, dh0 only with an
    initial state; and beside the recurrence on the same inputs."""
    ins, dy, dh = _inputs(rng, B=B, S=S, G=G, decay=decay, h0=h0, dhf=dhf)
    for i in (0, 3, 4):
        ins[i] = _t(ins[i], BF16).float().numpy()
    dy = _t(dy, BF16).float().numpy()
    want = _jax_grads(ins, dy, dh)
    t_ins = [_t(a, BF16) if i in (0, 3, 4) else _t(a)
             for i, a in enumerate(ins)]
    got = plain.ssd_bwd_chunk_parallel(*t_ins, _t(dy, BF16), _t(dh))
    assert (got[5] is None) == (not h0)
    rec = plain.ssd_bwd_ref(*t_ins, _t(dy, BF16), _t(dh))
    for name, g, w, r in zip(NAMES, got, want, rec):
        if g is None:
            continue
        assert g.dtype == r.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        assert plain.grad_err(g, torch.from_numpy(np.array(w))) <= 2e-2, \
            name
        assert plain.grad_err(g, r) <= 2e-2, name


@pytest.mark.parametrize("B,S,G,decay,h0,dhf", CASES + [
    (2, 128, 1, None, True, False),   # exactly one chunk, two batch rows
    (1, 1, 2, None, True, True),      # one token
])
def test_restatement_without_rounding_is_the_recurrence_in_float64(
        rng, B, S, G, decay, h0, dhf):
    ins, dy, dh = _inputs(rng, B=B, S=S, H=4, P=16, G=G, N=32, decay=decay,
                          h0=h0, dhf=dhf)
    t_ins = [None if a is None else _t(a.astype(np.float64)) for a in ins]
    dy64 = _t(dy.astype(np.float64))
    dh64 = None if dh is None else _t(dh.astype(np.float64))
    got = plain.ssd_bwd_chunk_parallel(*t_ins, dy64, dh64, rounding=False)
    want = plain.ssd_bwd_ref(*t_ins, dy64, dh64)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float64, name
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-10 * scale, name


def test_restatement_rounds_where_the_kernels_do(rng):
    """The hi/lo pairs are what moves bf16 inputs off the float32
    recurrence: without them the restatement is the recurrence's float32
    sums in another order, closer to it than with them."""
    ins, dy, dh = _inputs(rng, S=140, G=2)
    t_ins = [_t(a, BF16) if i in (0, 3, 4) else _t(a)
             for i, a in enumerate(ins)]
    dyb = _t(dy, BF16)
    rec = plain.ssd_bwd_ref(*t_ins, dyb, _t(dh))
    off = plain.ssd_bwd_chunk_parallel(*t_ins, dyb, _t(dh), rounding=False)
    on = plain.ssd_bwd_chunk_parallel(*t_ins, dyb, _t(dh))
    for name in ("ddt", "dA", "dh0"):  # float32 results: no final rounding
        i = NAMES.index(name)
        err_off = float((off[i] - rec[i]).abs().max())
        err_on = float((on[i] - rec[i]).abs().max())
        assert 0 < err_on and err_off < err_on, name


# ---- the wrapper's backward dispatch ---------------------------------------

@pytest.mark.parametrize("dtype,S,P,N,aligned,want", [
    (BF16, 3072, 64, 128, True, "chunked"),     # mamba2-370m training
    (BF16, 256, 64, 128, True, "chunked"),      # the shortest chunked call
    (BF16, 255, 64, 128, True, "sequential"),
    (BF16, 3072, 64, 128, False, "sequential"),  # an input off 16 bytes
    (BF16, 3072, 32, 128, True, "sequential"),   # other widths
    (BF16, 3072, 64, 64, True, "sequential"),
    (F32, 3072, 64, 128, True, "sequential"),
])
def test_bwd_variant_for(dtype, S, P, N, aligned, want):
    assert ssd_scan.bwd_variant_for(dtype, S, P, N, aligned) == want
    assert ssd_scan.bwd_takes(want, dtype, P, N, aligned)


@pytest.mark.parametrize("variant,dtype,P,N,aligned,want", [
    ("chunked", BF16, 64, 128, True, True),
    ("chunked", BF16, 64, 128, False, False),
    ("chunked", F32, 64, 128, True, False),
    ("chunked", BF16, 16, 128, True, False),
    ("sequential", F32, 16, 32, False, True),
    ("sequential", BF16, 64, 128, True, True),
    ("sequential", BF16, 64, 256, True, False),  # past BWD_N_MAX
    ("sequential", BF16, 64, 30, True, False),   # N not a multiple of 4
])
def test_bwd_takes(variant, dtype, P, N, aligned, want):
    assert ssd_scan.bwd_takes(variant, dtype, P, N, aligned) is want


def test_bwd_takes_an_unknown_variant_raises():
    with pytest.raises(ValueError):
        ssd_scan.bwd_takes("wgmma", BF16, 64, 128, True)


def _torch_ins(rng, S, P, N, dtype, G=1, h0=True, dhf=True):
    ins, dy, dh = _inputs(rng, S=S, P=P, G=G, N=N, h0=h0, dhf=dhf)
    t_ins = [_t(a, dtype) if i in (0, 3, 4) else _t(a)
             for i, a in enumerate(ins)]
    return t_ins, _t(dy, dtype), _t(dh)


@pytest.mark.parametrize("variant,S,P,N,dtype,shift", [
    ("chunked", 300, 16, 128, BF16, None),     # P the kernels do not take
    ("chunked", 300, 64, 128, F32, None),      # float32
    ("chunked", 300, 64, 128, BF16, "dy"),     # dy off a 16-byte boundary
    ("chunked", 300, 64, 128, BF16, "dhf"),    # dhf likewise
    ("sequential", 40, 8, 256, BF16, None),    # N past BWD_N_MAX
])
def test_a_forced_backward_variant_raises_on_a_call_it_does_not_take(
        rng, variant, S, P, N, dtype, shift):
    t_ins, dy, dh = _torch_ins(rng, S, P, N, dtype)
    if shift == "dy":
        flat = torch.zeros(dy.numel() + 1, dtype=dy.dtype)
        dy = flat[1:].view(dy.shape).copy_(dy)
    elif shift == "dhf":
        flat = torch.zeros(dh.numel() + 1, dtype=dh.dtype)
        dh = flat[1:].view(dh.shape).copy_(dh)
    with pytest.raises(NotImplementedError):
        ssd_scan.ssd_bwd(*t_ins, dy, dh, variant=variant)
    if N <= ssd_scan.BWD_N_MAX:  # unforced, a CPU call is the plain version
        got = ssd_scan.ssd_bwd(*t_ins, dy, dh)
        want = plain.ssd_bwd_ref(*t_ins, dy, dh)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrapper's CUDA branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(t):
    return None if t is None else torch.Tensor._make_subclass(_LooksCuda, t)


class _Stream:
    cuda_stream = 0


@pytest.fixture
def kernels(monkeypatch):
    """The two backward kernels and their workspace functions replaced by
    stand-ins that record (variant, arguments) and launch nothing."""
    calls = []

    def kernel(name, n_args):
        def fn(*args):
            assert len(args) == n_args
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(ssd_scan, "_chunked_bwd_kernel", lambda: (
        kernel("chunked", 22), lambda B, S, H, G: 4096))
    monkeypatch.setattr(ssd_scan, "_bwd_kernel", lambda: (
        kernel("sequential", 23), lambda B, S, H, P, N, dt: 8192))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    return calls


@pytest.mark.parametrize("S,variant,want", [
    (300, None, "chunked"), (200, None, "sequential"),
    (300, "sequential", "sequential"), (300, "chunked", "chunked")])
def test_the_counters_follow_the_launched_variant(rng, kernels, S, variant,
                                                  want):
    t_ins, dy, dh = _torch_ins(rng, S, 64, 128, BF16, G=2)
    before = (ssd_scan.bwd_launches, ssd_scan.bwd_chunked_launches)
    got = ssd_scan.ssd_bwd(*map(_fake, t_ins), _fake(dy), _fake(dh),
                           variant=variant)
    assert [c[0] for c in kernels] == [want]
    assert (ssd_scan.bwd_launches, ssd_scan.bwd_chunked_launches) == (
        before[0] + 1, before[1] + (want == "chunked"))
    assert [g.shape for g in got] == [
        t.shape for t in (*t_ins[:5], t_ins[5])]
    # the workspace the launch is given is the chosen variant's
    assert ssd_scan.bwd_workspace_bytes(1, S, 4, 64, 128, BF16, 2,
                                        want) == (4096 if want == "chunked"
                                                  else 8192)


def test_the_default_workspace_is_the_chosen_variants(kernels):
    assert ssd_scan.bwd_workspace_bytes(2, 3072, 32, 64, 128, BF16) == 4096
    assert ssd_scan.bwd_workspace_bytes(2, 3072, 32, 64, 128, F32) == 8192
    assert ssd_scan.bwd_workspace_bytes(1, 100, 32, 64, 128, BF16) == 8192
