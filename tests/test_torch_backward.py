"""The plain backward versions the port's backward kernels are held to on
the card (``plain.attention_bwd_ref``, ``plain.memcom_xattn_bwd_ref``:
explicit formulas, not autograd) against ``jax.vjp`` of the JAX package's
oracles, and against ``torch.autograd`` of the port's plain forwards, on
the CPU in float32 with inputs from numpy.  Tolerance 1e-5 (as
tests/test_kernels.py), scaled by max(1, the gradient's largest value).

The kernels' wrappers take the plain backward for CPU tensors, and the
CUDA path's ``autograd.Function``s are not reachable here: the
``cuda``-marked tests in tests/test_torch_cuda_kernels.py hold the kernels
themselves to these functions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jnp_impl
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import memcom_xattn as mx
from repro_torch.kernels import ops, plain

torch.set_num_threads(1)  # small shapes: threads only contend with xdist
TOL = 1e-5


def _close(got, want):
    want = np.asarray(want, np.float32)
    bound = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= bound, f"max abs err {err:.3e} > {bound:.3e}"


def _t(x):
    return torch.from_numpy(np.asarray(x))


# (B, Sq, Skv, Hq, Hkv, D, layout, softcap); layout as in the card tests:
# "causal" (q_pos = kv_pos = arange), "offset" (both from 512), "prefix"
# (q at 512.., kv 0..Skv-1, non-causal), "masked" (rows before every key,
# holes in kv_pos)
CASES = [
    (2, 9, 9, 4, 2, 16, "causal", 0.0),
    (1, 7, 7, 6, 2, 8, "offset", 5.0),     # GQA + softcap
    (2, 5, 11, 4, 4, 16, "prefix", 0.0),
    (2, 6, 13, 4, 1, 8, "prefix", 3.0),    # MQA + softcap
    (2, 10, 12, 4, 2, 16, "masked", 2.0),
]


def _positions(B, Sq, Skv, layout):
    ar = lambda lo, n: np.broadcast_to(  # noqa: E731
        lo + np.arange(n, dtype=np.int32), (B, n)).copy()
    if layout == "causal":
        return ar(0, Sq), ar(0, Skv), True
    if layout == "offset":
        return ar(512, Sq), ar(512, Skv), True
    if layout == "prefix":
        return ar(512, Sq), ar(0, Skv), False
    kv = ar(0, Skv)
    kv[:, 3:5] = -1
    return ar(-4, Sq), kv, True


def _inputs(rng, case):
    B, Sq, Skv, Hq, Hkv, D, layout, cap = case
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    q_pos, kv_pos, causal = _positions(B, Sq, Skv, layout)
    return q, k, v, do, dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                             softcap=cap)


def _torch_kw(kw):
    return dict(kw, q_pos=_t(kw["q_pos"]), kv_pos=_t(kw["kv_pos"]))


@pytest.mark.parametrize("case", CASES)
def test_attention_bwd_ref_matches_jax_vjp(rng, case):
    q, k, v, do, kw = _inputs(rng, case)
    out, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, q_pos=jnp.asarray(kw["q_pos"]),
        kv_pos=jnp.asarray(kw["kv_pos"]), causal=kw["causal"],
        softcap=kw["softcap"]), q, k, v)
    want = vjp(jnp.asarray(do))
    tkw = _torch_kw(kw)
    o, lse = plain.attention_ref(_t(q), _t(k), _t(v), return_lse=True, **tkw)
    _close(o, out)
    got = plain.attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do), **tkw)
    for g, w in zip(got, want):
        _close(g, w)
    if case[6] == "masked":  # rows that see no key get no gradient
        assert float(got[0][_t(kw["q_pos"]) < 0].abs().max()) == 0.0


@pytest.mark.parametrize("case", [c for c in CASES if c[6] != "masked"])
def test_attention_bwd_ref_with_an_lse_cotangent(rng, case):
    """The lse cotangent (``attention_with_prefix`` merges two partials
    through their lse) against ``jax.vjp`` of the JAX package's streaming
    attention with ``return_lse``."""
    q, k, v, do, kw = _inputs(rng, case)
    dl = rng.standard_normal(q.shape[:3]).astype(np.float32)
    (_, _), vjp = jax.vjp(lambda a, b, c: jnp_impl.attention_chunked(
        a, b, c, q_pos=jnp.asarray(kw["q_pos"]),
        kv_pos=jnp.asarray(kw["kv_pos"]), causal=kw["causal"],
        softcap=kw["softcap"], kv_chunk=4, return_lse=True), q, k, v)
    want = vjp((jnp.asarray(do), jnp.asarray(dl)))
    tkw = _torch_kw(kw)
    o, lse = plain.attention_ref(_t(q), _t(k), _t(v), return_lse=True, **tkw)
    got = plain.attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                                  _t(dl), **tkw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_attention_bwd_ref_matches_autograd_of_the_plain_forward(rng, case):
    """The explicit formulas against autograd of ``plain.attention_ref``
    (out and lse both carrying a cotangent; a row that sees no key has no
    lse to differentiate, so its cotangent is 0)."""
    q, k, v, do, kw = _inputs(rng, case)
    tkw = _torch_kw(kw)
    xs = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = plain.attention_ref(*xs, return_lse=True, **tkw)
    live = lse > plain.NEG_INF / 2
    dl = torch.where(live, _t(rng.standard_normal(q.shape[:3])).float(), 0.0)
    loss = (o * _t(do)).sum() + (torch.where(live, lse, 0.0) * dl).sum()
    want = torch.autograd.grad(loss, xs)
    got = fa.flash_attention_bwd(*(x.detach() for x in xs), o.detach(),
                                 lse.detach(), _t(do), dl, **tkw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", [(2, 5, 13, 16), (1, 8, 7, 24)])
def test_memcom_xattn_bwd_ref_matches_jax_vjp_and_autograd(rng, shape):
    B, M, T, D = shape
    q, do = (rng.standard_normal((B, M, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, D)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(jref.memcom_xattn_ref, q, k, v)
    want = vjp(jnp.asarray(do))
    out, lse = mx.memcom_xattn(_t(q), _t(k), _t(v), return_lse=True)
    got = mx.memcom_xattn_bwd(_t(q), _t(k), _t(v), out, lse, _t(do))
    for g, w in zip(got, want):
        _close(g, w)
    xs = [_t(x).requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad((ops.memcom_xattn(*xs) * _t(do)).sum(), xs)
    for g, w in zip(got, auto):
        _close(g, w)


def test_cpu_tensors_take_the_plain_path_with_autograd(rng):
    """A CPU call through ``ops`` is differentiable by the plain versions'
    own autograd and launches nothing: the backward counters stay put."""
    q = _t(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    q.requires_grad_(True)
    before = (fa.bwd_launches, mx.bwd_launches)
    out = ops.self_attention_causal(q, q, q)
    x = ops.memcom_xattn(q[:, :, 0], q[:, :, 1], q[:, :, 1])
    (out.sum() + x.sum()).backward()
    assert q.grad is not None and float(q.grad.abs().max()) > 0
    assert (fa.bwd_launches, mx.bwd_launches) == before


def test_autograd_functions_route_the_gradient_through_the_backward(
        rng, monkeypatch):
    """The CUDA path's ``autograd.Function``s, exercised on the CPU with
    their kernel calls swapped for the plain versions: every input gets
    the plain autograd's gradient (out and lse cotangents both reach the
    flash backward through ``attention_with_prefix``'s merge), each
    backward runs once per call, and dq is skipped when q needs none."""
    calls = []
    attention_ref, xattn_ref = plain.attention_ref, plain.memcom_xattn_ref

    def fwd(q, k, v, q_pos, kv_pos, causal, softcap, scale, variant):
        return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                   causal=causal, softcap=softcap,
                                   scale=scale, return_lse=True)

    def bwd(*a, need_dq=True, **kw):
        calls.append(("flash", need_dq))
        dq, dk, dv = plain.attention_bwd_ref(*a, **kw)
        return (dq if need_dq else None), dk, dv

    def xfwd(q, k, v, scale, variant):
        return xattn_ref(q, k, v, scale=scale, return_lse=True)

    def xbwd(q, k, v, out, lse, dout, **kw):
        calls.append(("xattn", True))
        return plain.memcom_xattn_bwd_ref(q, k, v, dout, **kw)

    monkeypatch.setattr(fa, "_forward", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(mx, "_forward", xfwd)
    monkeypatch.setattr(mx, "memcom_xattn_bwd", xbwd)
    B, S, m, Hq, Hkv, D = 2, 5, 7, 4, 2, 8
    shapes = [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, m, Hkv, D),
              (B, m, Hkv, D), (B, m, 16), (B, 9, 16), (B, 9, 16)]
    leaves = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    w_o = _t(rng.standard_normal((B, S, Hq, D)).astype(np.float32))
    w_x = _t(rng.standard_normal((B, m, 16)).astype(np.float32))

    def attention(q, k, v, **kw):
        out, lse = fa.FlashAttention.apply(
            q, k, v, kw["q_pos"], kw["kv_pos"], kw["causal"], kw["softcap"],
            kw["scale"], None)
        return (out, lse) if kw.get("return_lse") else out

    def run(via_functions, frozen_q=False):
        xs = [t.clone().requires_grad_(not (frozen_q and i == 0))
              for i, t in enumerate(leaves)]
        with monkeypatch.context() as mp:
            if via_functions:
                mp.setattr(plain, "attention_ref", attention)
                mp.setattr(plain, "memcom_xattn_ref",
                           lambda q, k, v, scale=None: mx.MemcomXattn.apply(
                               q, k, v, scale, None)[0])
            o = ops.attention_with_prefix(*xs[:5], softcap=3.0, impl="torch")
            x = ops.memcom_xattn(*xs[5:], impl="torch")
        loss = (o * w_o).sum() + (x * w_x).sum()
        used = [t for t in xs if t.requires_grad]
        return torch.autograd.grad(loss, used)

    want = run(False)
    got = run(True)
    assert sorted(calls) == [("flash", True), ("flash", True),
                             ("xattn", True)]
    for g, w in zip(got, want):
        _close(g, w)
    calls.clear()
    got = run(True, frozen_q=True)
    assert sorted(calls) == [("flash", False), ("flash", False),
                             ("xattn", True)]
    for g, w in zip(got, run(False, frozen_q=True)):
        _close(g, w)


def _causal_grads(S=512, D=64):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, S, n, D, generator=g) * 0.5
                   for n in (2, 1, 1, 2))
    pos = torch.arange(S, dtype=torch.int32)[None]
    kw = dict(q_pos=pos, kv_pos=pos, causal=True, softcap=50.0)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    return plain.attention_bwd_ref(q, k, v, out, lse, do, None, **kw)


@pytest.mark.parametrize("where", ["first_q_tile", "last_keys"])
def test_grad_err_catches_a_fault_confined_to_small_rows(where):
    """``plain.grad_err`` (the card's bf16 gradient yardstick) catches an
    error of 5% of each row's own size that touches only the first
    64-query tile of dq, or only dk/dv of the last 8 keys of a causal
    sequence (seen by the fewest queries, so the smallest true rows, a few
    hundredths of the tensor's rms)."""
    dq, dk, dv = _causal_grads()
    sign = torch.where(torch.arange(64) % 2 == 0, 1.0, -1.0)
    for t in ((dq,) if where == "first_q_tile" else (dk, dv)):
        rows = slice(1, 64) if where == "first_q_tile" else slice(-8, None)
        bad = t.clone()
        part = bad[:, rows]
        bad[:, rows] = part + 0.05 * sign * part.pow(2).mean(
            -1, keepdim=True).sqrt()
        assert plain.grad_err(bad, t) > 2e-2
        assert plain.grad_err(t, t) == 0.0


def test_grad_err_forgives_only_the_float32_noise_of_one_key_rows():
    """The dq row of a query that sees one key is float32 noise (~1e-5 of
    the tensor's rms): a difference of a few times that passes
    ``grad_err`` though ``scaled_err`` reads it as more than 1; no other
    row of the causal gradients lies below the noise floor, and the same
    difference on any other row is read as it is."""
    dq, dk, dv = _causal_grads()
    rms = dq.pow(2).mean().sqrt()
    row = dq.pow(2).mean(-1).sqrt() / rms
    below = row < plain.GRAD_NOISE_FLOOR
    assert below[:, 0].all() and not below[:, 1:].any()
    assert float(row[:, 0].max()) < 1e-4
    for t in (dk, dv):
        r = t.pow(2).mean(-1).sqrt() / t.pow(2).mean().sqrt()
        assert float(r.min()) > plain.GRAD_NOISE_FLOOR / 2
    noisy = dq.clone()
    noisy[:, 0] += 3e-5 * rms
    assert plain.scaled_err(noisy, dq) > 1.0
    assert plain.grad_err(noisy, dq) <= 2e-2
    shifted = dq.clone()
    shifted[:, 1] += 0.05 * dq[:, 1].pow(2).mean(-1, keepdim=True).sqrt()
    assert plain.grad_err(shifted, dq) > 2e-2



def test_memcom_xattn_function_centres_values_and_keys_in_bf16(monkeypatch):
    """``mx.MemcomXattn`` runs the kernels on values centred over T (the
    mean added back to the output) and the backward on keys centred over
    T (the lse moved to match): exact in exact arithmetic, and needed in
    bf16, where the backward's D_i = rowsum(dO o O) from the rounded O
    carries the rounding of the values' common part and dQ multiplies the
    resulting row-sum error of dS by the keys' common part.  With keys,
    values and a source that share large common parts (as a raw residual
    stream does) and the kernels' arithmetic in their place (the plain
    forward, ``plain.memcom_xattn_bwd_tiled``: P and dS rounded to bf16):
    on raw inputs dQ and a weight gradient src^T dK are off the float32
    gradient by more than their own size (measured 10.3 and 8.4); through
    the Function every gradient is within 2x the plain bf16 backward's own
    error (measured dQ 3.9e-3 against 2.3e-3, dK 3.3e-3 / 3.1e-3, dV 3.6e-3
    / 2.0e-3, src^T dK 3.5e-2 / 2.4e-2)."""
    g = torch.Generator().manual_seed(0)
    B, M, T, D = 2, 64, 512, 64
    bf = torch.bfloat16
    common = torch.randn(1, 1, D, generator=g) * 4
    q = (torch.randn(B, M, D, generator=g) * 0.5).to(bf)
    k = (torch.randn(B, T, D, generator=g) * 0.5 + common).to(bf)
    v = (torch.randn(B, T, D, generator=g) * 0.5 + 2 * common).to(bf)
    dout = (torch.randn(B, M, D, generator=g) * 0.5).to(bf)
    src = torch.randn(B, T, D, generator=g) + 8 * torch.randn(
        1, 1, D, generator=g)

    def fwd(q_, k_, v_, scale, variant):
        return plain.memcom_xattn_ref(q_, k_, v_, scale=scale,
                                      return_lse=True)

    def bwd(q_, k_, v_, out, lse, dout_, scale=None):
        return plain.memcom_xattn_bwd_tiled(q_, k_, v_, out, lse, dout_,
                                            scale=scale)

    monkeypatch.setattr(mx, "_forward", fwd)
    monkeypatch.setattr(mx, "memcom_xattn_bwd", bwd)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = mx.MemcomXattn.apply(*xs, None, None)[0]
    got = torch.autograd.grad(out, xs, dout)
    raw = bwd(q, k, v, *fwd(q, k, v, None, None), dout)
    want = plain.memcom_xattn_bwd_ref(q.float(), k.float(), v.float(),
                                      dout.float())
    bf16 = plain.memcom_xattn_bwd_ref(q, k, v, dout)

    def rel(a, b):
        return float((a.float() - b).abs().max() / b.abs().max())

    def wgrad(dk):
        return torch.einsum("btd,bte->de", src, dk.float())

    assert rel(out, fwd(q.float(), k.float(), v.float(), None, None)[0]) \
        <= 2 ** -8
    assert rel(raw[0], want[0]) > 1
    assert rel(wgrad(raw[1]), wgrad(want[1])) > 1
    for a, b, w in zip(got, bf16, want):
        assert rel(a, w) <= 2 * rel(b, w)
    assert rel(wgrad(got[1]), wgrad(want[1])) \
        <= 2 * rel(wgrad(bf16[1]), wgrad(want[1]))
