"""``plain.attention_bwd_tiled`` — the wgmma flash backward's arithmetic
restated on the CPU (64-row tiles of G-folded query rows against 64-row
KV tiles, tile pairs with no visible pair skipped, P^T / dS^T and dS
rounded to bf16 before the second product, float32 sums one tile after
another, each KV tile's walk in the kernel's two halves) — against
``jax.vjp`` of the JAX package's oracles on the same
numpy inputs: ``ref.attention_ref``, and with an lse cotangent
``jnp_impl.attention_chunked(return_lse=True)`` (as
tests/test_torch_backward.py does).

Tolerances: without the rounding points (``round_p=False``) float32, the
largest error at most 2e-5 of max(1, the largest gradient); with them the
bf16 rule of the card tests, ``plain.grad_err`` at most 2e-2 per
gradient.  Rows that get no gradient by position (queries that see no
key, keys that no query sees) must be exactly 0 either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jnp_impl
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import plain

torch.set_num_threads(1)  # small shapes: threads only contend with xdist
TOL = 2e-5
BF16_TOL = 2e-2

# (B, Sq, Skv, Hq, Hkv, D, layout, softcap, dlse); layouts: "causal"
# (q_pos = kv_pos = arange), "offset" (both from 512), "prefix" (q at
# 512.., kv 0..Skv-1, non-causal), "masked" (the first queries sit before
# every key, holes in kv_pos, keys past the last query)
CASES = [
    (1, 80, 80, 4, 2, 64, "causal", 0.0, False),     # 3 query tiles, 2 KV
    (2, 40, 40, 4, 2, 128, "offset", 50.0, True),    # offset, lse cotangent
    (1, 70, 100, 4, 4, 64, "prefix", 0.0, True),     # prompt vs prefix
    (2, 45, 70, 8, 4, 256, "masked", 50.0, False),   # dead rows and keys
    (1, 70, 70, 6, 2, 64, "causal", 0.0, False),     # G 3, last tile 18 rows
    (1, 64, 96, 4, 2, 128, "prefix", 0.5, True),     # cap 0.5
    (1, 70, 70, 6, 2, 256, "causal", 0.5, True),     # G 3 at 256, cap 0.5
]


def _t(x):
    return torch.from_numpy(np.array(x))


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
    kv[:, 5:9] = -1
    return ar(-8, Sq), kv, True


def _case(rng, case):
    B, Sq, Skv, Hq, Hkv, D, layout, cap, with_dlse = case
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    dl = (rng.standard_normal((B, Sq, Hq)).astype(np.float32)
          if with_dlse else None)
    q_pos, kv_pos, causal = _positions(B, Sq, Skv, layout)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap)
    jkw = dict(q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
               causal=causal, softcap=cap)
    if dl is None:
        _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **jkw),
                         q, k, v)
        want = vjp(jnp.asarray(do))
    else:
        _, vjp = jax.vjp(lambda a, b, c: jnp_impl.attention_chunked(
            a, b, c, kv_chunk=16, return_lse=True, **jkw), q, k, v)
        want = vjp((jnp.asarray(do), jnp.asarray(dl)))
    tkw = dict(kw, q_pos=_t(q_pos), kv_pos=_t(kv_pos))
    o, lse = plain.attention_ref(_t(q), _t(k), _t(v), return_lse=True, **tkw)
    args = (_t(q), _t(k), _t(v), o, lse, _t(do),
            None if dl is None else _t(dl))
    split_at = [fa.bwd_mid(Sq, Skv, Hq, Hkv, causal, t)
                for t in range(-(-Skv // fa.BWD_TILE))]
    return args, tkw, split_at, [np.asarray(w) for w in want]


def _dead(tkw, B, Sq, Skv):
    """Queries that see no key, keys that no query sees."""
    q_pos, kv_pos = tkw["q_pos"], tkw["kv_pos"]
    seen = (kv_pos[:, None, :] >= 0).expand(B, Sq, Skv)
    if tkw["causal"]:
        seen = seen & (kv_pos[:, None, :] <= q_pos[:, :, None])
    return ~seen.any(dim=2), ~seen.any(dim=1)


@pytest.mark.parametrize("round_p", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_tiled_backward_matches_jax_vjp(rng, case, round_p):
    args, tkw, split_at, want = _case(rng, case)
    # every case has two query tiles or more: its KV walks split on a
    # card with SMs enough
    assert fa.bwd_split(*case[:6], True, 10 ** 6) == 2
    got = plain.attention_bwd_tiled(*args, round_p=round_p,
                                    split_at=split_at, **tkw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        if round_p:
            e = plain.grad_err(g, _t(w))
            assert e <= BF16_TOL, f"{name}: grad err {e:.3e}"
        else:
            bound = TOL * max(1.0, float(np.abs(w).max()))
            e = float(np.abs(g.numpy() - w).max())
            assert e <= bound, f"{name}: max abs err {e:.3e} > {bound:.3e}"
    dead_q, dead_kv = _dead(tkw, *case[:3])
    if case[6] == "masked":   # the case must have both kinds of dead row
        assert dead_q.any() and dead_kv.any()
    assert not got[0][dead_q].any()
    assert not got[1][dead_kv].any() and not got[2][dead_kv].any()


@pytest.mark.parametrize("case", CASES[:2])
def test_tiled_backward_without_rounding_is_the_plain_backward(rng, case):
    """Tiles and the halves of a KV walk change only the order of float32
    sums: against ``plain.attention_bwd_ref`` on the same inputs within
    1e-5, split or not."""
    args, tkw, split_at, _ = _case(rng, case)
    want = plain.attention_bwd_ref(*args, **tkw)
    for cut in (None, split_at):
        got = plain.attention_bwd_tiled(*args, round_p=False, split_at=cut,
                                        **tkw)
        for g, w in zip(got, want):
            bound = 1e-5 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= bound
