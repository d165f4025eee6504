"""The port's plain kernel versions (the CPU path of every kernel wrapper)
against the JAX package's oracles (``repro/kernels/ref.py``) and its Pallas
kernels run in interpret mode, on the same numpy inputs.

Tolerance: float32 2e-5, as ``tests/test_kernels.py`` holds the Pallas
kernels to the oracles.  Fully-masked query rows are held to the oracle
only: the Pallas flash kernel returns a mean of V there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import jnp_impl, ref
from repro.kernels import memcom_xattn as jmx
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import memcom_xattn as mx
from repro_torch.kernels import ops, plain, registry

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
TOL = 2e-5

# the shapes of tests/test_kernels.py::ATTN_CASES
ATTN_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, softcap)
    (1, 64, 64, 4, 4, 32, True, 0.0),     # MHA causal
    (2, 96, 96, 4, 2, 64, True, 0.0),     # GQA causal
    (2, 128, 128, 8, 1, 32, True, 50.0),  # MQA + softcap (gemma2)
    (1, 37, 53, 4, 2, 64, False, 0.0),    # cross, ragged shapes
    (2, 1, 80, 4, 2, 64, True, 0.0),      # decode row
    (1, 200, 100, 2, 2, 128, True, 0.0),  # Sq > Skv
]

# gemma2's softcap on the decode row and on the ragged cross shapes
CAPPED_CASES = [(2, 1, 80, 4, 2, 64, True, 50.0),
                (1, 37, 53, 4, 2, 64, False, 50.0)]

XATTN_CASES = [(1, 8, 64, 64), (2, 48, 100, 64), (2, 32, 128, 256),
               (1, 17, 33, 128)]


def _inputs(rng, case):
    B, Sq, Skv, Hq, Hkv, D, causal, _ = case
    q = (rng.standard_normal((B, Sq, Hq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Skv, Hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Skv, Hkv, D)) * 0.5).astype(np.float32)
    if causal and Sq == 1:  # decode: q sits at the cache frontier
        q_pos = np.full((B, Sq), Skv - 30, np.int32)
        kv_pos = np.where(np.arange(Skv) < Skv - 29, np.arange(Skv), -1)
        kv_pos = np.broadcast_to(kv_pos, (B, Skv)).astype(np.int32)
    else:
        q_pos = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
        kv_pos = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32)
    return q, k, v, q_pos, kv_pos


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", ATTN_CASES + CAPPED_CASES)
def test_plain_attention_matches_ref_and_pallas(rng, case):
    causal, softcap = case[6], case[7]
    q, k, v, q_pos, kv_pos = _inputs(rng, case)
    out, lse = ops.attention(_t(q), _t(k), _t(v), q_pos=_t(q_pos),
                             kv_pos=_t(kv_pos), causal=causal,
                             softcap=softcap, return_lse=True)
    want = ref.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                             causal=causal, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    o_pal, l_pal = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=q_pos,
        kv_pos=kv_pos, causal=causal, softcap=softcap, block_q=32,
        block_k=32, return_lse=True, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pal), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(l_pal), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_fully_masked_rows_are_zero_like_ref(rng, softcap):
    """decode_attention with S=3 and lengths [1, 5]: slot 0's first two
    rows see no key.  The oracle gives them 0 (and lse -1e30); so must the
    port."""
    B, S, L, Hq, Hkv, D = 2, 3, 24, 4, 2, 16
    q = (rng.standard_normal((B, S, Hq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, L, Hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, L, Hkv, D)) * 0.5).astype(np.float32)
    lengths = np.asarray([1, 5], np.int32)
    out = ops.decode_attention(_t(q), _t(k), _t(v), lengths=_t(lengths),
                               softcap=softcap)
    q_pos = lengths[:, None] - S + np.arange(S, dtype=np.int32)[None]
    kv_pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    want = ref.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                             softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert np.all(out.numpy()[0, :2] == 0)
    _, lse = plain.attention_ref(_t(q), _t(k), _t(v), q_pos=_t(q_pos),
                                 kv_pos=_t(kv_pos), softcap=softcap,
                                 return_lse=True)
    assert np.all(lse.numpy()[0, :2] == plain.NEG_INF)


def test_attention_with_prefix_is_exact(rng):
    """Prefix + self through the LSE merge equals dense attention over the
    concatenated [prefix ; self] sequence."""
    B, S, m, Hq, Hkv, D = 2, 48, 16, 4, 2, 32
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    q, k_self, v_self = r(B, S, Hq, D), r(B, S, Hkv, D), r(B, S, Hkv, D)
    k_pre, v_pre = r(B, m, Hkv, D), r(B, m, Hkv, D)
    out = ops.attention_with_prefix(_t(q), _t(k_self), _t(v_self),
                                    _t(k_pre), _t(v_pre), softcap=50.0)
    kv_pos = np.concatenate([np.broadcast_to(np.arange(m), (B, m)),
                             np.broadcast_to(m + np.arange(S), (B, S))],
                            axis=1).astype(np.int32)
    q_pos = np.broadcast_to(m + np.arange(S), (B, S)).astype(np.int32)
    want = ref.attention_ref(q, np.concatenate([k_pre, k_self], 1),
                             np.concatenate([v_pre, v_self], 1), q_pos=q_pos,
                             kv_pos=kv_pos, causal=True, softcap=50.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_combine_partials_matches_jnp_impl(rng):
    B, S, H, Dv = 2, 5, 3, 8
    parts = [((rng.standard_normal((B, S, H, Dv))).astype(np.float32),
              (rng.standard_normal((B, S, H)) * 3).astype(np.float32))
             for _ in range(3)]
    parts[1][1][0, 0, 0] = plain.NEG_INF  # an empty partial contributes 0
    got = plain.combine_attention_partials([(_t(o), _t(l)) for o, l in parts])
    want = jnp_impl.combine_attention_partials(
        [(jnp.asarray(o), jnp.asarray(l)) for o, l in parts])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case", XATTN_CASES)
def test_plain_memcom_xattn_matches_ref_and_pallas(rng, case):
    B, M, T, D = case
    q = (rng.standard_normal((B, M, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    out = ops.memcom_xattn(_t(q), _t(k), _t(v))
    want = ref.memcom_xattn_ref(q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    o_pal = jmx.memcom_xattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_m=16, block_t=32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pal), atol=TOL,
                               rtol=TOL)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    """On the CPU a wrapper runs the plain version and counts no launch;
    impl="cuda" on a CPU tensor is refused, not quietly served."""
    q = _t((rng.standard_normal((1, 4, 2, 8))).astype(np.float32))
    pos = torch.arange(4, dtype=torch.int32)[None]
    before = (fa.launches, mx.launches)
    fa.flash_attention(q, q, q, q_pos=pos, kv_pos=pos)
    mx.memcom_xattn(q[:, :, 0], q[:, :, 0], q[:, :, 0])
    assert (fa.launches, mx.launches) == before
    with pytest.raises(ValueError):
        ops.attention(q, q, q, q_pos=pos, kv_pos=pos, impl="cuda")
    with pytest.raises(ValueError):
        ops.set_default_impl("pallas")


def test_set_default_impl_forces_the_plain_version(monkeypatch, rng):
    calls = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append("kernel"))
    q = _t((rng.standard_normal((1, 4, 2, 8))).astype(np.float32))
    pos = torch.arange(4, dtype=torch.int32)[None]
    ops.set_default_impl("torch")
    try:
        ops.attention(q, q, q, q_pos=pos, kv_pos=pos)
    finally:
        ops.set_default_impl(None)
    assert calls == []
    ops.attention(q, q, q, q_pos=pos, kv_pos=pos)
    assert calls == ["kernel"]


def test_registry_names_each_kernel_its_plain_twin_and_pallas_source():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    for key, entry in registry.KERNELS.items():
        kernel, twin = registry.resolve(key)
        assert callable(kernel) and callable(twin)
        assert (root / entry["source"]).is_file()
        path, line = entry["replaces"].split(":")
        text = (root / path).read_text().splitlines()
        assert text[int(line) - 1].startswith("def "), entry["replaces"]


def test_scaled_err_catches_a_dropped_kv_tile_that_max_abs_misses(rng):
    """The bf16 kernel checks on the card hold the error to the reference's
    own scale: a causal row that loses one 32-key tile out of ~1000 keys
    moves by less than the 2e-2 absolute bound, but by far more than 2e-2
    of |ref| + the row's rms; one rounding to bf16 stays inside it, and a
    row that sees no key must be exactly 0."""
    S, H, D = 1024, 2, 64
    q, k, v = (_t((rng.standard_normal((1, S, H, D)) * 0.5).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32)[None]
    good = plain.attention_ref(q, k, v, q_pos=pos, kv_pos=pos)
    dropped = pos.clone()
    dropped[:, 768:800] = -1
    bad = plain.attention_ref(q, k, v, q_pos=pos, kv_pos=dropped)
    assert float((bad - good).abs().max()) < 2e-2
    assert plain.scaled_err(bad, good) > 0.1
    assert plain.scaled_err(good.bfloat16(), good) <= 2.0 ** -8
    zero = torch.zeros(2, D)
    assert plain.scaled_err(zero, zero) == 0.0
    assert plain.scaled_err(zero + 1e-9, zero) == float("inf")
