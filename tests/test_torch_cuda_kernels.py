"""The port's hand-written Hopper kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``cuda`` and skips
without an NVIDIA card (the decision is made inside a fixture, so every
pytest-xdist worker collects the same list).  Run them on a machine with
an H100:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances, inputs drawn with std 0.5 as in tests/test_kernels.py: the
largest absolute error is at most 1e-4 in float32 (TF32 off; the kernels
and the plain versions sum in different orders) and 2e-2 in bfloat16, and
every element's error is at most 1e-4 (float32) or 2e-2 (bfloat16) of
its scale ``|ref| + rms of ref's row`` (``plain.scaled_err``).  The second
rule is the one that binds in bfloat16: an output row that averages V
over thousands of keys is ~0.01 in size, under the absolute bound.  The
sound bf16 error is one rounding of the output (at most 2**-7 of |ref|)
plus the rounding of the probabilities to bf16 before the second product;
it reaches about half the scaled bound on an H100, while a dropped KV
tile at the 3072-token prefill gives a scaled error near 0.5 with its max
abs error under 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import memcom_xattn as mx
from repro_torch.kernels import ops, plain

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, dtype="float32", scale=0.5, device="cuda"):
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(device=device, dtype=getattr(torch, dtype))


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _assert_close(out, ref, dtype):
    e, s = _err(out, ref), plain.scaled_err(out, ref)
    assert e <= TOL[dtype] and s <= REL_TOL[dtype], (
        f"{dtype}: max abs err {e:.3e} (tol {TOL[dtype]:g}), scaled err "
        f"{s:.3e} (tol {REL_TOL[dtype]:g})")


ATTN_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, softcap)
    (1, 64, 64, 4, 4, 64, True, 0.0),     # MHA causal
    (2, 96, 96, 4, 2, 64, True, 0.0),     # GQA causal
    (2, 128, 128, 8, 1, 128, True, 50.0),  # MQA + softcap (gemma2)
    (1, 37, 53, 4, 2, 64, False, 0.0),    # cross, ragged shapes
    (2, 1, 80, 4, 2, 64, True, 0.0),      # decode row
    (1, 200, 100, 2, 2, 128, True, 0.0),  # Sq > Skv
    (1, 300, 300, 8, 4, 256, True, 50.0),  # gemma2-2b heads, prefill
    (4, 1, 556, 8, 4, 256, True, 50.0),    # gemma2-2b heads, decode
    (1, 9, 512, 8, 4, 256, False, 50.0),   # gemma2-2b prefix partial
    (1, 512, 512, 8, 4, 256, True, 50.0),  # gemma2-2b Memory-LLM, KV split
    (1, 3072, 3072, 8, 4, 256, True, 50.0),  # gemma2-2b source prefill
]


def _positions(case, device):
    B, Sq, Skv = case[:3]
    causal = case[6]
    if causal and Sq == 1:  # decode: ragged per-slot lengths
        q_pos = torch.tensor([[Skv - 30 - 7 * b] for b in range(B)],
                             dtype=torch.int32, device=device)
    else:
        q_pos = torch.arange(Sq, dtype=torch.int32, device=device)
        q_pos = q_pos.expand(B, Sq).contiguous()
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=device)
    kv_pos = kv_pos.expand(B, Skv).contiguous()
    return q_pos, kv_pos


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda, rng, case, dtype):
    B, Sq, Skv, Hq, Hkv, D, causal, softcap = case
    q = _rand(rng, B, Sq, Hq, D, dtype=dtype)
    k = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
    v = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
    q_pos, kv_pos = _positions(case, cuda)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  causal=causal, softcap=softcap,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                       causal=causal, softcap=softcap,
                                       return_lse=True)
    assert out.dtype == q.dtype and out.shape == (B, Sq, Hq, D)
    _assert_close(out, ref, dtype)
    assert _err(lse, ref_lse) <= TOL["float32"] * max(1.0, float(ref_lse.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fully_masked_rows(cuda, rng, dtype):
    """Rows that see no valid key give 0 and lse -1e30, like ref (the
    Pallas kernel returns a mean of V there)."""
    B, S, L, Hq, Hkv, D = 2, 3, 64, 8, 4, 256
    q = _rand(rng, B, S, Hq, D, dtype=dtype)
    k = _rand(rng, B, L, Hkv, D, dtype=dtype)
    v = _rand(rng, B, L, Hkv, D, dtype=dtype)
    lengths = torch.tensor([1, 5], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lengths=lengths, softcap=50.0)
    kv_pos = torch.arange(L, dtype=torch.int32, device=cuda).expand(B, L)
    q_pos = lengths[:, None] - S + torch.arange(S, dtype=torch.int32,
                                                device=cuda)[None]
    ref = plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos.contiguous(),
                              causal=True, softcap=50.0)
    assert float(out[0, :2].float().abs().max()) == 0.0
    _assert_close(out, ref, dtype)
    _, lse = fa.flash_attention(q, k, v, q_pos=q_pos.contiguous(),
                                kv_pos=kv_pos.contiguous(), return_lse=True)
    assert bool((lse[0, :2] == plain.NEG_INF).all())


@pytest.mark.parametrize("shape", [(1, 8, 40, 96), (2, 37, 129, 128),
                                   (3, 70, 200, 136), (1, 512, 3072, 2304)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memcom_xattn_matches_plain(cuda, rng, shape, dtype):
    B, M, T, D = shape
    q = _rand(rng, B, M, D, dtype=dtype)
    k = _rand(rng, B, T, D, dtype=dtype)
    v = _rand(rng, B, T, D, dtype=dtype)
    before = mx.launches
    out = mx.memcom_xattn(q, k, v)
    torch.cuda.synchronize()
    assert mx.launches == before + 1
    ref = plain.memcom_xattn_ref(q, k, v)
    assert out.dtype == q.dtype and out.shape == (B, M, D)
    _assert_close(out, ref, dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda, rng):
    q = _rand(rng, 1, 4, 2, 32)
    k = _rand(rng, 1, 8, 2, 32)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(NotImplementedError):  # Dv != D (MLA needs it later)
        fa.flash_attention(q, k, _rand(rng, 1, 8, 2, 16), q_pos=pos[:, :4],
                           kv_pos=pos)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), k.half(), q_pos=pos[:, :4],
                           kv_pos=pos)
    with pytest.raises(NotImplementedError):  # bf16 takes head dims 64/128/256
        qb, kb = q.bfloat16(), k.bfloat16()
        fa.flash_attention(qb, kb, kb, q_pos=pos[:, :4], kv_pos=pos)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k, k, q_pos=pos[:, :4],
                           kv_pos=pos)
    with pytest.raises(ValueError):  # v's T differs from k's
        mx.memcom_xattn(q[:, :, 0].contiguous(), k[:, :, 0].contiguous(),
                        k[:, :3, 0].contiguous())
    x = _rand(rng, 1, 4, 12, dtype="bfloat16")
    with pytest.raises(NotImplementedError):  # bf16 tensor cores: D % 8
        mx.memcom_xattn(x, x, x)
