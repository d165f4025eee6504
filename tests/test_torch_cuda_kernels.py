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
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import ops, plain
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan

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


# MLA's (key, value) widths: the non-absorbed prefill (192, 128) with its
# 128 heads cut to 16, causal and a prompt against a 1024-row prefix; the
# absorbed decode (576, 512) with 128 query heads on one latent head, one
# and four lanes a slot behind ragged lengths.  Scale 192 ** -0.5, as MLA
# passes it.
DV_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, Dv, kind, dtypes)
    (1, 300, 300, 16, 16, 192, 128, "causal", ("float32", "bfloat16")),
    (1, 12, 1024, 16, 16, 192, 128, "prefix", ("float32", "bfloat16")),
    (4, 1, 1100, 128, 1, 576, 512, "decode", ("bfloat16",)),
    (4, 4, 1100, 128, 1, 576, 512, "decode", ("bfloat16",)),
    (1, 64, 64, 128, 1, 576, 512, "causal", ("bfloat16",)),
]


@pytest.mark.parametrize("case", DV_CASES)
def test_flash_attention_dv_pairs_match_plain(cuda, rng, case):
    B, Sq, Skv, Hq, Hkv, D, Dv, kind, dtypes = case
    ar = torch.arange(max(Sq, Skv), dtype=torch.int32, device=cuda)
    kv_pos = ar[:Skv].expand(B, Skv).contiguous()
    if kind == "decode":  # each slot's last Sq rows behind its length
        lens = torch.tensor([Skv - 7 * b for b in range(B)], device=cuda)
        q_pos = (lens[:, None] - Sq + ar[None, :Sq]).to(torch.int32)
    elif kind == "prefix":
        q_pos = (Skv + ar[:Sq]).expand(B, Sq).contiguous()
    else:
        q_pos = ar[:Sq].expand(B, Sq).contiguous()
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=kind != "prefix",
              scale=192 ** -0.5, return_lse=True)
    for dtype in dtypes:
        q = _rand(rng, B, Sq, Hq, D, dtype=dtype)
        k = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
        v = _rand(rng, B, Skv, Hkv, Dv, dtype=dtype)
        ref, ref_lse = plain.attention_ref(q, k, v, **kw)
        # bf16 (192, 128): both kernels, each forced; (576, 512): mma.sync
        wg = dtype == "bfloat16" and fa.wgmma_takes(torch.bfloat16, D, Skv,
                                                    Dv)
        for var in ((None, "wgmma", "mma_sync") if wg else (None,)):
            before = fa.launches, fa.wgmma_launches
            out, lse = fa.flash_attention(q, k, v, variant=var, **kw)
            torch.cuda.synchronize()
            picked = var or fa.variant_for(
                q.dtype, D, Skv, fa._splits(B, Sq, Skv, Hq, Hkv, 0), Dv)
            assert (fa.launches, fa.wgmma_launches) == (
                before[0] + 1, before[1] + (picked == "wgmma"))
            assert out.dtype == q.dtype and out.shape == (B, Sq, Hq, Dv)
            _assert_close(out, ref, dtype)
            assert _err(lse, ref_lse) <= TOL["float32"] * max(
                1.0, float(ref_lse.abs().max()))
        if dtype == "bfloat16" and not wg:
            with pytest.raises(NotImplementedError):
                fa.flash_attention(q, k, v, variant="wgmma", **kw)


def test_flash_attention_dv_refuses_a_gradient(cuda, rng):
    """At (576, 512) (MLA's absorbed decode, which serves only) no backward
    kernel exists: a call that needs a gradient raises before the forward
    runs, and the backward raises; at (192, 128) such a call runs both
    directions on the wgmma kernels."""
    q = _rand(rng, 1, 8, 16, 576, dtype="bfloat16").requires_grad_()
    k = _rand(rng, 1, 8, 1, 576, dtype="bfloat16")
    v = _rand(rng, 1, 8, 1, 512, dtype="bfloat16")
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    before = fa.launches
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, q_pos=pos, kv_pos=pos)
    assert fa.launches == before
    out, lse = fa.flash_attention(q.detach(), k, v, q_pos=pos, kv_pos=pos,
                                  return_lse=True)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_bwd(q.detach(), k, v, out, lse, out, q_pos=pos,
                               kv_pos=pos)
    q = _rand(rng, 1, 8, 4, 192, dtype="bfloat16").requires_grad_()
    k = _rand(rng, 1, 8, 4, 192, dtype="bfloat16")
    v = _rand(rng, 1, 8, 4, 128, dtype="bfloat16")
    before = fa.wgmma_launches, fa.bwd_wgmma_launches
    fa.flash_attention(q, k, v, q_pos=pos, kv_pos=pos).float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.wgmma_launches, fa.bwd_wgmma_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert q.grad.shape == q.shape and bool(q.grad.isfinite().all())


@pytest.mark.parametrize("n,mn_major", [(64, False), (64, True),
                                        (128, True), (256, True)])
def test_wgmma_tile_product_matches_matmul(cuda, rng, n, mn_major):
    """One 64 x n x 64 product through csrc/wgmma_sm90.cuh: at n = 64 B
    K-major (A from shared memory) and B MN-major (A from registers), the
    two forms flash_fwd_wgmma uses; at n = 128 and 256 B MN-major with A
    from shared memory (mma_ss_n), the forms gmm_wgmma uses.  f32 sums of
    64 bf16 products: 1e-4."""
    a = _rand(rng, 64, 64, dtype="bfloat16")
    b = _rand(rng, *((64, n) if mn_major else (n, 64)), dtype="bfloat16")
    c = fa.wgmma_tile_check(a, b, b_mn_major=mn_major, n=n)
    torch.cuda.synchronize()
    ref = a.float() @ (b.float() if mn_major else b.float().T)
    assert _err(c, ref) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("n", [96, 128, 256])
def test_wgmma_wide_forms_match_matmul(cuda, rng, n):
    """The K-major form of csrc/wgmma_sm90.cuh's mma_ss_n: B K-major at n =
    96 / 128 / 256 with A from shared memory (xattn_bwd_sdp_wgmma's and
    xattn_logits_wgmma's).  f32 sums of 64 bf16 products: 1e-4."""
    a = _rand(rng, 64, 64, dtype="bfloat16")
    b = _rand(rng, n, 64, dtype="bfloat16")
    c = fa.wgmma_tile_check(a, b, b_mn_major=False, n=n)
    torch.cuda.synchronize()
    ref = a.float() @ b.float().T
    assert _err(c, ref) <= 1e-4 * max(1.0, float(ref.abs().max()))


def _wgmma_positions(kind, B, Sq, Skv, device):
    q_pos = torch.arange(Sq, dtype=torch.int32, device=device).expand(B, Sq)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=device).expand(B, Skv)
    if kind == "offset":  # a prompt behind Skv - Sq earlier positions
        q_pos = q_pos + (Skv - Sq)
    elif kind == "holes":  # -1 inside tiles: the masked class
        gen = torch.Generator(device="cpu").manual_seed(3)
        drop = (torch.rand(B, Skv, generator=gen) < 0.15).to(device)
        kv_pos = torch.where(drop, -1, kv_pos)
        q_pos = q_pos + (Skv - Sq)
    return q_pos.contiguous(), kv_pos.contiguous()


WGMMA_CASES = [c + ("arange",) for c in ATTN_CASES
               if fa.wgmma_takes(torch.bfloat16, c[5], c[2])] + [
    # (B, Sq, Skv, Hq, Hkv, D, causal, softcap, positions)
    (1, 70, 70, 24, 8, 64, True, 0.0, "arange"),   # G = 3, Sq*G % 64 != 0
    (1, 3072, 3072, 24, 8, 64, True, 0.0, "arange"),  # granite source prefill
    (1, 100, 130, 8, 4, 256, True, 50.0, "arange"),  # Skv % 64 != 0
    (2, 96, 200, 8, 4, 256, True, 50.0, "holes"),
    (1, 90, 150, 24, 8, 64, False, 0.0, "holes"),
    (1, 16, 528, 8, 4, 256, True, 50.0, "offset"),   # a prompt at offset 512
    (1, 16, 528, 24, 8, 64, True, 0.0, "offset"),
    (1, 6144, 6144, 32, 8, 128, True, 0.0, "arange"),  # mistral-7b prefill
]


@pytest.mark.parametrize("case", WGMMA_CASES)
@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
def test_flash_bf16_variants_match_plain(cuda, rng, case, variant):
    """Both bf16 kernels, each launched through its entry point, at every
    shape the wgmma variant takes."""
    B, Sq, Skv, Hq, Hkv, D, causal, softcap, kind = case
    q = _rand(rng, B, Sq, Hq, D, dtype="bfloat16")
    k = _rand(rng, B, Skv, Hkv, D, dtype="bfloat16")
    v = _rand(rng, B, Skv, Hkv, D, dtype="bfloat16")
    if kind == "arange":
        q_pos, kv_pos = _positions(case[:8], cuda)
    else:
        q_pos, kv_pos = _wgmma_positions(kind, B, Sq, Skv, cuda)
    before = (fa.launches, fa.wgmma_launches)
    out, lse = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  causal=causal, softcap=softcap,
                                  return_lse=True, variant=variant)
    torch.cuda.synchronize()
    assert (fa.launches, fa.wgmma_launches) == (
        before[0] + 1, before[1] + (variant == "wgmma"))
    ref, ref_lse = plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                       causal=causal, softcap=softcap,
                                       return_lse=True)
    _assert_close(out, ref, "bfloat16")
    live = ref_lse > plain.NEG_INF / 2
    assert bool((lse[~live] == plain.NEG_INF).all())
    assert _err(lse[live], ref_lse[live]) <= TOL["float32"] * max(
        1.0, float(ref_lse[live].abs().max()))


def test_flash_wgmma_fully_masked_rows(cuda, rng):
    """Rows that see no key give 0 and lse -1e30 in the wgmma variant."""
    B, S, L, Hq, Hkv, D = 2, 40, 64, 8, 4, 256
    q = _rand(rng, B, S, Hq, D, dtype="bfloat16")
    k = _rand(rng, B, L, Hkv, D, dtype="bfloat16")
    v = _rand(rng, B, L, Hkv, D, dtype="bfloat16")
    q_pos = (torch.arange(S, dtype=torch.int32, device=cuda) - 3).expand(B, S)
    kv_pos = torch.arange(L, dtype=torch.int32, device=cuda).expand(B, L)
    q_pos, kv_pos = q_pos.contiguous(), kv_pos.contiguous()
    out, lse = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  softcap=50.0, return_lse=True,
                                  variant="wgmma")
    ref = plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                              softcap=50.0)
    assert float(out[:, :3].float().abs().max()) == 0.0
    assert bool((lse[:, :3] == plain.NEG_INF).all())
    _assert_close(out, ref, "bfloat16")


def test_flash_dispatch_sends_prefill_to_wgmma(cuda, rng):
    """The unsplit bf16 prefill and the Memory-LLM's (4 KV splits) go to
    the wgmma variant by default; decode over 4 slots (9 splits) does
    not."""
    for (B, Sq, Skv, Hq, Hkv, D), wgmma in (((1, 3072, 3072, 24, 8, 64), True),
                                            ((1, 512, 512, 8, 4, 256), True),
                                            ((4, 1, 568, 8, 4, 256), False)):
        q = _rand(rng, B, Sq, Hq, D, dtype="bfloat16")
        k = _rand(rng, B, Skv, Hkv, D, dtype="bfloat16")
        pos = torch.arange(Skv, dtype=torch.int32, device=cuda).expand(B, Skv)
        before = fa.wgmma_launches
        fa.flash_attention(q, k, k, q_pos=pos[:, Skv - Sq:].contiguous(),
                           kv_pos=pos.contiguous())
        assert fa.wgmma_launches == before + wgmma


def test_flash_wgmma_rejects_what_it_does_not_take(cuda, rng):
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    q = _rand(rng, 1, 8, 4, 64)
    with pytest.raises(NotImplementedError):  # float32
        fa.flash_attention(q, q, q, q_pos=pos, kv_pos=pos, variant="wgmma")
    with pytest.raises(NotImplementedError):  # float32 has no mma.sync kernel
        fa.flash_attention(q, q, q, q_pos=pos, kv_pos=pos, variant="mma_sync")
    qb = _rand(rng, 1, 8, 4, 64, dtype="bfloat16")
    kb = _rand(rng, 1, fa.WGMMA_MAX_SKV + 1, 4, 64, dtype="bfloat16")
    long_pos = torch.arange(kb.shape[1], dtype=torch.int32, device=cuda)[None]
    with pytest.raises(NotImplementedError):  # Skv past the tile table
        fa.flash_attention(qb, kb, kb, q_pos=pos, kv_pos=long_pos,
                           variant="wgmma")
    with pytest.raises(ValueError):
        fa.flash_attention(qb, qb, qb, q_pos=pos, kv_pos=pos, variant="tma")


XATTN_SHAPES = [(1, 8, 40, 96), (2, 37, 129, 128), (3, 70, 200, 136),
                (1, 512, 3072, 2304),
                (2, 512, 3077, 1536),   # B 2 at granite's width, ragged T
                (1, 768, 6144, 4096)]   # mistral-7b's m = 768 (a probe)
XATTN_CASES = [
    *((shape, "float32", None) for shape in XATTN_SHAPES[:4]),
    *((shape, "bfloat16", var) for shape in XATTN_SHAPES
      for var in (None, "wgmma", "mma_sync")
      if var is None or mx.takes(var, torch.bfloat16, *shape, True)),
]


def _xattn_inputs(rng, shape, dtype, spread=False):
    """q, k, v drawn with std 0.5; ``spread``: every row's logits over the
    first 128 keys sit ~150 above the rest, and rows 1, 3, ... also see
    keys 300-427 that high (their tiles' maxima differ by more than 100,
    so the wgmma kernel's scale of the low tiles is 0)."""
    B, M, T, D = shape
    q = _rand(rng, B, M, D)
    k = _rand(rng, B, T, D)
    v = _rand(rng, B, T, D)
    if spread:  # scale D**-0.5: q[...,0] k[...,0] / sqrt(D) = 150
        q[..., 0] = 8.0
        k[:, :128, 0] = 150.0 * D ** 0.5 / 8.0
        q[:, 1::2, 1] = 8.0
        k[:, 300:428, 1] = 150.0 * D ** 0.5 / 8.0
    dt = getattr(torch, dtype)
    return q.to(dt), k.to(dt), v.to(dt)


# The wgmma kernel against its own arithmetic, plain.memcom_xattn_tiled in
# float32, in bf16 steps (plain.bf16_ulps).  Its last rounding of O gives
# up to 0.5; the logits' float32 sums, in another order than the
# restatement's, move a few P~ and c_j P~ across a bf16 rounding boundary
# (one step of one element of P each): up to 0.585 on the card.  Taken
# without its two roundings of P the restatement lies 1.7-2.4 steps away,
# and a kernel with every c_j 0.4% high or c_j P~ truncated 1.7-3.0 steps
# (PERF.md section 6).
TILED_ULPS = 1.0


def _assert_as_tiled(out, q, k, v, nsplit):
    tiled = plain.memcom_xattn_tiled(q.float(), k.float(), v.float(),
                                     splits=nsplit)
    u = plain.bf16_ulps(out, tiled)
    assert u <= TILED_ULPS, (
        f"{u:.4f} bf16 steps from plain.memcom_xattn_tiled (limit "
        f"{TILED_ULPS})")


@pytest.mark.parametrize("shape,dtype,variant", XATTN_CASES)
def test_memcom_xattn_matches_plain(cuda, rng, shape, dtype, variant):
    """Every shape through each kernel that takes it: the picked one
    (``variant`` None) and each bf16 variant forced.  The wgmma variant is
    held to ``plain.memcom_xattn_tiled`` (its own rounding points) as well,
    by ``TILED_ULPS``."""
    B, M, T, D = shape
    q, k, v = _xattn_inputs(rng, shape, dtype)
    before = (mx.launches, mx.wgmma_launches)
    out = mx.memcom_xattn(q, k, v, variant=variant)
    torch.cuda.synchronize()
    chosen = variant or mx.variant_for(q.dtype, B, M, T, D, True)
    assert (mx.launches, mx.wgmma_launches) == (
        before[0] + 1, before[1] + (chosen == "wgmma"))
    ref = plain.memcom_xattn_ref(q, k, v)
    assert out.dtype == q.dtype and out.shape == (B, M, D)
    _assert_close(out, ref, dtype)
    if chosen == "wgmma":
        _assert_as_tiled(out, q, k, v, mx.num_splits(B, M, T, D))


@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("shape", [(1, 64, 1000, 256), (2, 96, 700, 1536)])
def test_memcom_xattn_tile_maxima_far_apart(cuda, rng, shape, variant):
    """Rows whose logits tiles' maxima differ by more than 100: finite, and
    as the plain version."""
    q, k, v = _xattn_inputs(rng, shape, "bfloat16", spread=True)
    out = mx.memcom_xattn(q, k, v, variant=variant)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    _assert_close(out, plain.memcom_xattn_ref(q, k, v), "bfloat16")


@pytest.mark.parametrize("shape,spread", [
    ((2, 37, 129, 128), False), ((1, 512, 3072, 2304), False),
    ((2, 512, 3077, 1536), False), ((1, 64, 1000, 256), True),
    ((2, 96, 700, 1536), True)])
def test_memcom_xattn_wgmma_passes_match_their_restatement(cuda, rng, shape,
                                                           spread):
    """Each of the wgmma kernel's two passes against its restatement, from
    the pieces the first leaves in the workspace.  First pass: m_j and l_j
    as the restatement's up to float32 sums of D products in another order
    (within 2^-15 of max(1, max |S|): the card reads at most 6.6e-6), and
    P~ within one bf16 step, at most 2% of it off a step (the card: up to
    0.94%, at logits of 150).  Output pass: the kernel's O is the
    restatement's output pass on the kernel's own pieces, rounded once to
    bf16 (0.5 steps), up to c_j summed in another order flipping a few
    c_j P~ roundings (the card reads 0.4994-0.5290; a kernel with every
    c_j 0.4% high or c_j P~ truncated 1.76-2.49)."""
    B, M, T, D = shape
    q, k, v = _xattn_inputs(rng, shape, "bfloat16", spread=spread)
    out, p, m, l = mx.wgmma_pieces(q, k, v)
    torch.cuda.synchronize()
    pr, mr, lr = plain.memcom_xattn_tiled_pieces(q, k)
    tol = 2.0 ** -15 * max(1.0, float(mr[torch.isfinite(mr)].abs().max()))
    assert float((m - mr).abs().max()) <= tol
    assert float(((l - lr) / lr).abs().max()) <= tol
    _, e = torch.frexp(pr)
    off = (p - pr).abs() / torch.ldexp(torch.ones_like(pr), e - 8)
    assert float(off.max()) <= 1.0
    assert float((p != pr).float().mean()) <= 0.02
    own = plain.memcom_xattn_tiled_out(p, m, l, v,
                                       splits=mx.num_splits(B, M, T, D))
    assert plain.bf16_ulps(out, own) <= 0.625




@pytest.mark.parametrize("nsplit", list(range(1, mx.MAX_SPLITS + 1)))
def test_memcom_xattn_wgmma_at_any_split_count(cuda, rng, monkeypatch,
                                               nsplit):
    """The output kernel's cluster sum at every split count, some splits
    empty (T = 300: 5 slabs)."""
    shape = (1, 130, 300, 512)
    q, k, v = _xattn_inputs(rng, shape, "bfloat16")
    monkeypatch.setattr(mx, "num_splits", lambda *a, **kw: nsplit)
    out = mx.memcom_xattn(q, k, v, variant="wgmma")
    torch.cuda.synchronize()
    _assert_close(out, plain.memcom_xattn_ref(q, k, v), "bfloat16")
    _assert_as_tiled(out, q, k, v, nsplit)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda, rng):
    q = _rand(rng, 1, 4, 2, 36)
    k = _rand(rng, 1, 8, 2, 36)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(NotImplementedError):  # (36, 16): no multiple of 8
        fa.flash_attention(q, k, _rand(rng, 1, 8, 2, 16), q_pos=pos[:, :4],
                           kv_pos=pos)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), k.half(), q_pos=pos[:, :4],
                           kv_pos=pos)
    with pytest.raises(NotImplementedError):  # bf16: multiples of 8 only
        qb, kb = q.bfloat16(), k.bfloat16()
        fa.flash_attention(qb, kb, kb, q_pos=pos[:, :4], kv_pos=pos)
    with pytest.raises(NotImplementedError):  # past 256 (576 pairs with 512)
        qw = _rand(rng, 1, 4, 2, 264, dtype="bfloat16")
        kw_ = _rand(rng, 1, 8, 2, 264, dtype="bfloat16")
        fa.flash_attention(qw, kw_, kw_, q_pos=pos[:, :4], kv_pos=pos)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k, k, q_pos=pos[:, :4],
                           kv_pos=pos)
    with pytest.raises(ValueError):  # v's T differs from k's
        mx.memcom_xattn(q[:, :, 0].contiguous(), k[:, :, 0].contiguous(),
                        k[:, :3, 0].contiguous())
    x = _rand(rng, 1, 4, 12, dtype="bfloat16")
    with pytest.raises(NotImplementedError):  # bf16 tensor cores: D % 8
        mx.memcom_xattn(x, x, x)
    for var in ("wgmma", "mma_sync"):
        with pytest.raises(NotImplementedError):
            mx.memcom_xattn(x, x, x, variant=var)
        with pytest.raises(NotImplementedError):  # bf16 kernels
            xf = _rand(rng, 1, 4, 64)
            mx.memcom_xattn(xf, xf, xf, variant=var)
    xb = _rand(rng, 1, 4, 96, dtype="bfloat16")
    with pytest.raises(NotImplementedError):  # wgmma: D % 64
        mx.memcom_xattn(xb, xb, xb, variant="wgmma")
    flat = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    xs = flat[1:].view(1, 4, 64)  # contiguous, off a 16-byte boundary
    for var in ("wgmma", "mma_sync"):
        with pytest.raises(NotImplementedError):
            mx.memcom_xattn(xs, xs, xs, variant=var)
    qb = _rand(rng, 1, 4, 64, dtype="bfloat16")
    kl = _rand(rng, 1, mx.WGMMA_MAX_T + 1, 64, dtype="bfloat16")
    with pytest.raises(NotImplementedError):  # T past the splits' reach
        mx.memcom_xattn(qb, kl, kl, variant="wgmma")
    assert mx.variant_for(torch.bfloat16, 1, 4, kl.shape[1], 64, True) \
        == "mma_sync"
    with pytest.raises(ValueError):
        mx.memcom_xattn(qb, qb, qb, variant="tma")


# (B, S, Hq, Hkv, D, block_size, lengths, softcap, table positions or None
# for one block past the longest slot)
PAGED_CASES = [
    (4, 1, 8, 4, 256, 16, [520, 523, 516, 524], 50.0, None),  # gemma2-2b
    (4, 3, 8, 4, 256, 16, [520, 2, 516, 3], 50.0, None),  # S = 3, masked rows
    (3, 1, 32, 8, 128, 8, [1, 64, 77], 0.0, None),  # mistral-7b, length 1
    (2, 2, 4, 4, 64, 12, [24, 50], 0.0, None),      # block size 12, MHA
    (2, 1, 8, 2, 256, 8, [40, 9], 50.0, None),      # G = 4
    # gemma2-2b's decode in tables of an engine with max_len 4096
    (4, 1, 8, 4, 256, 16, [520, 523, 516, 524], 50.0, 4096),
    (4, 1, 8, 4, 256, 16, [520, 0, 516, 524], 50.0, None),  # an empty slot
    (2, 3, 12, 3, 128, 16, [100, 2], 0.0, None),  # 12 rows: two row groups
]


def _paged_inputs(rng, case, dtype, device, dv=None):
    """Pools of shuffled blocks; slots 0 and 2 share their first blocks
    (a task prefix); table entries past each length name block 0.  ``dv``:
    the value width (default the key width)."""
    B, S, Hq, Hkv, D, bs, lengths, _, table = case
    nb = -(-(table or max(lengths) + bs) // bs)
    N = B * nb + 1
    order = rng.permutation(N - 1) + 1
    tables = np.zeros((B, nb), np.int32)
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        tables[b, :used] = order[b * nb:b * nb + used]
    if B > 2:
        shared = max(min(-(-lengths[0] // bs), -(-lengths[2] // bs)) - 1, 0)
        tables[2, :shared] = tables[0, :shared]
    q = _rand(rng, B, S, Hq, D, dtype=dtype, device=device)
    k = _rand(rng, N, bs, Hkv, D, dtype=dtype, device=device)
    v = _rand(rng, N, bs, Hkv, dv or D, dtype=dtype, device=device)
    return (q, k, v, torch.from_numpy(tables).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_matches_plain(cuda, rng, case, dtype):
    q, k, v, tables, lengths = _paged_inputs(rng, case, dtype, cuda)
    kw = dict(block_tables=tables, lengths=lengths, softcap=case[7])
    before = pa.launches
    out = pa.paged_flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = plain.paged_decode_attention_ref(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    _assert_close(out, ref, dtype)
    S = q.shape[1]
    dead = lengths[:, None] - S + torch.arange(S, device=cuda)[None] < 0
    if bool(dead.any()):  # rows that see no key give 0
        assert float(out[dead].float().abs().max()) == 0.0


# MLA's absorbed paged decode: 128 query heads on one latent head of 576
# (key) / 512 (value), one and four lanes; and the (192, 128) pair
PAGED_DV_CASES = [
    # (case, Dv, dtypes)
    ((4, 1, 128, 1, 576, 16, [1036, 1039, 1030, 1040], 0.0, None), 512,
     ("bfloat16",)),
    ((4, 4, 128, 1, 576, 16, [1040, 1043, 1034, 1044], 0.0, None), 512,
     ("bfloat16",)),
    ((3, 2, 16, 16, 192, 16, [100, 37, 64], 0.0, None), 128,
     ("float32", "bfloat16")),
]


@pytest.mark.parametrize("case,dv,dtypes", PAGED_DV_CASES)
def test_paged_flash_decode_dv_pairs_match_plain(cuda, rng, case, dv, dtypes):
    for dtype in dtypes:
        q, k, v, tables, lengths = _paged_inputs(rng, case, dtype, cuda, dv)
        kw = dict(block_tables=tables, lengths=lengths, scale=192 ** -0.5)
        before = pa.launches
        out = pa.paged_flash_decode(q, k, v, **kw)
        torch.cuda.synchronize()
        assert pa.launches == before + 1
        ref = plain.paged_decode_attention_ref(q, k, v, **kw)
        assert out.dtype == q.dtype and out.shape == (*q.shape[:3], dv)
        _assert_close(out, ref, dtype)
    if dtypes == ("bfloat16",):  # no float32 kernel at (576, 512)
        q, k, v, tables, lengths = _paged_inputs(rng, case, "float32", cuda,
                                                 dv)
        with pytest.raises(NotImplementedError):
            pa.paged_flash_decode(q, k, v, block_tables=tables,
                                  lengths=lengths)


@pytest.mark.parametrize("nsplit", [1, 3, 9, 16])
def test_paged_mla_decode_at_any_split_count(cuda, rng, monkeypatch, nsplit):
    """The cluster merge over 512-wide value rows, some splits empty."""
    case = (4, 1, 128, 1, 576, 16, [1036, 2, 0, 70], 0.0, 2048)
    q, k, v, tables, lengths = _paged_inputs(rng, case, "bfloat16", cuda, 512)
    kw = dict(block_tables=tables, lengths=lengths, scale=192 ** -0.5)
    monkeypatch.setattr(pa, "num_splits", lambda *shape: nsplit)
    out = pa.paged_flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(out, plain.paged_decode_attention_ref(q, k, v, **kw),
                  "bfloat16")
    assert float(out[2].float().abs().max()) == 0.0  # an empty slot


@pytest.mark.parametrize("nsplit", [1, 2, 5, 8, 9, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_at_any_split_count(cuda, rng, monkeypatch,
                                               nsplit, dtype):
    """The kernel's split of each slot's positions (``pa.split_plan``) and
    the merge within a cluster of ``nsplit`` blocks, at split counts the
    host's rule does not pick for this shape: one split, a few, the
    portable cluster size and past it, and more than a short slot has
    tiles (empty splits)."""
    case = (4, 3, 8, 4, 256, 16, [520, 2, 0, 70], 50.0, 4096)
    q, k, v, tables, lengths = _paged_inputs(rng, case, dtype, cuda)
    kw = dict(block_tables=tables, lengths=lengths, softcap=case[7])
    monkeypatch.setattr(pa, "num_splits", lambda *shape: nsplit)
    out = pa.paged_flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(out, plain.paged_decode_attention_ref(q, k, v, **kw), dtype)
    dead = lengths[:, None] - 3 + torch.arange(3, device=cuda)[None] < 0
    assert float(out[dead].float().abs().max()) == 0.0


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(cuda, rng):
    case = (2, 1, 4, 2, 64, 8, [9, 3], 0.0, None)
    q, k, v, tables, lengths = _paged_inputs(rng, case, "float32", cuda)
    kw = dict(block_tables=tables, lengths=lengths)
    with pytest.raises(NotImplementedError):  # (64, 36): no multiple of 8
        pa.paged_flash_decode(q, k, v[..., :36].contiguous(), **kw)
    with pytest.raises(NotImplementedError):  # multiples of 8 only
        pa.paged_flash_decode(q[..., :36].contiguous(),
                              k[..., :36].contiguous(),
                              v[..., :36].contiguous(), **kw)
    wide = _rand(rng, *k.shape[:3], 264)
    with pytest.raises(NotImplementedError):  # past 256
        pa.paged_flash_decode(_rand(rng, *q.shape[:3], 264), wide, wide, **kw)
    with pytest.raises(TypeError):
        pa.paged_flash_decode(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(TypeError):  # int32 tables and lengths
        pa.paged_flash_decode(q, k, v, block_tables=tables.long(),
                              lengths=lengths)
    with pytest.raises(ValueError):
        pa.paged_flash_decode(q.transpose(1, 2), k, v, **kw)
    with pytest.raises(ValueError):  # one length per slot
        pa.paged_flash_decode(q, k, v, block_tables=tables,
                              lengths=lengths[:1].contiguous())
    with pytest.raises(ValueError):  # everything on one device
        pa.paged_flash_decode(q, k.cpu(), v, **kw)


def test_paged_kernel_rejects_more_splits_than_a_cluster_holds(cuda, rng,
                                                               monkeypatch):
    case = (2, 1, 4, 2, 64, 8, [90, 30], 0.0, None)
    q, k, v, tables, lengths = _paged_inputs(rng, case, "float32", cuda)
    monkeypatch.setattr(pa, "num_splits", lambda *shape: pa.MAX_SPLITS + 1)
    with pytest.raises(RuntimeError):
        pa.paged_flash_decode(q, k, v, block_tables=tables, lengths=lengths)


def test_paged_scatter_keeps_the_last_lane_on_the_card(cuda, rng):
    """A 12-lane decode write at granite's KV width: slots 0-3 write
    their own blocks, slots 4-11 (reclaimed: trash-only tables, one stale
    length) all name one row of block 0.  Every run on the card leaves
    the pools as the CPU's sequential scatter does, the last lane's
    values in the shared row."""
    B, nb, bs, H, D = 12, 40, 16, 8, 64
    N = 1 + 4 * nb
    pools = [_rand(rng, N, bs, H, D, dtype="bfloat16", device="cpu")
             for _ in range(2)]
    news = [_rand(rng, B, 1, H, D, dtype="bfloat16", device="cpu")
            for _ in range(2)]
    tables = torch.zeros((B, nb), dtype=torch.int32)
    tables[:4] = torch.arange(1, N, dtype=torch.int32).reshape(4, nb)
    lens = torch.tensor([520, 533, 547, 600] + [525] * 8, dtype=torch.int32)
    want = ops.paged_scatter([p.clone() for p in pools], news, tables, lens)
    np.testing.assert_array_equal(want[0][0, 525 % bs].float().numpy(),
                                  news[0][B - 1, 0].float().numpy())
    for _ in range(20):
        got = ops.paged_scatter([p.to(cuda) for p in pools],
                                [x.to(cuda) for x in news], tables.to(cuda),
                                lens.to(cuda))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


# (E, C, D, F): granite-moe-3b-a800m's expert products at the source
# prefill (C = 768), the Memory-LLM (C = 128) and the prompt prefill /
# decode (C = 8), in both orientations; then ragged sizes
GMM_CASES = [
    (40, 768, 1536, 512), (40, 128, 1536, 512), (40, 8, 1536, 512),
    (40, 768, 512, 1536), (40, 128, 512, 1536), (40, 8, 512, 1536),
    (5, 8, 96, 64),       # granite-moe-smoke
    (3, 37, 40, 24),      # ragged C; D and F multiples of 8, not of tiles
    (2, 13, 19, 7),       # D and F not multiples of 8: element-wise loads
    # the variants' thresholds: the rows kernel's C tiles (8, 16, 32) and
    # its widest call, the wgmma kernel's 64- and 128-row tiles
    (4, 1, 512, 1536), (4, 9, 1536, 512), (4, 17, 512, 1536),
    (4, 32, 1536, 512), (4, 33, 512, 1536), (4, 63, 1536, 512), (4, 65, 512, 1536), (4, 129, 1536, 512),
    (3, 40, 1544, 520),   # D not a multiple of 64, F not one of a tile
    (2, 24, 40, 520),     # D of one partial slab
    (1, 300, 512, 1536),  # one expert
    (1, 8, 1536, 520),
]


@pytest.mark.parametrize("case", GMM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_matches_plain(cuda, rng, case, dtype):
    E, C, D, F = case
    x = _rand(rng, E, C, D, dtype=dtype)
    w = _rand(rng, E, D, F, dtype=dtype, scale=D ** -0.5)
    before = moe_gmm.launches
    out = ops.gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    ref = plain.gmm_ref(x, w)
    assert out.dtype == x.dtype and tuple(out.shape) == (E, C, F)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("case", GMM_CASES)
@pytest.mark.parametrize("variant", ["wgmma", "rows", "mma_sync"])
def test_gmm_bf16_variants_match_plain(cuda, rng, case, variant):
    """Every bf16 kernel, forced, at every shape it takes (the others
    raise), counted by its own counter; the same inputs give the same
    bits twice (each output is one block's sum in one order)."""
    E, C, D, F = case
    x = _rand(rng, E, C, D, dtype="bfloat16")
    w = _rand(rng, E, D, F, dtype="bfloat16", scale=D ** -0.5)
    if not moe_gmm.takes(variant, x.dtype, E, C, D, F, True):
        with pytest.raises(NotImplementedError):
            moe_gmm.gmm(x, w, variant=variant)
        return
    before = (moe_gmm.launches, moe_gmm.wgmma_launches, moe_gmm.rows_launches)
    out = moe_gmm.gmm(x, w, variant=variant)
    again = moe_gmm.gmm(x, w, variant=variant)
    torch.cuda.synchronize()
    assert (moe_gmm.launches, moe_gmm.wgmma_launches,
            moe_gmm.rows_launches) == (before[0] + 2,
                                       before[1] + 2 * (variant == "wgmma"),
                                       before[2] + 2 * (variant == "rows"))
    assert out.dtype == x.dtype and tuple(out.shape) == (E, C, F)
    _assert_close(out, plain.gmm_ref(x, w), "bfloat16")
    assert torch.equal(out, again)


@pytest.mark.parametrize("case", [(40, 768, 1536, 512), (3, 300, 1544, 520),
                                  (40, 128, 512, 1536), (3, 200, 1544, 520),
                                  (2, 65, 40, 24), (2, 40, 1544, 520)])
def test_gmm_wgmma_tiles_match_plain(cuda, rng, case):
    """Each tile of the wgmma kernel as the source picks it by C (256 x
    128 from C = 256, 128 x 256 above 64, 64 x 128 below), ragged edges
    included."""
    E, C, D, F = case
    x = _rand(rng, E, C, D, dtype="bfloat16")
    w = _rand(rng, E, D, F, dtype="bfloat16", scale=D ** -0.5)
    out = moe_gmm.gmm(x, w, variant="wgmma")
    torch.cuda.synchronize()
    _assert_close(out, plain.gmm_ref(x, w), "bfloat16")


@pytest.mark.parametrize("C,want", [(8, "rows"), (32, "rows"), (33, "wgmma"),
                                    (128, "wgmma"), (768, "wgmma")])
def test_gmm_dispatch_by_rows(cuda, rng, C, want):
    """Granite's decode and prompt prefill (C = 8) go to the rows kernel,
    its Memory-LLM and source prefill to the wgmma kernel."""
    x = _rand(rng, 40, C, 1536, dtype="bfloat16")
    w = _rand(rng, 40, 1536, 512, dtype="bfloat16", scale=1536 ** -0.5)
    before = (moe_gmm.wgmma_launches, moe_gmm.rows_launches)
    ops.gmm(x, w)
    assert (moe_gmm.wgmma_launches - before[0],
            moe_gmm.rows_launches - before[1]) == (
                int(want == "wgmma"), int(want == "rows"))


def test_gmm_forced_variant_rejects_what_it_does_not_take(cuda, rng):
    x = _rand(rng, 2, 8, 64, dtype="bfloat16")
    w = _rand(rng, 2, 64, 64, dtype="bfloat16")
    flat = _rand(rng, 2 * 8 * 64 + 1, dtype="bfloat16")
    shifted = flat[1:].view(2, 8, 64)  # contiguous, 2 bytes off 16
    for variant in ("wgmma", "rows"):
        with pytest.raises(NotImplementedError):
            moe_gmm.gmm(shifted, w, variant=variant)
        with pytest.raises(NotImplementedError):
            moe_gmm.gmm(x.float(), w.float(), variant=variant)
        with pytest.raises(NotImplementedError):  # F not a multiple of 8
            moe_gmm.gmm(x, w[..., :60].contiguous(), variant=variant)
    with pytest.raises(NotImplementedError):
        moe_gmm.gmm(_rand(rng, 2, moe_gmm.ROWS_MAX_C + 1, 64,
                          dtype="bfloat16"), w, variant="rows")
    with pytest.raises(NotImplementedError):
        moe_gmm.gmm(x.float(), w.float(), variant="mma_sync")
    with pytest.raises(ValueError):
        moe_gmm.gmm(x, w, variant="tma")
    assert moe_gmm.variant_for(shifted.dtype, 8, 64, 64, False) == "mma_sync"
    _assert_close(moe_gmm.gmm(shifted, w), plain.gmm_ref(shifted, w),
                  "bfloat16")


def test_gmm_wrapper_rejects_what_the_kernel_does_not_take(cuda, rng):
    x = _rand(rng, 2, 8, 16)
    w = _rand(rng, 2, 16, 8)
    with pytest.raises(TypeError):
        moe_gmm.gmm(x.half(), w.half())
    with pytest.raises(TypeError):  # mixed types
        moe_gmm.gmm(x, w.bfloat16())
    with pytest.raises(ValueError):  # w's D differs from x's
        moe_gmm.gmm(x, w[:, :8].contiguous())
    with pytest.raises(ValueError):  # expert counts differ
        moe_gmm.gmm(x, w[:1].contiguous())
    with pytest.raises(ValueError):
        moe_gmm.gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError):
        moe_gmm.gmm(x, w.cpu())


SSD_CASES = [
    # (B, S, H, P, G, N, initial state, dt·|A| past 100 in a chunk)
    (1, 3084, 32, 64, 1, 128, True, False),  # mamba2-370m prefill + query
    (1, 12, 32, 64, 1, 128, False, False),   # a 12-token prompt
    (2, 300, 32, 64, 1, 128, True, False),   # S no multiple of any chunk
    (1, 200, 32, 64, 2, 128, True, False),   # two groups
    (3, 1, 4, 64, 1, 128, True, False),      # one token
    (2, 70, 8, 16, 1, 16, True, False),      # mamba2-370m-smoke widths
    (1, 50, 4, 40, 2, 8, True, False),       # P no multiple of the P tile
    (1, 96, 4, 64, 1, 128, True, True),      # the NaN trap
]


# ssd: the kernel sums float32 inputs in float64 and is held to
# plain.ssd_ref on the same inputs summed in float64 (a row of y can be
# the cancelled remainder of its terms, and float32 sums stray up to ~5e-4
# of such a row's scale); bf16 to the plain version's float32 sums.


def _ssd_inputs(rng, case, dtype, device):
    """dt and A as a seeded Mamba2 layer makes them (softplus of unit
    normals; -exp of U(-1, 1)), B and C scaled so that C·B is O(1)."""
    B, S, H, P, G, N, init, big = case
    x = _rand(rng, B, S, H, P, dtype=dtype, device=device)
    Bm = _rand(rng, B, S, G, N, dtype=dtype, scale=0.5 * N ** -0.25,
               device=device)
    Cm = _rand(rng, B, S, G, N, dtype=dtype, scale=0.5 * N ** -0.25,
               device=device)
    if big:
        dt = torch.full((B, S, H), 5.0, device=device)
        A = torch.full((H,), -5.0, device=device)
    else:
        dt = torch.nn.functional.softplus(_rand(rng, B, S, H, scale=1.0,
                                                device=device))
        A = -torch.exp(torch.from_numpy(
            rng.uniform(-1, 1, H).astype(np.float32)).to(device))
    h0 = _rand(rng, B, H, P, N, device=device) if init else None
    return x, dt, A, Bm, Cm, h0


def _assert_ssd_close(y, hf, x, y_ref, hf_ref, dtype):
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    assert y.shape == x.shape and hf.shape == hf_ref.shape
    assert bool(torch.isfinite(y.float()).all() & torch.isfinite(hf).all())
    _assert_close(y, y_ref, dtype)
    _assert_close(hf, hf_ref, dtype)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_plain(cuda, rng, case, dtype):
    """The dispatched kernel, and at bf16 each kernel that takes the shape
    forced (the chunked variant at P 64, N 128; the sequential one at
    every shape), against the plain version."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, case, dtype, cuda)
    P, N = x.shape[-1], Bm.shape[-1]
    want = ssd_scan.variant_for(x.dtype, x.shape[1], P, N, True)
    before = (ssd_scan.launches, ssd_scan.chunked_launches)
    y, hf = ops.ssd(x, dt, A, Bm, Cm, init_state=h0)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.chunked_launches) == (
        before[0] + 1, before[1] + (want == "chunked"))
    wide = [None if a is None else a.double() if dtype == "float32" else a
            for a in (x, dt, A, Bm, Cm, h0)]
    y_ref, hf_ref = plain.ssd_ref(*wide[:5], init_state=wide[5])
    _assert_ssd_close(y, hf, x, y_ref, hf_ref, dtype)
    if dtype == "bfloat16":
        for variant in ("chunked", "sequential"):
            if ssd_scan.takes(variant, x.dtype, P, N, True):
                y, hf = ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0,
                                     variant=variant)
                torch.cuda.synchronize()
                _assert_ssd_close(y, hf, x, y_ref, hf_ref, dtype)


@pytest.mark.parametrize("length", ["1", "q-1", "q", "q+1", "2q-1"])
def test_ssd_chunked_at_ragged_lengths(cuda, rng, length):
    """The chunked variant with S around one and two of its chunks,
    against the plain version (bf16)."""
    q = ssd_scan.CHUNK_Q
    S = {"1": 1, "q-1": q - 1, "q": q, "q+1": q + 1, "2q-1": 2 * q - 1}[
        length]
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(
        rng, (2, S, 8, 64, 2, 128, True, False), "bfloat16", cuda)
    before = ssd_scan.chunked_launches
    y, hf = ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0, variant="chunked")
    torch.cuda.synchronize()
    assert ssd_scan.chunked_launches == before + 1
    y_ref, hf_ref = plain.ssd_ref(x, dt, A, Bm, Cm, init_state=h0)
    _assert_ssd_close(y, hf, x, y_ref, hf_ref, "bfloat16")


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda, rng):
    case = (1, 20, 4, 16, 2, 8, True, False)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, case, "float32", cuda)
    with pytest.raises(TypeError):  # x/B/C types differ
        ssd_scan.ssd(x, dt, A, Bm.bfloat16(), Cm, init_state=h0)
    with pytest.raises(TypeError):  # dt must be float32
        ssd_scan.ssd(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan.ssd(x.half(), dt, A, Bm.half(), Cm.half())
    with pytest.raises(ValueError):  # H = 4 is no multiple of G = 3
        ssd_scan.ssd(x, dt, A, Bm[:, :, :1].expand(-1, -1, 3, -1)
                     .contiguous(), Cm[:, :, :1].expand(-1, -1, 3, -1)
                     .contiguous())
    with pytest.raises(ValueError):
        ssd_scan.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     Bm, Cm)
    with pytest.raises(ValueError):
        ssd_scan.ssd(x, dt, A, Bm, Cm, init_state=h0[..., :4].contiguous())
    with pytest.raises(ValueError):
        ssd_scan.ssd(x, dt, A.cpu(), Bm, Cm)
    with pytest.raises(NotImplementedError):  # N no multiple of 4
        ssd_scan.ssd(x, dt, A, Bm[..., :6].contiguous(),
                     Cm[..., :6].contiguous())


# ---------------------------------------------------------------------------
# Backward kernels: flash_attention_bwd and memcom_xattn_bwd against the
# plain backward (explicit formulas) on the same inputs.  float32: max abs
# error at most 1e-4 of max(1, the largest gradient); bf16: at most 2e-2
# by ``plain.grad_err`` (``plain.scaled_err``, with the rows below
# 2^-7 of the tensor's rms held to that: a dq row of a query that sees one
# key is float32 noise in both versions), per gradient.
# ---------------------------------------------------------------------------

def _assert_grad_close(got, want, dtype, name):
    if dtype == "float32":
        e = _err(got, want)
        bound = 1e-4 * max(1.0, float(want.float().abs().max()))
        assert e <= bound, f"{name}: max abs err {e:.3e} > {bound:.3e}"
    else:
        s = plain.grad_err(got, want)
        assert s <= REL_TOL[dtype], f"{name}: grad err {s:.3e}"


BWD_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, layout, softcap, dlse); layout: "causal"
    # (q_pos = kv_pos = arange), "offset" (both from 512), "prefix" (q at
    # 512.., kv 0..Skv-1, non-causal), "masked" (some q rows see no key)
    (1, 512, 512, 8, 4, 256, "causal", 50.0, False),   # Memory-LLM self
    (2, 64, 64, 8, 4, 256, "offset", 50.0, True),      # prompt self
    (2, 64, 512, 8, 4, 256, "prefix", 50.0, True),     # prompt vs prefix
    (1, 512, 512, 24, 8, 64, "causal", 0.0, False),    # granite
    (1, 512, 512, 32, 8, 128, "causal", 0.0, False),   # mistral-7b
    (1, 96, 96, 4, 2, 32, "causal", 0.0, True),        # head dim 32 (f32)
    (1, 200, 130, 8, 4, 256, "prefix", 50.0, True),    # ragged 64-row tiles
    (3, 70, 70, 12, 4, 64, "causal", 0.0, False),
    (2, 37, 53, 4, 2, 64, "prefix", 0.0, False),       # ragged tiles
    (2, 45, 45, 6, 2, 128, "offset", 30.0, False),
    (2, 40, 70, 8, 4, 256, "masked", 50.0, True),      # rows with no key
    # a cap near the logits' size, so that its factor 1 - (s / cap)^2 is
    # far from 1 (at cap 50 random logits leave it within 1e-4 of 1)
    (2, 64, 96, 8, 4, 256, "prefix", 0.5, True),
    (1, 80, 80, 8, 2, 128, "causal", 0.5, False),
]


def _bwd_positions(B, Sq, Skv, layout, device):
    ar = lambda lo, n: (lo + torch.arange(n, dtype=torch.int32)).expand(  # noqa: E731
        B, n).contiguous().to(device)
    if layout == "causal":
        return ar(0, Sq), ar(0, Skv), True
    if layout == "offset":
        return ar(512, Sq), ar(512, Skv), True
    if layout == "prefix":
        return ar(512, Sq), ar(0, Skv), False
    q_pos = ar(-8, Sq)          # the first rows sit before every key
    kv_pos = ar(0, Skv).clone()
    kv_pos[:, 5:9] = -1         # holes
    return q_pos, kv_pos, True


@pytest.mark.parametrize("case,dtype,variant", [
    (c, d, vn) for c in BWD_CASES for d in ("float32", "bfloat16")
    for vn in ((None,) if d == "float32" else ("wgmma", "mma_sync"))
    if d == "float32" or c[5] in (64, 128, 256)])  # bf16 forward head dims
def test_flash_attention_bwd_matches_plain(cuda, rng, case, dtype, variant):
    """Every case through the float32 kernel, and through each bf16
    kernel forced (the dead-row check also shows that no kernel leaves a
    row of the uninitialised gradients unwritten)."""
    B, Sq, Skv, Hq, Hkv, D, layout, cap, with_dlse = case
    q, dout = (_rand(rng, B, Sq, Hq, D, dtype=dtype) for _ in range(2))
    k, v = (_rand(rng, B, Skv, Hkv, D, dtype=dtype) for _ in range(2))
    q_pos, kv_pos, causal = _bwd_positions(B, Sq, Skv, layout, cuda)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    dlse = (_rand(rng, B, Sq, Hq, dtype="float32") if with_dlse else None)
    before = (fa.bwd_launches, fa.bwd_wgmma_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                 variant=variant, **kw)
    torch.cuda.synchronize()
    assert (fa.bwd_launches, fa.bwd_wgmma_launches) == (
        before[0] + 1, before[1] + (variant == "wgmma"))
    want = plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, name)
    if layout == "masked":  # rows that see no key get exactly no gradient
        dead = (q_pos < 0)
        assert float(got[0][dead].abs().max()) == 0.0
        holes = (kv_pos < 0)    # nor do keys that no query sees
        assert float(got[1][holes].abs().max()) == 0.0
        assert float(got[2][holes].abs().max()) == 0.0


# MLA's non-absorbed widths (D, Dv) = (192, 128), 16 heads (no GQA fold) or
# 8 on 4 KV heads, scale 192 ** -0.5: the float32 kernel and the bf16 wgmma
# one (the only bf16 kernel that takes the pair) against the plain
# backward, by test_flash_attention_bwd_matches_plain's rule.
DV_BWD_CASES = [
    # (B, Sq, Skv, Hq, Hkv, layout, dlse)
    (1, 512, 512, 16, 16, "causal", False),   # Memory-LLM self
    (2, 64, 64, 16, 16, "offset", True),      # prompt self, lse cotangent
    (2, 64, 512, 16, 16, "prefix", True),     # prompt vs the prefix
    (1, 200, 130, 8, 4, "prefix", True),      # ragged tiles, GQA fold
    (2, 40, 70, 16, 16, "masked", True),      # rows with no key, holes
    (1, 1024, 1024, 2, 2, "causal", False),   # split KV walks
]


@pytest.mark.parametrize("case", DV_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_dv_matches_plain(cuda, rng, case, dtype):
    B, Sq, Skv, Hq, Hkv, layout, with_dlse = case
    D, Dv, scale = 192, 128, 192 ** -0.5
    q = _rand(rng, B, Sq, Hq, D, dtype=dtype)
    dout = _rand(rng, B, Sq, Hq, Dv, dtype=dtype)
    k = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
    v = _rand(rng, B, Skv, Hkv, Dv, dtype=dtype)
    q_pos, kv_pos, causal = _bwd_positions(B, Sq, Skv, layout, cuda)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, scale=scale)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    dlse = (_rand(rng, B, Sq, Hq, dtype="float32") if with_dlse else None)
    before = (fa.bwd_launches, fa.bwd_wgmma_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse, **kw)
    torch.cuda.synchronize()
    assert (fa.bwd_launches, fa.bwd_wgmma_launches) == (
        before[0] + 1, before[1] + (dtype == "bfloat16"))
    want = plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, name)
    if layout == "masked":
        assert float(got[0][q_pos < 0].abs().max()) == 0.0
        assert float(got[1][kv_pos < 0].abs().max()) == 0.0
        assert float(got[2][kv_pos < 0].abs().max()) == 0.0
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    if dtype == "bfloat16":  # the mma.sync backward needs Dv == D
        with pytest.raises(NotImplementedError):
            fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                   variant="mma_sync", **kw)


# The wgmma backward against its own arithmetic, plain.attention_bwd_tiled
# on the same bf16 inputs in float32, in bf16 steps (plain.bf16_ulps).  The
# last rounding of each gradient gives up to 0.5; S and dP, summed in
# another order than the restatement's, move a few P and dS values across
# a bf16 rounding boundary, each moving its term of a gradient's sum by one
# step of the term: up to 2 steps of the gradient's own scale where that
# term dominates its row (the first queries of a causal call, a key seen
# by one query).  On an H100 the kernel reads 0.50-1.43 (PERF.md section
# 6); the bound is that one step of a dominant term, 2.5.  It does not
# separate a kernel that skips the rounding of P and dS (the restatement
# without it reads 1.37-2.22): the CPU tests hold those rounding points.
# Cases with an lse cotangent, so that no gradient row is float32 noise (a
# one-key dq row without one is P (dP - D) K with dP = D up to rounding).
TILED_BWD_ULPS = 2.5
TILED_BWD_CASES = [
    (1, 512, 512, 8, 4, 256, "causal", 50.0),    # Memory-LLM self
    (2, 64, 512, 8, 4, 256, "prefix", 50.0),     # prompt vs prefix
    (1, 200, 130, 8, 4, 256, "prefix", 0.5),     # ragged tiles, cap 0.5
    (2, 40, 70, 8, 4, 256, "masked", 50.0),      # dead rows and holes
    (1, 170, 170, 24, 8, 64, "causal", 0.0),     # G 3, ragged last tile
    (1, 300, 300, 32, 8, 128, "offset", 0.0),    # G 4
    # MLA's (192, 128): Dv != D (the tenth entry), one and two KV walks
    (1, 512, 512, 16, 16, 192, "causal", 0.0, 128),
    (2, 64, 512, 16, 16, 192, "prefix", 0.0, 128),
    (1, 1024, 1024, 2, 2, 192, "causal", 0.0, 128),  # split KV walks
]


@pytest.mark.parametrize("case", TILED_BWD_CASES)
def test_flash_bwd_wgmma_matches_its_tiled_restatement(cuda, rng, case):
    B, Sq, Skv, Hq, Hkv, D, layout, cap = case[:8]
    Dv = case[8] if len(case) > 8 else D
    q = _rand(rng, B, Sq, Hq, D, dtype="bfloat16")
    dout = _rand(rng, B, Sq, Hq, Dv, dtype="bfloat16")
    k = _rand(rng, B, Skv, Hkv, D, dtype="bfloat16")
    v = _rand(rng, B, Skv, Hkv, Dv, dtype="bfloat16")
    q_pos, kv_pos, causal = _bwd_positions(B, Sq, Skv, layout, cuda)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    live = (lse > plain.NEG_INF / 2).float()   # dead rows have no lse
    dlse = _rand(rng, B, Sq, Hq, dtype="float32") * live
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                 variant="wgmma", **kw)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiled = plain.attention_bwd_tiled(
        *(x.float() for x in (q, k, v, out)), lse, dout.float(), dlse,
        split_at=fa.bwd_split_at(B, Sq, Skv, Hq, Hkv, D, causal, sms, dv=Dv),
        **kw)
    for name, g, t in zip(("dq", "dk", "dv"), got, tiled):
        u = plain.bf16_ulps(g, t)
        assert u <= TILED_BWD_ULPS, (
            f"{name}: {u:.4f} bf16 steps from plain.attention_bwd_tiled "
            f"(limit {TILED_BWD_ULPS})")


@pytest.mark.parametrize("shape", [
    (2, 512, 512, 8, 4, 256, True), (2, 512, 512, 8, 4, 256, False),
    (1, 3072, 3072, 8, 4, 256, True), (2, 512, 512, 24, 8, 64, True),
    (2, 512, 512, 32, 8, 128, True), (3, 70, 45, 6, 2, 64, True),
    (2, 45, 70, 6, 2, 128, True), (2, 37, 53, 4, 2, 64, False),
    (1, 1, 700, 8, 1, 256, True), (1, 700, 1, 8, 8, 128, True),
    (2, 1024, 1024, 128, 128, 192, True, 128),
    (2, 512, 1024, 128, 128, 192, False, 128)])
@pytest.mark.parametrize("with_dq", [True, False])
@pytest.mark.parametrize("sms", [132, 16, 1000])
def test_flash_bwd_wgmma_block_order_is_its_restatement(cuda, shape,
                                                        with_dq, sms):
    """The kernel's plan (the library's host copy of ``BwPlan``) splits
    KV walks where ``fa.bwd_split`` does and gives the slot order
    ``fa.bwd_plan`` states, on cards of several SM counts."""
    B, Sq, Skv, Hq, Hkv, D, causal = shape[:7]
    dv = shape[7] if len(shape) > 7 else None
    split = fa.bwd_split(B, Sq, Skv, Hq, Hkv, D, causal, sms, with_dq, dv=dv)
    assert fa.bwd_kernel_slots(B, Sq, Skv, Hq, Hkv, D, causal, sms,
                               with_dq, dv=dv) == \
        fa.bwd_plan(Sq, Skv, Hq, Hkv, causal, split, with_dq)


def test_flash_bwd_dispatch_and_forced_variants(cuda, rng):
    """bf16 calls the wgmma backward takes go to it unforced; a forced
    variant that does not take the call raises."""
    B, S, Hq, Hkv, D = 1, 96, 4, 2, 128
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None]
    kw = dict(q_pos=pos, kv_pos=pos, causal=True)
    for dtype in ("bfloat16", "float32"):
        q, dout = (_rand(rng, B, S, Hq, D, dtype=dtype) for _ in range(2))
        k, v = (_rand(rng, B, S, Hkv, D, dtype=dtype) for _ in range(2))
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        before = fa.bwd_wgmma_launches
        fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        assert fa.bwd_wgmma_launches == before + (dtype == "bfloat16")
    with pytest.raises(NotImplementedError):   # float32
        fa.flash_attention_bwd(q, k, v, out, lse, dout, variant="wgmma", **kw)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_bwd(q, k, v, out, lse, dout, variant="mma_sync",
                               **kw)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse, dout, variant="tc", **kw)


XBWD_SHAPES = [(1, 512, 3072, 2304), (1, 512, 3072, 1536), (2, 40, 300, 256),
               (1, 17, 99, 72), (1, 17, 99, 64)]
XBWD_CASES = [
    *((shape, "float32", None) for shape in XBWD_SHAPES[:4]),
    *((shape, "bfloat16", var) for shape in XBWD_SHAPES
      for var in ("wgmma", "mma_sync")
      if mx.bwd_takes(var, torch.bfloat16, *shape, True)),
]


def _xbwd_inputs(rng, shape, dtype):
    """q, k, v, dout with std 0.5 and the forward's out and lse."""
    B, M, T, D = shape
    q, dout = (_rand(rng, B, M, D, dtype=dtype) for _ in range(2))
    k, v = (_rand(rng, B, T, D, dtype=dtype) for _ in range(2))
    out, lse = mx.memcom_xattn(q, k, v, return_lse=True)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("shape,dtype,variant", XBWD_CASES)
def test_memcom_xattn_bwd_matches_plain(cuda, rng, shape, dtype, variant):
    """Every shape through each backward kernel that takes it (float32;
    bf16 through the wgmma and the mma.sync variant, each forced), given
    the forward's out and lse."""
    q, k, v, out, lse, dout = _xbwd_inputs(rng, shape, dtype)
    before = (mx.bwd_launches, mx.bwd_wgmma_launches)
    got = mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=variant)
    torch.cuda.synchronize()
    assert (mx.bwd_launches, mx.bwd_wgmma_launches) == (
        before[0] + 1, before[1] + (variant == "wgmma"))
    want = plain.memcom_xattn_bwd_ref(q, k, v, dout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, name)


LSE_CASES = [
    (shape, dtype, var)
    for shape, dtype in (((2, 40, 300, 256), "bfloat16"),
                         ((1, 512, 3072, 2304), "bfloat16"),
                         ((1, 17, 99, 72), "bfloat16"),
                         ((2, 40, 300, 256), "float32"))
    for var in (None, "wgmma", "mma_sync")
    if var is None or mx.takes(var, getattr(torch, dtype), *shape, True)]


@pytest.mark.parametrize("shape,dtype,variant", LSE_CASES)
def test_memcom_xattn_lse_matches_plain(cuda, rng, shape, dtype, variant):
    """Each forward kernel's lse against the plain version's logsumexp of
    the float32 logits: within 1e-4 of max(1, |lse|) (float32 sums of D
    products in another order)."""
    B, M, T, D = shape
    q, k, v = _xattn_inputs(rng, shape, dtype)
    out, lse = mx.memcom_xattn(q, k, v, variant=variant, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = plain.memcom_xattn_ref(q, k, v, return_lse=True)
    assert lse.shape == (B, M) and lse.dtype == torch.float32
    assert torch.equal(out, mx.memcom_xattn(q, k, v, variant=variant))
    bound = 1e-4 * max(1.0, float(want_lse.abs().max()))
    assert _err(lse, want_lse) <= bound


@pytest.mark.parametrize("n", [128, 256])
def test_wgmma_mn_major_a_form_matches_matmul(cuda, rng, n):
    """The wgmma form of the memcom_xattn backward's dK / dV tiles (A read
    MN-major through the transpose-A bit, B MN-major, 128-byte swizzle)
    computes a^T b: f32 sums of 64 bf16 products, 1e-4."""
    a = _rand(rng, 64, 64, dtype="bfloat16")
    b = _rand(rng, 64, n, dtype="bfloat16")
    c = fa.wgmma_tile_check(a, b, b_mn_major=True, n=n, a_mn_major=True)
    torch.cuda.synchronize()
    ref = a.float().T @ b.float()
    assert _err(c, ref) <= 1e-4 * max(1.0, float(ref.abs().max()))


# The wgmma backward against its own arithmetic, plain.memcom_xattn_bwd_tiled
# on the same bf16 inputs, out and lse in float32, in bf16 steps
# (plain.bf16_ulps).  The last rounding of each gradient gives up to 0.5;
# S and dP, summed in another order than the restatement's, move a few P
# and dS values across a bf16 rounding boundary, each moving its term of
# a gradient's sum by one step of the term, a small share of sums over
# hundreds or thousands of terms.  On an H100 the kernel reads 0.49-0.75
# (scripts/xattn_bwd_times.py, PERF.md section 6); the restatement
# without its rounding of P and dS lies 1.04-2.00 steps from the one with
# it, so the bound also catches a kernel that skips that rounding.
TILED_XBWD_ULPS = 1.0
TILED_XBWD_SHAPES = [(1, 512, 3072, 2304), (1, 512, 3072, 1536),
                     (2, 40, 300, 256), (1, 17, 99, 64), (2, 130, 700, 512)]


def _assert_xbwd_as_tiled(got, q, k, v, out, lse, dout, nsplit):
    tiled = plain.memcom_xattn_bwd_tiled(
        *(x.float() for x in (q, k, v, out)), lse, dout.float(),
        splits=nsplit)
    for name, g, t in zip(("dq", "dk", "dv"), got, tiled):
        u = plain.bf16_ulps(g, t)
        assert u <= TILED_XBWD_ULPS, (
            f"{name}: {u:.4f} bf16 steps from plain.memcom_xattn_bwd_tiled "
            f"(limit {TILED_XBWD_ULPS})")


@pytest.mark.parametrize("shape", TILED_XBWD_SHAPES)
def test_memcom_xattn_bwd_wgmma_matches_its_tiled_restatement(cuda, rng,
                                                              shape):
    B, M, T, D = shape
    q, k, v, out, lse, dout = _xbwd_inputs(rng, shape, "bfloat16")
    got = mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant="wgmma")
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _assert_xbwd_as_tiled(got, q, k, v, out, lse, dout,
                          mx.bwd_num_splits(B, M, T, D, sms))


@pytest.mark.parametrize("nsplit", list(range(1, mx.GRAD_MAX_SPLITS + 1)))
def test_memcom_xattn_bwd_wgmma_at_any_split_count(cuda, rng, monkeypatch,
                                                   nsplit):
    """The dQ tiles' cluster sum at every split count (T = 700: 11 slabs,
    ragged splits)."""
    shape = (2, 130, 700, 512)
    q, k, v, out, lse, dout = _xbwd_inputs(rng, shape, "bfloat16")
    monkeypatch.setattr(mx, "bwd_num_splits", lambda *a, **kw: nsplit)
    got = mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant="wgmma")
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          plain.memcom_xattn_bwd_ref(q, k, v, dout)):
        _assert_grad_close(g, w, "bfloat16", name)
    _assert_xbwd_as_tiled(got, q, k, v, out, lse, dout, nsplit)


@pytest.mark.parametrize("shape", [(1, 512, 3072, 2304), (2, 40, 300, 256),
                                   (1, 17, 99, 64)])
def test_memcom_xattn_bwd_wgmma_pieces_match_their_restatement(cuda, rng,
                                                               shape):
    """What the first two kernels leave in the workspace: D_i as the
    restatement's up to float32 sums of D products in another order
    (2^-13 of the row's sum of |dO o O|), P and dS within one bf16 step of
    the restatement's (float32 S and dP summed in another order flip a
    few roundings), and exactly 0 in the columns T..Tp past the keys.  A
    query row whose cotangent is 0 gets exactly no dq."""
    B, M, T, D = shape
    q, k, v, out, lse, dout = _xbwd_inputs(rng, shape, "bfloat16")
    dout[:, 3] = 0
    dq, dk, dv, p, ds, di = mx.wgmma_bwd_pieces(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert p.shape == ds.shape == (B, M, -(-T // 8) * 8)
    assert not p[..., T:].any() and not ds[..., T:].any()
    assert not dq[:, 3].any()
    terms = dout.float() * out.float()
    assert bool(((di - terms.sum(-1)).abs()
                 <= 2.0 ** -13 * terms.abs().sum(-1)).all())
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, dout))
    s = torch.einsum("bmd,btd->bmt", qf, kf) * D ** -0.5
    pr = torch.exp(s - lse[..., None])
    dsr = pr * (torch.einsum("bmd,btd->bmt", gf, vf) - terms.sum(-1)[..., None])
    pr, dsr = (x.to(torch.bfloat16).float() for x in (pr, dsr))
    assert plain.bf16_ulps(p[..., :T], pr) <= 1.0
    assert plain.bf16_ulps(ds[..., :T], dsr) <= 1.0


@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
def test_memcom_xattn_bwd_is_deterministic(cuda, rng, variant):
    """Two calls on the same inputs give the same bits (no atomics; the
    dQ splits add in a fixed order), at a split count above 1."""
    shape = (1, 512, 3072, 1536)
    q, k, v, out, lse, dout = _xbwd_inputs(rng, shape, "bfloat16")
    if variant == "wgmma":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert mx.bwd_num_splits(*shape, sms) > 1
    a = mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=variant)
    b = mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=variant)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_memcom_xattn_bwd_dispatch_and_forced_variants(cuda, rng):
    """bf16 calls at D % 64 == 0 go to the wgmma backward unforced, other
    bf16 widths to mma.sync; a forced variant that does not take the call
    raises."""
    for shape, want in (((1, 40, 300, 256), 1), ((1, 17, 99, 72), 0)):
        q, k, v, out, lse, dout = _xbwd_inputs(rng, shape, "bfloat16")
        before = mx.bwd_wgmma_launches
        mx.memcom_xattn_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        assert mx.bwd_wgmma_launches == before + want
    with pytest.raises(NotImplementedError):  # D % 64 != 0
        mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant="wgmma")
    q, k, v, out, lse, dout = _xbwd_inputs(rng, (1, 40, 300, 256), "float32")
    for variant in ("wgmma", "mma_sync"):
        with pytest.raises(NotImplementedError):
            mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=variant)
    with pytest.raises(ValueError):
        mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant="tc")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_through_ops_reach_the_inputs(cuda, rng, dtype):
    """``loss.backward()`` through ``ops.attention_with_prefix`` (two flash
    calls merged by their lse) and ``ops.memcom_xattn`` on the card gives
    the inputs non-zero gradients equal to the plain path's (autograd of
    the plain versions on the same inputs), through the backward kernels."""
    B, S, m, Hq, Hkv, D = 2, 24, 40, 8, 4, 256
    leaves = [_rand(rng, *s, dtype=dtype) for s in (
        (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, m, Hkv, D),
        (B, m, Hkv, D), (B, m, 512), (B, 300, 512), (B, 300, 512))]
    w_attn = _rand(rng, B, S, Hq, D, dtype="float32")
    w_x = _rand(rng, B, m, 512, dtype="float32")

    def grads(impl):
        xs = [t.detach().clone().requires_grad_(True) for t in leaves]
        o = ops.attention_with_prefix(*xs[:5], softcap=50.0, impl=impl)
        x = ops.memcom_xattn(*xs[5:], impl=impl)
        loss = (o.float() * w_attn).sum() + (x.float() * w_x).sum()
        return torch.autograd.grad(loss, xs)

    before = (fa.bwd_launches, mx.bwd_launches, mx.bwd_wgmma_launches)
    got = grads("cuda")
    torch.cuda.synchronize()
    assert (fa.bwd_launches, mx.bwd_launches, mx.bwd_wgmma_launches) == (
        before[0] + 2, before[1] + 1, before[2] + (dtype == "bfloat16"))
    want = grads("torch")
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(g.float().abs().max()) > 0, i
        if dtype == "float32":
            _assert_grad_close(g, w, dtype, f"input {i}")
        else:  # the two paths round their bf16 intermediates differently
            assert _err(g, w) <= 2e-2 * float(w.float().abs().max()), i


# ---- gmm and ssd backward kernels ------------------------------------------

GMM_BWD_CASES = [
    (40, 256, 1536, 512), (40, 256, 512, 1536),   # granite training, C 256
    (5, 8, 96, 64),                               # granite-moe-smoke
    (3, 37, 40, 24),      # ragged C; D and F multiples of 8, not of tiles
    (2, 13, 19, 7),       # D and F not multiples of 8: element-wise loads
    (1, 1, 8, 8), (2, 0, 16, 24),                 # one row, no rows
]


@pytest.mark.parametrize("case", GMM_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_bwd_matches_plain(cuda, rng, case, dtype):
    """dX and dW, each alone and together, against ``plain.gmm_bwd_ref``;
    a second call gives the same bits (no atomics)."""
    E, C, D, F = case
    x = _rand(rng, E, C, D, dtype=dtype)
    w = _rand(rng, E, D, F, dtype=dtype, scale=D ** -0.5)
    dy = _rand(rng, E, C, F, dtype=dtype)
    want = plain.gmm_bwd_ref(x, w, dy)
    for need in ((True, False), (False, True), (True, True)):
        before = (moe_gmm.bwd_launches, moe_gmm.bwd_dx_launches,
                  moe_gmm.bwd_dw_launches)
        got = moe_gmm.gmm_bwd(x, w, dy, need_dx=need[0], need_dw=need[1])
        torch.cuda.synchronize()
        assert (moe_gmm.bwd_launches, moe_gmm.bwd_dx_launches,
                moe_gmm.bwd_dw_launches) == (before[0] + 1,
                                             before[1] + need[0],
                                             before[2] + need[1])
        again = moe_gmm.gmm_bwd(x, w, dy, need_dx=need[0], need_dw=need[1])
        for name, g, a, wn, n in zip(("dx", "dw"), got, again, want, need):
            if not n:
                assert g is None
                continue
            assert g.dtype == x.dtype and g.shape == wn.shape
            assert torch.equal(g, a), name
            if wn.numel():  # no rows: dx is empty, dw all 0
                _assert_grad_close(g, wn, dtype, name)
            assert not bool(wn.any()) or bool(g.any()), name


def test_gmm_backward_through_autograd_launches_the_products_needed(cuda,
                                                                    rng):
    """``ops.gmm`` on inputs that need a gradient goes through ``Gmm``:
    its backward launches dX alone for x, dW alone for w; under no_grad
    the forward alone."""
    x = _rand(rng, 4, 40, 64, dtype="bfloat16")
    w = _rand(rng, 4, 64, 32, dtype="bfloat16", scale=0.125)
    dy = _rand(rng, 4, 40, 32, dtype="bfloat16")
    want = plain.gmm_bwd_ref(x, w, dy)
    for which in (0, 1):
        leaves = [x.clone(), w.clone()]
        leaves[which].requires_grad_(True)
        before = (moe_gmm.launches, moe_gmm.bwd_dx_launches,
                  moe_gmm.bwd_dw_launches)
        out = ops.gmm(*leaves)
        (g,) = torch.autograd.grad(out, [leaves[which]], dy)
        torch.cuda.synchronize()
        assert (moe_gmm.launches, moe_gmm.bwd_dx_launches,
                moe_gmm.bwd_dw_launches) == (before[0] + 1,
                                             before[1] + (which == 0),
                                             before[2] + (which == 1))
        _assert_grad_close(g, want[which], "bfloat16", "dx dw"[which])
    before = (moe_gmm.launches, moe_gmm.bwd_launches)
    with torch.no_grad():
        out = ops.gmm(x, w.clone().requires_grad_(True))
    assert out.grad_fn is None
    assert (moe_gmm.launches, moe_gmm.bwd_launches) == (before[0] + 1,
                                                        before[1])


SSD_BWD_CASES = [
    # (B, S, H, P, G, N, initial state, dt·|A| past 100 in a chunk, dhf)
    (2, 3072, 32, 64, 1, 128, False, False, False),  # mamba2-370m training
    (1, 1000, 32, 64, 2, 128, True, False, True),    # two groups, h0, dhf
    (1, 1000, 32, 64, 2, 128, True, True, True),     # dt·|A| = 25 a token
    (2, 70, 8, 16, 1, 16, True, False, True),        # smoke widths
    (1, 50, 4, 40, 2, 8, True, False, True),         # P no multiple of 16
    (3, 1, 4, 64, 1, 128, True, False, True),        # one token
]


@pytest.mark.parametrize("case", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_matches_plain(cuda, rng, case, dtype):
    """``ssd_scan.ssd_bwd`` against ``plain.ssd_bwd_ref`` (float32 inputs
    widened to float64 for the plain version, as the kernel sums them);
    a second call gives the same bits (no atomics)."""
    *shape, with_dhf = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, tuple(shape), dtype, cuda)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dy = _rand(rng, B, S, H, P, dtype=dtype)
    dhf = _rand(rng, B, H, P, N) if with_dhf else None
    before = ssd_scan.bwd_launches
    got = ssd_scan.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhf)
    torch.cuda.synchronize()
    assert ssd_scan.bwd_launches == before + 1
    again = ssd_scan.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhf)
    wide = [None if a is None else a.double() if dtype == "float32" else a
            for a in (x, dt, A, Bm, Cm, h0, dy, dhf)]
    want = plain.ssd_bwd_ref(*wide)
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    for name, g, a, wn in zip(names, got, again, want):
        if wn is None:
            assert g is None
            continue
        assert g.shape == wn.shape and bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, a), name
        _assert_grad_close(g, wn, dtype, name)


def test_ssd_backward_through_autograd(cuda, rng):
    """``ops.ssd`` on inputs that need a gradient goes through ``Ssd``:
    one backward launch, the gradients of the plain backward, an unused
    final state a zero cotangent."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(
        rng, (1, 300, 8, 64, 1, 128, True, False), "bfloat16", cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
    dy = _rand(rng, *x.shape, dtype="bfloat16")
    before = (ssd_scan.launches, ssd_scan.chunked_launches,
              ssd_scan.bwd_launches)
    y, _ = ops.ssd(*leaves[:5], init_state=leaves[5])
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.chunked_launches,
            ssd_scan.bwd_launches) == (before[0] + 1, before[1] + 1,
                                       before[2] + 1)
    want = plain.ssd_bwd_ref(x, dt, A, Bm, Cm, h0, dy, None)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_grad_close(g, w, "bfloat16", f"input {i}")


GMM_BWD_VARIANT_CASES = [
    (40, 256, 512, 1536),   # granite D = 512: dX on the 256 x 192 tile
    (40, 256, 1536, 512),   # D = 1536: 256 x 128 on four warpgroups
    (3, 37, 40, 24),        # ragged C: one 64-row warpgroup, K = C = 37
    (4, 100, 136, 72),      # two warpgroups, ragged rows and columns
    (2, 300, 64, 136),      # two row tiles, the second ragged
    (2, 0, 16, 24),         # no rows: dx empty, dw all 0
]


@pytest.mark.parametrize("case", GMM_BWD_VARIANT_CASES)
@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
def test_gmm_bwd_variants_match_plain(cuda, rng, case, variant):
    """Each bf16 backward kernel, forced, against ``plain.gmm_bwd_ref``
    at ragged shapes; a second call gives the same bits; the wgmma
    counter counts the wgmma calls alone."""
    E, C, D, F = case
    x = _rand(rng, E, C, D, dtype="bfloat16")
    w = _rand(rng, E, D, F, dtype="bfloat16", scale=D ** -0.5)
    dy = _rand(rng, E, C, F, dtype="bfloat16")
    want = plain.gmm_bwd_ref(x, w, dy)
    before = (moe_gmm.bwd_launches, moe_gmm.bwd_wgmma_launches)
    got = moe_gmm.gmm_bwd(x, w, dy, variant=variant)
    torch.cuda.synchronize()
    assert (moe_gmm.bwd_launches, moe_gmm.bwd_wgmma_launches) == (
        before[0] + 1, before[1] + (variant == "wgmma"))
    again = moe_gmm.gmm_bwd(x, w, dy, variant=variant)
    for name, g, a, wn in zip(("dx", "dw"), got, again, want):
        assert g.dtype == x.dtype and g.shape == wn.shape, name
        assert torch.equal(g, a), name
        if wn.numel():
            _assert_grad_close(g, wn, "bfloat16", name)
        assert not bool(wn.any()) or bool(g.any()), name


SSD_BWD_VARIANT_CASES = [
    # (B, S, H, P, G, N, initial state, dt·|A| = 25, dhf)
    (1, 300, 8, 64, 1, 128, True, False, True),    # S not a multiple of 128
    (2, 257, 4, 64, 2, 128, False, False, False),  # one token past 2 chunks
    (1, 200, 8, 64, 2, 128, True, True, True),     # dt·|A| = 25 a token
    (1, 128, 12, 64, 3, 128, True, False, True),   # 4 heads a group, G 3
    (1, 129, 6, 64, 3, 128, True, False, True),    # 2 heads a group
]


@pytest.mark.parametrize("case", SSD_BWD_VARIANT_CASES)
@pytest.mark.parametrize("variant", ["chunked", "sequential"])
def test_ssd_bwd_variants_match_plain(cuda, rng, case, variant):
    """Each bf16 backward kernel, forced, against ``plain.ssd_bwd_ref``
    at ragged shapes; a second call gives the same bits; the chunked
    counter counts the chunked calls alone."""
    *shape, with_dhf = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, tuple(shape), "bfloat16", cuda)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dy = _rand(rng, B, S, H, P, dtype="bfloat16")
    dhf = _rand(rng, B, H, P, N) if with_dhf else None
    before = (ssd_scan.bwd_launches, ssd_scan.bwd_chunked_launches)
    got = ssd_scan.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhf, variant=variant)
    torch.cuda.synchronize()
    assert (ssd_scan.bwd_launches, ssd_scan.bwd_chunked_launches) == (
        before[0] + 1, before[1] + (variant == "chunked"))
    again = ssd_scan.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhf, variant=variant)
    want = plain.ssd_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dhf)
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    for name, g, a, wn in zip(names, got, again, want):
        if wn is None:
            assert g is None
            continue
        assert g.shape == wn.shape and bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, a), name
        _assert_grad_close(g, wn, "bfloat16", name)


def test_ssd_bwd_chunked_matches_its_restatement(cuda, rng):
    """The chunked backward against ``plain.ssd_bwd_chunk_parallel`` (its
    phases and hi/lo rounding points) on the same card inputs: every
    gradient within the 2e-2 rule, the float32 ones (ddt, dA, dh0) within
    1e-3 of the restatement's largest value."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(
        rng, (1, 300, 8, 64, 2, 128, True, False), "bfloat16", cuda)
    dy = _rand(rng, *x.shape, dtype="bfloat16")
    dhf = _rand(rng, 1, 8, 64, 128)
    got = ssd_scan.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhf, variant="chunked")
    want = plain.ssd_bwd_chunk_parallel(x, dt, A, Bm, Cm, h0, dy, dhf)
    for name, g, wn in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                           want):
        _assert_grad_close(g, wn, "bfloat16", name)
        if g.dtype == torch.float32:
            assert _err(g, wn) <= 1e-3 * float(wn.abs().max()), name


@pytest.mark.parametrize("variant", ["icae", "icae+", "icae++"])
def test_icae_step_kernels_against_plain(cuda, variant):
    """An ICAE training step's loss and every trained gradient on
    gemma2-2b's smoke config (float32, head dim 24: the float32 flash
    kernels) under remat, through the kernels and forced to the plain
    versions: within 1e-4 of the plain run's largest magnitude (the two
    sum in different orders); one flash backward call a layer in the
    compressor and one in the target (``mem_embed`` and the soft tokens
    need gradients).  The bf16 kernels' ICAE step is held to the plain
    one at full width by ``chip_smoke.py`` (phase 5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import icae
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config("gemma2-2b")
    target = tfm.init_params(cfg, 0, device=cuda)
    ic = icae.init_icae(cfg, target, variant, seed=1)
    with torch.no_grad():  # b off zero: at init every gradient of a is 0
        for ad in ic.lora.adapters().values():
            ad.b.normal_(0, 0.1)
    trained = icae.set_trainable(ic)
    batch = {key: torch.as_tensor(rng_.integers(0, cfg.vocab_size, (2, n)),
                                  device=cuda)
             for key, n, rng_ in (("source", 96, np.random.default_rng(4)),
                                  ("target", 32, np.random.default_rng(5)))}

    def run():
        loss, _ = icae.icae_loss(ic, target, cfg, batch, remat=True)
        return (float(loss.detach()),
                torch.autograd.grad(loss, list(trained.values())))

    before = fa.bwd_launches
    loss_k, g_k = run()
    assert fa.bwd_launches - before == 2 * cfg.num_layers
    ops.set_default_impl("torch")
    try:
        loss_p, g_p = run()
    finally:
        ops.set_default_impl(None)
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    for name, a, b in zip(trained, g_k, g_p):
        big = float(b.abs().max())
        assert big > 0 and _err(a, b) <= 1e-4 * big, name


# ---------------------------------------------------------------------------
# Head widths no kernel is built for (the Pallas kernels take any width):
# the flash wrappers pad q, k, v to fa.tile_dims' tile and slice the output
# and gradients; the paged kernel runs at pa.tile_dims' tile with its
# loads past the call's widths skipped and zero-filled.  Each at the
# configs' widths (16: whisper and jamba smoke; 32: qwen2-vl smoke and
# the bench target; MLA smoke's (24, 16) and (40, 32)) and a few more,
# against the plain version on the same inputs.  Then the new models'
# shapes at full width: qwen2-vl-2b's GQA group of 6 (12 query heads on 2
# KV heads of 128) and whisper-medium's non-causal calls over 1500 frames
# (16 heads of 64, every position 0; 1500 = 23 x 64 + 28).
# ---------------------------------------------------------------------------

WIDTHS = [(16, 16), (32, 32), (24, 16), (40, 32), (8, 8), (48, 48),
          (96, 96), (136, 64), (200, 200), (64, 256)]


@pytest.mark.parametrize("D,Dv", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_padded_widths_match_plain(cuda, rng, D, Dv, dtype):
    """Forward (each bf16 kernel forced, causal and against a prefix, with
    a softcap) and backward (the direct call and autograd through the
    pad) at widths no kernel is built for; one launch a call, at the
    tile."""
    B, Sq, Skv, Hq, Hkv = 2, 70, 150, 6, 2
    ar = torch.arange(Skv, dtype=torch.int32, device=cuda)
    kv_pos = ar.expand(B, Skv).contiguous()
    q_pos = ar[Skv - Sq:].expand(B, Sq).contiguous()
    q = _rand(rng, B, Sq, Hq, D, dtype=dtype)
    k = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
    v = _rand(rng, B, Skv, Hkv, Dv, dtype=dtype)
    dout = _rand(rng, B, Sq, Hq, Dv, dtype=dtype)
    dlse = _rand(rng, B, Sq, Hq)
    variants = (None, "wgmma", "mma_sync") if dtype == "bfloat16" else (None,)
    for causal, cap in ((True, 0.0), (False, 30.0)):
        kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap)
        ref, ref_lse = plain.attention_ref(q, k, v, return_lse=True, **kw)
        for var in variants:
            before = fa.launches
            out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                          variant=var, **kw)
            torch.cuda.synchronize()
            assert fa.launches == before + 1
            assert out.shape == (B, Sq, Hq, Dv) and out.dtype == q.dtype
            _assert_close(out, ref, dtype)
            assert _err(lse, ref_lse) <= TOL["float32"] * max(
                1.0, float(ref_lse.abs().max()))
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse, **kw)
        want = plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == w.shape
            _assert_grad_close(g, w, dtype, name)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = fa.bwd_launches
    out = fa.flash_attention(qg, kg, vg, q_pos=q_pos, kv_pos=kv_pos)
    (out.float() * dout.float()).sum().backward()
    assert fa.bwd_launches == before + 1
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = plain.attention_ref(tq, tk, tv, q_pos=q_pos, kv_pos=kv_pos)
    (ref.float() * dout.float()).sum().backward()
    for name, a, b in (("dq", qg, tq), ("dk", kg, tk), ("dv", vg, tv)):
        _assert_grad_close(a.grad, b.grad, dtype, name)


PAGED_WIDTH_CASES = [
    # (B, S, Hq, Hkv, D, block_size, lengths, softcap, table) and Dv
    ((4, 1, 4, 4, 16, 4, [40, 23, 1, 64], 0.0, None), 16),    # whisper smoke
    ((3, 2, 4, 2, 32, 4, [30, 9, 2], 0.0, None), 32),        # qwen2-vl smoke
    ((2, 1, 8, 2, 32, 16, [100, 37], 0.0, 512), 32),          # bench target
    ((2, 3, 16, 1, 40, 4, [25, 12], 0.0, None), 32),          # MLA smoke
    ((2, 1, 4, 4, 24, 4, [13, 31], 50.0, None), 16),
    ((3, 1, 8, 4, 96, 8, [77, 3, 50], 0.0, None), 96),
    ((2, 2, 6, 3, 136, 16, [200, 65], 0.0, None), 64),
    ((2, 1, 4, 2, 200, 8, [90, 31], 0.0, None), 200),
]


@pytest.mark.parametrize("case,dv", PAGED_WIDTH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_padded_widths_match_plain(cuda, rng, case, dv,
                                                      dtype):
    q, k, v, tables, lengths = _paged_inputs(rng, case, dtype, cuda, dv)
    kw = dict(block_tables=tables, lengths=lengths, softcap=case[7])
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    before = pa.launches
    out = pa.paged_flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert out.shape == (*q.shape[:3], dv) and out.dtype == q.dtype
    _assert_close(out, plain.paged_decode_attention_ref(q, k, v, **kw), dtype)
    assert (k.data_ptr(), v.data_ptr()) == (k_ptr, v_ptr)


@pytest.mark.parametrize("nsplit", [1, 2, 7, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_padded_width_at_any_split_count(cuda, rng, monkeypatch,
                                               nsplit, dtype):
    """The cluster merge over the call's 40 value columns of a 64-wide
    tile (rows owned a float4 at a time: 10 a row), some splits empty."""
    case = (4, 3, 8, 2, 40, 16, [520, 2, 0, 70], 0.0, 1024)
    q, k, v, tables, lengths = _paged_inputs(rng, case, dtype, cuda, 40)
    kw = dict(block_tables=tables, lengths=lengths)
    monkeypatch.setattr(pa, "num_splits", lambda *shape: nsplit)
    out = pa.paged_flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(out, plain.paged_decode_attention_ref(q, k, v, **kw), dtype)
    assert float(out[2].float().abs().max()) == 0.0  # an empty slot


# qwen2-vl-2b: 12 query heads on 2 KV heads of 128 (a GQA group of 6):
# the 3072-token source prefill, the 512-row Memory-LLM, a 12-token prompt
# against the 512-row prefix and causal behind it, decode over 4 slots;
# whisper-medium: 16 heads of 64, the encoder's 1500 x 1500 self-attention
# (not causal, every position 0), the decoder's cross-attention of 512
# memory rows and of a 12-token prompt over the 1500 frames, and decode
# over them (1 row a slot).
NEW_MODEL_CASES = [
    # (name, B, Sq, Skv, Hq, Hkv, D, kind)
    ("qwen_source", 1, 3072, 3072, 12, 2, 128, "causal"),
    ("qwen_memory", 1, 512, 512, 12, 2, 128, "causal"),
    ("qwen_prefix", 1, 12, 512, 12, 2, 128, "prefix"),
    ("qwen_prompt", 1, 12, 12, 12, 2, 128, "offset"),
    ("qwen_decode", 4, 1, 540, 12, 2, 128, "decode"),
    ("whisper_encoder", 1, 1500, 1500, 16, 16, 64, "frames"),
    ("whisper_memory_cross", 1, 512, 1500, 16, 16, 64, "frames"),
    ("whisper_prompt_cross", 2, 12, 1500, 16, 16, 64, "frames"),
    ("whisper_decode_cross", 4, 1, 1500, 16, 16, 64, "frames"),
]


def _new_model_positions(B, Sq, Skv, kind, device):
    ar = torch.arange(max(Sq, Skv), dtype=torch.int32, device=device)
    if kind == "frames":  # enc-dec: every position 0, nothing masked
        return (torch.zeros(B, Sq, dtype=torch.int32, device=device),
                torch.zeros(B, Skv, dtype=torch.int32, device=device), False)
    kv_pos = ar[:Skv].expand(B, Skv).contiguous()
    if kind == "decode":
        lens = torch.tensor([Skv - 5 * b for b in range(B)], device=device)
        return (lens[:, None] - 1).to(torch.int32), kv_pos, True
    if kind == "prefix":
        return (Skv + ar[:Sq]).expand(B, Sq).contiguous(), kv_pos, False
    if kind == "offset":
        return ((512 + ar[:Sq]).expand(B, Sq).contiguous(),
                (512 + ar[:Skv]).expand(B, Skv).contiguous(), True)
    return ar[:Sq].expand(B, Sq).contiguous(), kv_pos, True


@pytest.mark.parametrize("case", NEW_MODEL_CASES, ids=lambda c: c[0])
def test_flash_attention_new_model_shapes_match_plain(cuda, rng, case):
    """bf16 through both kernels (each forced) and the picked one, float32
    through its own; the 1500-frame calls' backward too (the next step's
    Phase 1 runs it non-causal over 1500 frames at 64)."""
    name, B, Sq, Skv, Hq, Hkv, D, kind = case
    q_pos, kv_pos, causal = _new_model_positions(B, Sq, Skv, kind, cuda)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal)
    for dtype in ("bfloat16", "float32"):
        q = _rand(rng, B, Sq, Hq, D, dtype=dtype)
        k = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
        v = _rand(rng, B, Skv, Hkv, D, dtype=dtype)
        ref, ref_lse = plain.attention_ref(q, k, v, return_lse=True, **kw)
        variants = ((None, "wgmma", "mma_sync") if dtype == "bfloat16"
                    else (None,))
        for var in variants:
            out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                          variant=var, **kw)
            torch.cuda.synchronize()
            _assert_close(out, ref, dtype)
            assert _err(lse, ref_lse) <= TOL["float32"] * max(
                1.0, float(ref_lse.abs().max()))
        if kind == "frames" and Sq > 1:
            dout = _rand(rng, B, Sq, Hq, D, dtype=dtype)
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want = plain.attention_bwd_ref(q, k, v, out, lse, dout, None,
                                           **kw)
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                _assert_grad_close(g, w, dtype, gname)


@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_group_of_six(cuda, rng, S, dtype):
    """qwen2-vl-2b's paged decode: 12 query heads on 2 KV heads of 128, S
    rows a slot (S * 6 rows a KV head: one row group at S = 1, three at S
    = 3 and 4, the last part-filled), the main path's blocks of 16 behind a
    512-row prefix shared by two slots."""
    case = (4, S, 12, 2, 128, 16, [524, 530, 516, 519], 0.0, None)
    q, k, v, tables, lengths = _paged_inputs(rng, case, dtype, cuda)
    kw = dict(block_tables=tables, lengths=lengths, scale=128 ** -0.5)
    out = pa.paged_flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(out, plain.paged_decode_attention_ref(q, k, v, **kw), dtype)
