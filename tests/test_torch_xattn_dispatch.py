"""The memcom_xattn wrapper's choice of kernel, on the CPU.

``kernels/memcom_xattn.py::variant_for`` picks the CUDA kernel of a call
(``"wgmma"``: bf16 with D a multiple of 64; ``"mma_sync"``: the other bf16
widths; ``"float32"``), ``takes`` says which shapes each kernel computes at
all, and ``num_splits`` cuts T for the wgmma output kernel.  None needs a
card, so all are held here, with the constants ``csrc/memcom_xattn.cu``
states, the plain version for CPU tensors whatever the variant, and a
forced variant that does not take a shape.  The backward's
``bwd_variant_for`` / ``bwd_takes`` (``"wgmma"``, ``"mma_sync"``,
``"float32"``) and ``bwd_num_splits`` (T cut for its dQ tiles) likewise.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import memcom_xattn as mx
from repro_torch.kernels import plain

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "memcom_xattn.cu")

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, B, M, T, D, aligned) -> variant
DISPATCH = [
    (BF16, 1, 512, 3072, 2304, True, "wgmma"),   # gemma2-2b
    (BF16, 1, 512, 3072, 1536, True, "wgmma"),   # granite-moe-3b-a800m
    (BF16, 1, 768, 6144, 4096, True, "wgmma"),   # mistral-7b
    (BF16, 2, 512, 3077, 1536, True, "wgmma"),   # any T
    (BF16, 1, 8, 1, 64, True, "wgmma"),
    (BF16, 1, 4, mx.WGMMA_MAX_T, 64, True, "wgmma"),
    (BF16, 1, 4, mx.WGMMA_MAX_T + 1, 64, True, "mma_sync"),
    (BF16, 1, 8, 40, 96, True, "mma_sync"),      # D % 64 != 0
    (BF16, 3, 70, 200, 136, True, "mma_sync"),
    (BF16, 1, 512, 3072, 2304, False, "mma_sync"),  # a base off 16 bytes
    (F32, 1, 512, 3072, 2304, True, "float32"),
    (F32, 1, 8, 40, 96, False, "float32"),
]


@pytest.mark.parametrize("dtype,B,M,T,D,aligned,want", DISPATCH)
def test_variant_for(dtype, B, M, T, D, aligned, want):
    assert mx.variant_for(dtype, B, M, T, D, aligned) == want


# (variant, dtype, B, M, T, D, aligned) -> whether the kernel takes it
TAKES = [
    ("wgmma", BF16, 1, 512, 3072, 2304, True, True),
    ("wgmma", BF16, 1, 512, 3072, 2304, False, False),
    ("wgmma", BF16, 1, 512, 3072, 2336, True, False),  # D % 64
    ("wgmma", F32, 1, 512, 3072, 2304, True, False),
    ("wgmma", BF16, 1, 4, mx.WGMMA_MAX_T + 1, 64, True, False),
    ("mma_sync", BF16, 1, 8, 40, 96, True, True),
    ("mma_sync", BF16, 1, 8, 40, 16, True, True),
    ("mma_sync", BF16, 1, 8, 40, 12, True, False),    # D % 8
    ("mma_sync", BF16, 1, 8, 40, 100, True, False),    # D % 8
    ("mma_sync", BF16, 1, 8, 40, 96, False, False),
    ("mma_sync", F32, 1, 8, 40, 96, True, False),
    ("float32", F32, 1, 8, 40, 100, True, True),
    ("float32", F32, 1, 8, 40, 100, False, False),
    ("float32", BF16, 1, 8, 40, 96, True, False),
    # the grids: B on one axis (times the splits), M in 64-row tiles
    *((v, BF16, 65535, 8, 40, 64, True, True) for v in ("mma_sync", "wgmma")),
    *((v, BF16, 65536, 8, 40, 64, True, False) for v in ("mma_sync", "wgmma")),
    ("wgmma", BF16, 1, 64 * 65535, 40, 64, True, True),
    ("mma_sync", BF16, 1, 64 * 65535 + 1, 40, 64, True, False),
]


@pytest.mark.parametrize("variant,dtype,B,M,T,D,aligned,want", TAKES)
def test_takes(variant, dtype, B, M, T, D, aligned, want):
    assert mx.takes(variant, dtype, B, M, T, D, aligned) is want


@pytest.mark.parametrize("dtype,B,M,T,D,aligned,want", DISPATCH)
def test_the_chosen_variant_takes_the_call(dtype, B, M, T, D, aligned, want):
    """... if the inputs are 16-byte aligned: every kernel wants that, and
    the wrapper raises on a CUDA call that is not."""
    assert mx.takes(want, dtype, B, M, T, D, aligned) is aligned


def _const(name, src):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_source_states_the_same_constants():
    """The output tile, the split limits and the c_j cut the wrapper and
    the CPU restatement use are the ones the kernels are built with."""
    src = SOURCE.read_text()
    assert 64 * _const("OUT_NWG", src) == mx.OUT_BM
    assert _const("OUT_BN", src) == mx.OUT_BN
    assert _const("MAX_SPLITS", src) == mx.MAX_SPLITS <= 8  # portable
    lg_bn, ct_max = _const("LG_BN", src), _const("CT_MAX", src)
    assert lg_bn == mx.LG_BN
    assert "constexpr int SPLIT_SLABS_MAX = (CT_MAX - 1) * (LG_BN / 64);" \
        in src
    assert (ct_max - 1) * (lg_bn // 64) == mx.SPLIT_SLABS_MAX
    assert inspect.signature(plain.memcom_xattn_tiled).parameters[
        "block_t"].default == lg_bn
    cut = float(re.search(r"constexpr float C_CUT = ([\d.]+)f;", src).group(1))
    assert inspect.signature(plain.memcom_xattn_tiled).parameters[
        "cut"].default == cut
    assert _const("FILL_SPLITS", src) == mx.FILL_SPLITS
    # one output block an SM, from the shared memory a block takes (XCfg:
    # 1024 + stages x (A + B) + the c_j table; 227 KB an SM), which
    # num_splits's waves assume
    nwg, bn = _const("OUT_NWG", src), mx.OUT_BN
    stages = _const("OUT_STAGES", src)
    smem = 1024 + stages * (nwg * 8192 + bn * 128) + 64 * nwg * ct_max * 4
    assert smem <= 232448 < 2 * smem


@pytest.mark.parametrize("B,M,T,D", [
    (1, 512, 3072, 2304), (1, 512, 3072, 1536), (1, 768, 6144, 4096),
    (2, 512, 3077, 1536), (1, 8, 1, 64), (1, 4, mx.WGMMA_MAX_T, 64),
    (4, 1000, 20000, 512), (1, 130, 300, 512)])
def test_num_splits_keeps_each_split_within_its_table(B, M, T, D):
    n = mx.num_splits(B, M, T, D)
    nk = -(-T // 64)
    assert 1 <= n <= mx.MAX_SPLITS
    assert -(-nk // n) <= mx.SPLIT_SLABS_MAX
    # one wave of blocks, up to FILL_SPLITS, unless T needs more splits
    tiles = B * -(-M // mx.OUT_BM) * -(-D // mx.OUT_BN)
    least = -(-nk // mx.SPLIT_SLABS_MAX)
    if n > least:
        assert n <= mx.FILL_SPLITS and tiles * n <= 132
        assert n == mx.FILL_SPLITS or tiles * (n + 1) > 132


def test_num_splits_at_the_measured_shapes():
    """gemma2-2b's 36 output tiles take 3 splits (108 blocks), granite's
    24 take 4, mistral-7b's 96 the 2 its 96 slabs need."""
    assert mx.num_splits(1, 512, 3072, 2304) == 3
    assert mx.num_splits(1, 512, 3072, 1536) == 4
    assert mx.num_splits(1, 768, 6144, 4096) == 2
    assert mx.num_splits(1, 4, mx.WGMMA_MAX_T, 64) == mx.MAX_SPLITS


def _qkv(rng, B, M, T, D, dtype=BF16):
    def draw(*shape):
        x = torch.from_numpy((rng.standard_normal(shape) * 0.5)
                             .astype(np.float32))
        return x.to(dtype)
    return draw(B, M, D), draw(B, T, D), draw(B, T, D)


@pytest.mark.parametrize("variant", [None, "wgmma", "mma_sync"])
def test_cpu_tensors_go_to_the_plain_version_uncounted(variant):
    q, k, v = _qkv(np.random.default_rng(0), 2, 8, 40, 64)
    before = (mx.launches, mx.wgmma_launches)
    out = mx.memcom_xattn(q, k, v, variant=variant)
    assert (mx.launches, mx.wgmma_launches) == before
    assert torch.equal(out, plain.memcom_xattn_ref(q, k, v))


@pytest.mark.parametrize("variant,shape,dtype,shift", [
    ("wgmma", (1, 8, 40, 96), BF16, False),     # D % 64 != 0
    ("mma_sync", (1, 8, 40, 12), BF16, False),  # D % 8 != 0
    ("wgmma", (1, 8, 40, 64), F32, False),      # bf16 kernels
    ("mma_sync", (1, 8, 40, 64), F32, False),
    ("wgmma", (1, 8, 40, 64), BF16, True),      # q off a 16-byte boundary
    ("mma_sync", (1, 8, 40, 64), BF16, True),
    ("wgmma", (1, 4, mx.WGMMA_MAX_T + 1, 64), BF16, False),
])
def test_a_forced_variant_raises_on_a_shape_it_does_not_take(
        variant, shape, dtype, shift):
    B, M, T, D = shape
    q, k, v = _qkv(np.random.default_rng(1), B, M, T, D, dtype)
    if shift:  # contiguous, one element past an aligned base
        flat = torch.zeros(q.numel() + 1, dtype=dtype)
        q = flat[1:].view(B, M, D).copy_(q)
        assert q.data_ptr() % 16
    with pytest.raises(NotImplementedError):
        mx.memcom_xattn(q, k, v, variant=variant)
    # unforced, the call goes to the plain version
    assert torch.equal(mx.memcom_xattn(q, k, v),
                       plain.memcom_xattn_ref(q, k, v))


def test_wgmma_pieces_needs_the_card():
    """``wgmma_pieces`` reads the wgmma kernel's workspace: a CPU call has
    none, and raises."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 8, 40, 64)
    before = (mx.launches, mx.wgmma_launches)
    with pytest.raises(NotImplementedError):
        mx.wgmma_pieces(q, k, v)
    assert (mx.launches, mx.wgmma_launches) == before


def test_an_unknown_variant_raises():
    q, k, v = _qkv(np.random.default_rng(2), 1, 4, 8, 64)
    with pytest.raises(ValueError):
        mx.memcom_xattn(q, k, v, variant="tma")


# The backward: (dtype, B, M, T, D, aligned) -> variant.  The wgmma
# backward has no limit on T of its own (beyond the forward's
# WGMMA_MAX_T too).
BWD_DISPATCH = [
    (BF16, 2, 512, 3072, 2304, True, "wgmma"),   # gemma2-2b training
    (BF16, 1, 512, 3072, 1536, True, "wgmma"),   # granite's width
    (BF16, 1, 768, 6144, 4096, True, "wgmma"),   # mistral-7b's
    (BF16, 2, 40, 300, 256, True, "wgmma"),      # ragged M and T
    (BF16, 1, 17, 99, 64, True, "wgmma"),
    (BF16, 1, 4, mx.WGMMA_MAX_T + 1, 64, True, "wgmma"),
    (BF16, 1, 17, 99, 72, True, "mma_sync"),     # D % 64 != 0
    (BF16, 3, 70, 200, 136, True, "mma_sync"),
    (BF16, 2, 512, 3072, 2304, False, "mma_sync"),  # a base off 16 bytes
    (F32, 2, 512, 3072, 2304, True, "float32"),
    (F32, 1, 8, 40, 96, False, "float32"),
]


@pytest.mark.parametrize("dtype,B,M,T,D,aligned,want", BWD_DISPATCH)
def test_bwd_variant_for(dtype, B, M, T, D, aligned, want):
    assert mx.bwd_variant_for(dtype, B, M, T, D, aligned) == want


BWD_TAKES = [
    ("wgmma", BF16, 2, 512, 3072, 2304, True, True),
    ("wgmma", BF16, 2, 512, 3072, 2304, False, False),
    ("wgmma", BF16, 1, 17, 99, 72, True, False),    # D % 64
    ("wgmma", F32, 1, 17, 99, 64, True, False),
    ("wgmma", BF16, 1, 8, 2 ** 24, 64, True, True),  # 131,072 S / dP tiles
    ("wgmma", BF16, 64, 2 ** 20, 2 ** 20, 64, True, False),  # 2^32 tiles
    ("mma_sync", BF16, 1, 17, 99, 72, True, True),
    ("mma_sync", BF16, 1, 17, 99, 100, True, False),  # D % 8
    ("mma_sync", BF16, 1, 17, 99, 72, False, False),
    ("mma_sync", F32, 1, 17, 99, 72, True, False),
    ("float32", F32, 1, 17, 99, 100, False, True),
    ("float32", BF16, 1, 17, 99, 64, True, False),
]


@pytest.mark.parametrize("variant,dtype,B,M,T,D,aligned,want", BWD_TAKES)
def test_bwd_takes(variant, dtype, B, M, T, D, aligned, want):
    assert mx.bwd_takes(variant, dtype, B, M, T, D, aligned) is want


@pytest.mark.parametrize("dtype,B,M,T,D,aligned,want", BWD_DISPATCH)
def test_the_chosen_backward_takes_the_call(dtype, B, M, T, D, aligned,
                                            want):
    """... where the kernels take the call at all: bf16 wants 16-byte
    aligned inputs (the wrapper raises on a CUDA call that is not);
    float32 takes any."""
    assert mx.bwd_takes(want, dtype, B, M, T, D, aligned) is (
        aligned or dtype == F32)


def test_source_states_the_backward_constants():
    """The S / dP tile, its ring and the dQ split limit the wrapper uses
    are the ones the kernels are built with; both kernels' shared memory
    fits an SM once (the split rule's one block an SM)."""
    src = SOURCE.read_text()
    nwg = _const("SDP_NWG", src)
    assert (64 * nwg, _const("SDP_BN", src)) == (mx.SDP_BM, mx.SDP_BN)
    assert _const("GRAD_MAX_SPLITS", src) == mx.GRAD_MAX_SPLITS \
        <= mx.MAX_SPLITS
    stages = _const("SDP_STAGES", src)
    sdp = 1024 + stages * 2 * (nwg * 8192 + mx.SDP_BN * 128)
    assert sdp <= 232448 < 2 * sdp
    out_nwg = _const("OUT_NWG", src)
    grad = 1024 + _const("OUT_STAGES", src) * (out_nwg * 8192
                                               + mx.OUT_BN * 128)
    assert grad <= 232448 < 2 * grad
    assert "using GradCfg = XCfg<OUT_NWG, OUT_BN, true>;" in src


def test_bwd_num_splits_at_the_measured_shapes():
    """gemma2-2b's training call (72 dQ tiles of 48 slabs against a mean
    of 78.5 slabs a block) and mistral-7b's take 1; granite's 24 dQ
    tiles of 48 slabs against a mean of 26.2 take 2."""
    assert mx.bwd_num_splits(2, 512, 3072, 2304) == 1
    assert mx.bwd_num_splits(1, 512, 3072, 1536) == 2
    assert mx.bwd_num_splits(1, 768, 6144, 4096) == 1
    assert mx.bwd_num_splits(1, 17, 99, 64) == 2      # 2 slabs, 1 tile
    assert mx.bwd_num_splits(1, 8, 60, 64) == 1       # one slab


@pytest.mark.parametrize("B,M,T,D,sms", [
    (2, 512, 3072, 2304, 132), (1, 512, 3072, 1536, 132),
    (1, 768, 6144, 4096, 132), (2, 40, 300, 256, 132), (1, 17, 99, 64, 132),
    (2, 130, 700, 512, 132), (1, 512, 3072, 2304, 16), (4, 64, 70, 128, 1),
    (1, 512, 40000, 64, 132)])
def test_bwd_num_splits_rule(B, M, T, D, sms):
    """1..GRAD_MAX_SPLITS splits, none empty; the fewest whose split
    walks no more slabs than a block's mean, where one does."""
    n = mx.bwd_num_splits(B, M, T, D, sms)
    nk = -(-T // 64)
    assert 1 <= n <= min(mx.GRAD_MAX_SPLITS, nk)
    per = -(-nk // n)
    assert (n - 1) * per < nk                          # none empty
    q_tiles = B * -(-M // mx.OUT_BM) * -(-D // mx.OUT_BN)
    kv_tiles = 2 * B * -(-T // mx.OUT_BM) * -(-D // mx.OUT_BN)
    mean = (q_tiles * nk + kv_tiles * -(-M // 64)) / sms
    fits = [s for s in range(1, mx.GRAD_MAX_SPLITS + 1)
            if -(-nk // s) <= mean]
    if fits and fits[0] <= nk:
        assert -(-nk // n) == -(-nk // fits[0])


@pytest.mark.parametrize("variant,shape,dtype,shift", [
    ("wgmma", (1, 8, 40, 96), BF16, False),     # D % 64 != 0
    ("mma_sync", (1, 8, 40, 12), BF16, False),  # D % 8 != 0
    ("wgmma", (1, 8, 40, 64), F32, False),      # bf16 kernels
    ("mma_sync", (1, 8, 40, 64), F32, False),
    ("wgmma", (1, 8, 40, 64), BF16, True),      # dout off a 16-byte boundary
    ("mma_sync", (1, 8, 40, 64), BF16, True),
])
def test_a_forced_backward_raises_on_a_shape_it_does_not_take(
        variant, shape, dtype, shift):
    B, M, T, D = shape
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, B, M, T, D, dtype)
    dout = _qkv(rng, B, M, T, D, dtype)[0]
    out, lse = mx.memcom_xattn(q, k, v, return_lse=True)
    if shift:  # contiguous, one element past an aligned base
        flat = torch.zeros(dout.numel() + 1, dtype=dtype)
        dout = flat[1:].view(B, M, D).copy_(dout)
        assert dout.data_ptr() % 16
    with pytest.raises(NotImplementedError):
        mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=variant)
    # unforced, the call goes to the plain version
    got = mx.memcom_xattn_bwd(q, k, v, out, lse, dout)
    want = plain.memcom_xattn_bwd_ref(q, k, v, dout)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wgmma_bwd_pieces_needs_the_card():
    q, k, v = _qkv(np.random.default_rng(5), 1, 8, 40, 64)
    out, lse = mx.memcom_xattn(q, k, v, return_lse=True)
    before = (mx.bwd_launches, mx.bwd_wgmma_launches)
    with pytest.raises(NotImplementedError):
        mx.wgmma_bwd_pieces(q, k, v, out, lse, q)
    with pytest.raises(ValueError):
        mx.memcom_xattn_bwd(q, k, v, out, lse, q, variant="tma")
    assert (mx.bwd_launches, mx.bwd_wgmma_launches) == before
