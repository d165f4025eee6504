"""Wrapper of the hand-written Hopper MemCom cross-attention kernels.

``csrc/memcom_xattn.cu`` replaces the Pallas TPU kernel
``repro/kernels/memcom_xattn.py::memcom_xattn`` and is held to
``plain.memcom_xattn_ref``.  A CPU tensor goes to the plain version; a CUDA
tensor launches a kernel (built on first use, see :mod:`.build`) or
raises — there is no fallback.  The source holds three variants, and
:func:`variant_for` picks one from the call's shape: ``"wgmma"`` (bf16 on
Hopper's wgmma: a logits kernel whose epilogue writes per-tile softmax
pieces, and an output kernel that rescales them and splits T across a
thread block cluster; two launches), ``"mma_sync"`` (bf16 at other
widths: logits, softmax rows and output on mma.sync, three launches) and
``"float32"``.  ``launches`` counts wrapper calls that launched a kernel;
``wgmma_launches`` those that went to the wgmma variant.

Every kernel also gives each query row's logsumexp (``return_lse``).

A CUDA call is differentiable: when q, k or v needs a gradient the
forward runs inside :class:`MemcomXattn` (an ``autograd.Function`` whose
forward is the same kernel on the values centred over T, keeping out and
lse; see its docstring) and its backward launches the hand-written
backward of ``csrc/memcom_xattn.cu``
(:func:`memcom_xattn_bwd`, held to ``plain.memcom_xattn_bwd_ref``), whose
variant :func:`bwd_variant_for` picks: ``"wgmma"`` (bf16 at D % 64 == 0:
D_i from out, S and dP on wgmma with P and dS formed in their epilogue
from lse, then dQ, dK and dV tiles in one launch; three launches),
``"mma_sync"`` (the other bf16 widths: five products on mma.sync and a
softmax row pass; six launches) and ``"float32"``.  There is no fallback
to the plain backward.  ``bwd_launches`` counts backward calls,
``bwd_wgmma_launches`` those that went to the wgmma variant.  With no
gradient needed the call is the plain kernel call, as before.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0
wgmma_launches = 0
bwd_launches = 0
bwd_wgmma_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"float32": 0, "mma_sync": 0, "wgmma": 1}

# The wgmma variant's constants, as csrc/memcom_xattn.cu states them: the
# columns of a logits tile (one softmax piece a row), the output tile (OUT_BM = 64 OUT_NWG rows x OUT_BN columns, one block an SM),
# the most splits of T a tile (a portable cluster), the most splits that
# only fill the card, and the most 64-deep slabs of T one split walks (its
# per-row softmax scales fit the block's table).
LG_BN = 128
OUT_BM, OUT_BN = 128, 256
MAX_SPLITS = 8
FILL_SPLITS = 4
SPLIT_SLABS_MAX = 62
WGMMA_MAX_T = MAX_SPLITS * SPLIT_SLABS_MAX * 64
_MAX_GRID = 65535
# The wgmma backward's: its S / dP tile (SDP_BM x SDP_BN), its gradient
# tile (OUT_BM x OUT_BN, the forward output kernel's) and the most splits
# of T a dQ tile (a cluster).
SDP_BM, SDP_BN = 128, 96
GRAD_MAX_SPLITS = 4
_MAX_BLOCKS = 2 ** 31 - 1


def _cdiv(a, b):
    return -(-a // b)


def takes(variant, dtype, B, M, T, D, aligned) -> bool:
    """Whether kernel ``variant`` computes a call of this shape at all;
    ``aligned``: q, k and v start on 16-byte boundaries."""
    if not aligned or B > _MAX_GRID or _cdiv(M, 64) > _MAX_GRID:
        return False
    if variant == "float32":
        return dtype == torch.float32
    if dtype != torch.bfloat16:
        return False
    if variant == "mma_sync":
        return D % 8 == 0
    return (variant == "wgmma" and D % 64 == 0 and T <= WGMMA_MAX_T
            and B * num_splits(B, M, T, D) <= _MAX_GRID)


def variant_for(dtype, B, M, T, D, aligned) -> str:
    """The kernel a CUDA call goes to: float32 runs on the CUDA cores; a
    bf16 call the wgmma variant takes (D a multiple of 64 — gemma2-2b's
    2304, granite's 1536, mistral-7b's 4096 — T up to ``WGMMA_MAX_T``,
    16-byte aligned inputs) goes to it; the others to mma.sync."""
    if dtype == torch.float32:
        return "float32"
    if takes("wgmma", dtype, B, M, T, D, aligned):
        return "wgmma"
    return "mma_sync"


def num_splits(B, M, T, D, sms=132) -> int:
    """Splits of T for each output tile of the wgmma variant (the blocks
    of one thread block cluster): as many as keep one wave of blocks, one
    on each of the ``sms`` multiprocessors, up to ``FILL_SPLITS``; at
    least as many as keep a split within ``SPLIT_SLABS_MAX`` slabs.  Set
    from the split counts' device times that scripts/xattn_times.py
    measures (PERF.md section 6): a second wave of blocks costs more than
    the shorter walks save, and clusters of more than 4 such blocks did
    not all fit the card at once."""
    tiles = B * _cdiv(M, OUT_BM) * _cdiv(D, OUT_BN)
    least = _cdiv(_cdiv(T, 64), SPLIT_SLABS_MAX)
    return max(least, min(FILL_SPLITS, sms // tiles), 1)


def bwd_takes(variant, dtype, B, M, T, D, aligned) -> bool:
    """Whether backward kernel ``variant`` computes a call of this shape
    at all; ``aligned``: q, k, v, out and dout start on 16-byte
    boundaries (the bf16 kernels read 16 bytes at a time)."""
    if variant == "float32":
        return dtype == torch.float32
    if dtype != torch.bfloat16 or not aligned:
        return False
    if variant == "mma_sync":
        return D % 8 == 0
    if variant != "wgmma" or D % 64:
        return False
    s = bwd_num_splits(B, M, T, D)
    sdp_tiles = B * _cdiv(M, SDP_BM) * _cdiv(T, SDP_BN)
    grad_blocks = (B * _cdiv(M, OUT_BM) * _cdiv(D, OUT_BN) * s
                   + _cdiv(2 * B * _cdiv(T, OUT_BM) * _cdiv(D, OUT_BN), s) * s)
    return max(sdp_tiles, grad_blocks) <= _MAX_BLOCKS


def bwd_variant_for(dtype, B, M, T, D, aligned) -> str:
    """The backward kernel a CUDA call goes to: float32 on the CUDA cores;
    a bf16 call the wgmma variant takes (D a multiple of 64, 16-byte
    aligned inputs, its grids within their limits; any T) goes to it, the
    other bf16 calls to mma.sync."""
    if dtype == torch.float32:
        return "float32"
    if bwd_takes("wgmma", dtype, B, M, T, D, aligned):
        return "wgmma"
    return "mma_sync"


def bwd_num_splits(B, M, T, D, sms=132) -> int:
    """Splits of T for each dQ tile of the wgmma backward's gradient
    kernel (the blocks of one thread block cluster): the fewest, at most
    ``GRAD_MAX_SPLITS`` and at most T's 64-deep slabs, that keep a split's
    slabs within the mean slabs a block walks with one block on each of
    the ``sms`` multiprocessors, so that no dQ block outlasts the dK and
    dV blocks beside it; then as few as cover T's slabs at that length
    (no split is empty).  gemma2-2b's and mistral-7b's training shapes
    take 1, granite's 2."""
    nk_t, nk_m = _cdiv(T, 64), _cdiv(M, 64)
    q_tiles = B * _cdiv(M, OUT_BM) * _cdiv(D, OUT_BN)
    kv_tiles = 2 * B * _cdiv(T, OUT_BM) * _cdiv(D, OUT_BN)
    mean = (q_tiles * nk_t + kv_tiles * nk_m) / sms
    s = next((n for n in range(1, GRAD_MAX_SPLITS + 1)
              if _cdiv(nk_t, n) <= mean), GRAD_MAX_SPLITS)
    s = min(s, nk_t)
    return _cdiv(nk_t, _cdiv(nk_t, s))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("memcom_xattn")
    fn = lib.memcom_xattn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.memcom_xattn_workspace_bytes
    ws.argtypes = [ctypes.c_int] * 5
    ws.restype = ctypes.c_longlong
    bwd = lib.memcom_xattn_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    bwd_ws = lib.memcom_xattn_bwd_workspace_bytes
    bwd_ws.argtypes = [ctypes.c_int] * 5
    bwd_ws.restype = ctypes.c_longlong
    return fn, ws, bwd, bwd_ws


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def workspace_bytes(B: int, M: int, T: int, dtype: torch.dtype,
                    variant: str) -> int:
    """Bytes of the workspace one call to kernel ``variant`` allocates: P~
    and the per-tile softmax pieces for ``"wgmma"``, the logits and
    probabilities for ``"mma_sync"`` and ``"float32"``."""
    return int(_kernel()[1](B, M, T, _DTYPES[dtype], _VARIANTS[variant]))


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: want (B,M,D), (B,T,D), (B,T,D)")
    if k.shape[1] == 0:
        raise ValueError("memcom_xattn needs at least one source token")


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


def memcom_xattn(q, k, v, *, scale=None, variant=None, return_lse=False):
    """(B,M,D) x (B,T,D) x (B,T,D) -> (B,M,D) [, lse (B,M) f32], one head
    of width D; lse is each row's logsumexp of the scaled logits (it takes
    no gradient).

    ``variant`` forces ``"wgmma"`` or ``"mma_sync"`` instead of
    :func:`variant_for`'s choice, so that both bf16 kernels can be held to
    the plain version at one shape; a variant that does not take the call
    raises ``NotImplementedError`` (a CPU call too, which then goes to the
    plain version)."""
    if variant is not None:
        if variant not in ("wgmma", "mma_sync"):
            raise ValueError(f"unknown variant {variant!r}")
        _check(q, k, v)
        B, M, D = q.shape
        T = k.shape[1]
        if not takes(variant, q.dtype, B, M, T, D, _aligned(q, k, v)):
            raise NotImplementedError(
                f"the {variant} kernel does not take {q.dtype} q "
                f"{tuple(q.shape)} k {tuple(k.shape)} (aligned: "
                f"{_aligned(q, k, v)}): both take bf16 with 16-byte aligned "
                "inputs, mma_sync D % 8 == 0, wgmma D % 64 == 0 and T <= "
                f"{WGMMA_MAX_T}")
    if not q.is_cuda:
        return plain.memcom_xattn_ref(q, k, v, scale=scale,
                                      return_lse=return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = MemcomXattn.apply(q, k, v, scale, variant)
    else:
        out, lse = _forward(q, k, v, scale, variant)
    return (out, lse) if return_lse else out


class MemcomXattn(torch.autograd.Function):
    """The CUDA forward kernel with the backward kernel as its gradient;
    returns (out, lse), lse without a gradient.

    Both kernels run on the values centred over T, and the backward on the
    keys centred over T (its lse moved to match): exact in exact
    arithmetic, since each row of P sums to 1 (out = P (V - v_mean) +
    v_mean, dV unchanged) and a row's logits all move by scale q_i .
    k_mean, which its lse takes back (P, dS unchanged, and dQ = scale dS
    K too, as each row of dS sums to 0).  In bf16 they keep the rounding
    errors of the centred quantities: the backward forms D_i =
    rowsum(dO o O) from the bf16 O, which against raw values carries the
    rounding of their common part, so that a row of dS sums to an error
    instead of 0, and dQ takes that error times the keys' common part
    (the raw residual stream a source hands memx has a large one:
    whisper-medium's memx gradients landed 2.2e-2 off the plain run's at
    depth 2 on the card without this)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, variant):
        v_mean = v.float().mean(dim=1, keepdim=True)
        vc = (v.float() - v_mean).to(v.dtype)
        out_c, lse = _forward(q, k, vc, scale, variant)
        ctx.save_for_backward(q, k, vc, out_c, lse)
        ctx.mark_non_differentiable(lse)
        ctx.scale = scale
        return (out_c.float() + v_mean).to(v.dtype), lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, vc, out_c, lse = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5 if ctx.scale is None else ctx.scale
        k_mean = k.float().mean(dim=1, keepdim=True)
        kc = (k.float() - k_mean).to(k.dtype)
        lse_c = lse - scale * (q.float() @ k_mean.transpose(1, 2))[..., 0]
        return (*memcom_xattn_bwd(q, kc, vc, out_c, lse_c, dout,
                                  scale=ctx.scale), None, None)


def _forward(q, k, v, scale, variant):
    """Launches the forward kernel ``variant`` (None: :func:`variant_for`'s
    choice) on CUDA tensors; returns out and lse."""
    _check(q, k, v)
    B, M, D = q.shape
    T = k.shape[1]
    aligned = _aligned(q, k, v)
    chosen = variant or variant_for(q.dtype, B, M, T, D, aligned)
    if not takes(chosen, q.dtype, B, M, T, D, aligned):
        if not aligned:
            raise ValueError("q, k and v must be 16-byte aligned")
        if chosen == "mma_sync" and D % 8:
            raise NotImplementedError(
                f"width {D}: the bf16 kernels take D % 8 == 0")
        raise ValueError(f"B={B}, M={M}: the grid takes B <= {_MAX_GRID} "
                         f"and M <= 64 * {_MAX_GRID}")
    return _launch(q, k, v, chosen, scale)[:2]


def _launch(q, k, v, chosen, scale):
    """Launches kernel ``chosen`` on a call it takes; returns the output,
    lse and the workspace."""
    global launches, wgmma_launches
    B, M, D = q.shape
    T = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    nsplit = num_splits(B, M, T, D, _sms(q.device.index or 0)) \
        if chosen == "wgmma" else 1
    out = torch.empty_like(q)
    lse = torch.empty((B, M), dtype=torch.float32, device=q.device)
    ws = torch.empty(_cdiv(workspace_bytes(B, M, T, q.dtype, chosen), 4),
                     dtype=torch.float32, device=q.device)
    fn = _kernel()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), ws.data_ptr(), B, M, T, D, float(scale),
                 _DTYPES[q.dtype], _VARIANTS[chosen], nsplit, stream)
    if err != 0:
        raise RuntimeError(f"memcom_xattn kernel launch failed ({chosen}): "
                           f"cudaError {err}")
    launches += 1
    wgmma_launches += chosen == "wgmma"
    return out, lse, ws


def wgmma_pieces(q, k, v, *, scale=None):
    """One call of the wgmma kernel on the card, with its first pass's
    pieces read back from the workspace (the layout csrc/memcom_xattn.cu
    states): the output, P~ (B, M, nt, ``LG_BN``) in float32 (0 past T)
    and each logits tile's row maximum m_j and sum l_j (B, M, nt).  For
    the card tests and scripts/xattn_times.py, which take these pieces
    through ``plain.memcom_xattn_tiled_out`` and set them against
    ``plain.memcom_xattn_tiled_pieces``."""
    _check(q, k, v)
    B, M, D = q.shape
    T = k.shape[1]
    if not (q.is_cuda and takes("wgmma", q.dtype, B, M, T, D,
                                _aligned(q, k, v))):
        raise NotImplementedError("the wgmma kernel does not take this call")
    out, _, ws = _launch(q, k, v, "wgmma", scale)
    Tp, nt = _cdiv(T, 8) * 8, _cdiv(T, LG_BN)
    raw = ws.view(torch.uint8)
    p = raw[:2 * B * M * Tp].view(torch.bfloat16).view(B, M, Tp)[..., :T]
    p = torch.nn.functional.pad(p.float(), (0, nt * LG_BN - T))
    ml = raw[2 * B * M * Tp:2 * B * M * Tp + 8 * B * nt * M]
    ml = ml.view(torch.float32).view(B, nt, M, 2).transpose(1, 2)
    return out, p.view(B, M, nt, LG_BN), ml[..., 0], ml[..., 1]


def bwd_workspace_bytes(B: int, M: int, T: int, dtype: torch.dtype,
                        variant: str) -> int:
    """Bytes of the workspace one call to backward kernel ``variant``
    allocates: P and dS in bf16 and D_i for ``"wgmma"``; S and dP in
    float32, and P and dS in bf16, for ``"mma_sync"``; S and dP for
    ``"float32"``."""
    return int(_kernel()[3](B, M, T, _DTYPES[dtype], _VARIANTS[variant]))


def memcom_xattn_bwd(q, k, v, out, lse, dout, *, scale=None, variant=None):
    """dq (B,M,D), dk and dv (B,T,D) of :func:`memcom_xattn` given its out
    and lse and the cotangent ``dout``.  A CPU call goes to
    ``plain.memcom_xattn_bwd_ref``; a CUDA call launches the backward
    kernel :func:`bwd_variant_for` picks or raises.  ``variant`` forces
    ``"wgmma"`` or ``"mma_sync"``; a variant that does not take the call
    raises ``NotImplementedError`` (a CPU call too, which then goes to the
    plain version)."""
    _check(q, k, v)
    B, M, D = q.shape
    T = k.shape[1]
    if variant is not None:
        if variant not in ("wgmma", "mma_sync"):
            raise ValueError(f"unknown variant {variant!r}")
        aligned = _aligned(q, k, v, out, dout)
        if not bwd_takes(variant, q.dtype, B, M, T, D, aligned):
            raise NotImplementedError(
                f"the {variant} backward does not take {q.dtype} q "
                f"{tuple(q.shape)} k {tuple(k.shape)} (aligned: {aligned}):"
                " both take bf16 with 16-byte aligned q, k, v, out and dout,"
                " mma_sync D % 8 == 0, wgmma D % 64 == 0")
    if not q.is_cuda:
        return plain.memcom_xattn_bwd_ref(q, k, v, dout, scale=scale)
    out, dout, lse = (t.contiguous() if t.data_ptr() % 16 == 0
                      else t.clone(memory_format=torch.contiguous_format)
                      for t in (out, dout, lse))  # 16-byte rows
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or out.shape != q.shape or out.dtype != q.dtype \
            or lse.shape != (B, M) or lse.dtype != torch.float32:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}, lse be (B, M) float32")
    aligned = _aligned(q, k, v, out, dout)
    chosen = variant or bwd_variant_for(q.dtype, B, M, T, D, aligned)
    if not bwd_takes(chosen, q.dtype, B, M, T, D, aligned):
        raise NotImplementedError(
            f"the bf16 backward takes D % 8 == 0 and 16-byte aligned inputs,"
            f" got D={D}, aligned {aligned}")
    return _bwd_launch(q, k, v, out, lse, dout, chosen, scale)[:3]


def _bwd_launch(q, k, v, out, lse, dout, chosen, scale):
    """Launches backward kernel ``chosen`` on a call it takes; returns dq,
    dk, dv and the workspace."""
    global bwd_launches, bwd_wgmma_launches
    B, M, D = q.shape
    T = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    nsplit = (bwd_num_splits(B, M, T, D, _sms(q.device.index or 0))
              if chosen == "wgmma" else 1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty(_cdiv(bwd_workspace_bytes(B, M, T, q.dtype, chosen), 4),
                     dtype=torch.float32, device=q.device)
    fn = _kernel()[2]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), B, M, T, D,
                 float(scale), _DTYPES[q.dtype], _VARIANTS[chosen], nsplit,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"memcom_xattn backward kernel launch failed "
                           f"({chosen}): cudaError {err}")
    bwd_launches += 1
    bwd_wgmma_launches += chosen == "wgmma"
    return dq, dk, dv, ws


def wgmma_bwd_pieces(q, k, v, out, lse, dout, *, scale=None):
    """One call of the wgmma backward on the card, with what its first two
    kernels leave in the workspace (the layout csrc/memcom_xattn.cu
    states): dq, dk, dv, then P and dS (B, M, Tp) in float32 (bf16 values;
    Tp = T rounded up to 8) and D_i (B, M).  For the card tests and
    scripts/xattn_bwd_times.py, which set P and dS against
    ``plain.memcom_xattn_bwd_tiled``'s."""
    _check(q, k, v)
    B, M, D = q.shape
    T = k.shape[1]
    if not (q.is_cuda and bwd_takes("wgmma", q.dtype, B, M, T, D,
                                    _aligned(q, k, v, out, dout))):
        raise NotImplementedError("the wgmma backward does not take this "
                                  "call")
    dq, dk, dv, ws = _bwd_launch(q, k, v, out.contiguous(),
                                 lse.contiguous(), dout.contiguous(),
                                 "wgmma", scale)
    n = B * M * _cdiv(T, 8) * 8
    raw = ws.view(torch.uint8)
    p, ds = (raw[2 * i * n:2 * (i + 1) * n].view(torch.bfloat16)
             .view(B, M, -1).float() for i in range(2))
    di = raw[4 * n:4 * n + 4 * B * M].view(torch.float32).view(B, M)
    return dq, dk, dv, p, ds, di
