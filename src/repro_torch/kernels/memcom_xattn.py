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

A CUDA call is differentiable: when q, k or v needs a gradient the
forward runs inside :class:`MemcomXattn` (an ``autograd.Function`` whose
forward is the same kernel call) and its backward launches the
hand-written backward of ``csrc/memcom_xattn.cu`` (:func:`memcom_xattn_bwd`:
five products on the source's own tiled kernels and a softmax row pass,
held to ``plain.memcom_xattn_bwd_ref``).  There is no fallback to the
plain backward.  ``bwd_launches`` counts backward calls.  With no
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


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("memcom_xattn")
    fn = lib.memcom_xattn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.memcom_xattn_workspace_bytes
    ws.argtypes = [ctypes.c_int] * 5
    ws.restype = ctypes.c_longlong
    bwd = lib.memcom_xattn_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    bwd_ws = lib.memcom_xattn_bwd_workspace_bytes
    bwd_ws.argtypes = [ctypes.c_int] * 4
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


def _aligned(q, k, v):
    return all(t.data_ptr() % 16 == 0 for t in (q, k, v))


def memcom_xattn(q, k, v, *, scale=None, variant=None):
    """(B,M,D) x (B,T,D) x (B,T,D) -> (B,M,D), one head of width D.

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
        return plain.memcom_xattn_ref(q, k, v, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return MemcomXattn.apply(q, k, v, scale, variant)
    return _forward(q, k, v, scale, variant)


class MemcomXattn(torch.autograd.Function):
    """The CUDA forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, variant):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale, variant)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*memcom_xattn_bwd(q, k, v, dout, scale=ctx.scale), None,
                None)


def _forward(q, k, v, scale, variant):
    """Launches the forward kernel ``variant`` (None: :func:`variant_for`'s
    choice) on CUDA tensors."""
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
    return _launch(q, k, v, chosen, scale)[0]


def _launch(q, k, v, chosen, scale):
    """Launches kernel ``chosen`` on a call it takes; returns the output
    and the workspace."""
    global launches, wgmma_launches
    B, M, D = q.shape
    T = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    nsplit = num_splits(B, M, T, D, _sms(q.device.index or 0)) \
        if chosen == "wgmma" else 1
    out = torch.empty_like(q)
    ws = torch.empty(_cdiv(workspace_bytes(B, M, T, q.dtype, chosen), 4),
                     dtype=torch.float32, device=q.device)
    fn = _kernel()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), B, M, T, D, float(scale), _DTYPES[q.dtype],
                 _VARIANTS[chosen], nsplit, stream)
    if err != 0:
        raise RuntimeError(f"memcom_xattn kernel launch failed ({chosen}): "
                           f"cudaError {err}")
    launches += 1
    wgmma_launches += chosen == "wgmma"
    return out, ws


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
    out, ws = _launch(q, k, v, "wgmma", scale)
    Tp, nt = _cdiv(T, 8) * 8, _cdiv(T, LG_BN)
    raw = ws.view(torch.uint8)
    p = raw[:2 * B * M * Tp].view(torch.bfloat16).view(B, M, Tp)[..., :T]
    p = torch.nn.functional.pad(p.float(), (0, nt * LG_BN - T))
    ml = raw[2 * B * M * Tp:2 * B * M * Tp + 8 * B * nt * M]
    ml = ml.view(torch.float32).view(B, nt, M, 2).transpose(1, 2)
    return out, p.view(B, M, nt, LG_BN), ml[..., 0], ml[..., 1]


def bwd_workspace_bytes(B: int, M: int, T: int, dtype: torch.dtype) -> int:
    """Bytes of the workspace one backward call allocates: S and dP in
    float32, and P and dS in bf16 for bf16 inputs."""
    return int(_kernel()[3](B, M, T, _DTYPES[dtype]))


def memcom_xattn_bwd(q, k, v, dout, *, scale=None):
    """dq (B,M,D), dk and dv (B,T,D) of :func:`memcom_xattn` given the
    cotangent ``dout``.  A CPU call goes to ``plain.memcom_xattn_bwd_ref``;
    a CUDA call launches the backward kernels (bf16 at D % 8 == 0 with
    16-byte aligned inputs, or float32) or raises."""
    global bwd_launches
    if not q.is_cuda:
        return plain.memcom_xattn_bwd_ref(q, k, v, dout, scale=scale)
    dout = (dout.contiguous() if dout.data_ptr() % 16 == 0
            else dout.clone(memory_format=torch.contiguous_format))
    _check(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    B, M, D = q.shape
    T = k.shape[1]
    if q.dtype == torch.bfloat16 and (D % 8 or not _aligned(q, k, v)):
        raise NotImplementedError(
            f"the bf16 backward takes D % 8 == 0 and 16-byte aligned inputs,"
            f" got D={D}")
    if scale is None:
        scale = D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty(_cdiv(bwd_workspace_bytes(B, M, T, q.dtype), 4),
                     dtype=torch.float32, device=q.device)
    fn = _kernel()[2]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                 B, M, T, D, float(scale), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"memcom_xattn backward kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    return dq, dk, dv
