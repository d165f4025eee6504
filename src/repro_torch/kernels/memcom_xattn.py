"""Wrapper of the hand-written Hopper MemCom cross-attention kernel.

``csrc/memcom_xattn.cu`` replaces the Pallas TPU kernel
``repro/kernels/memcom_xattn.py::memcom_xattn`` and is held to
``plain.memcom_xattn_ref``.  A CPU tensor goes to the plain version; a CUDA
tensor launches the kernel (built on first use, see :mod:`.build`) or
raises — there is no fallback.  ``launches`` counts wrapper calls that
launched the kernel (one call runs its three passes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("memcom_xattn")
    fn = lib.memcom_xattn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.memcom_xattn_workspace_bytes
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    return fn, ws


def workspace_bytes(B: int, M: int, T: int, dtype: torch.dtype) -> int:
    """Bytes of the logits / probabilities workspace one call allocates."""
    return int(_kernel()[1](B, M, T, _DTYPES[dtype]))


def memcom_xattn(q, k, v, *, scale=None):
    """(B,M,D) x (B,T,D) x (B,T,D) -> (B,M,D), one head of width D."""
    global launches
    if not q.is_cuda:
        return plain.memcom_xattn_ref(q, k, v, scale=scale)
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
    B, M, D = q.shape
    T = k.shape[1]
    if T == 0:
        raise ValueError("memcom_xattn needs at least one source token")
    if q.dtype == torch.bfloat16 and D % 8:
        raise NotImplementedError(f"width {D}: the bf16 kernel takes D % 8 == 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    ws = torch.empty(workspace_bytes(B, M, T, q.dtype) // 4,
                     dtype=torch.float32, device=q.device)
    fn = _kernel()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), B, M, T, D, float(scale), _DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"memcom_xattn kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
