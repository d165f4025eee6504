"""Wrapper of the hand-written Hopper grouped (per-expert) matmul kernel.

``csrc/moe_gmm.cu`` replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py::gmm`` and is held to ``plain.gmm_ref``.  A CPU
tensor goes to the plain version; a CUDA tensor launches the kernel (built
on first use, see :mod:`.build`) or raises — there is no fallback, and no
"small problem" route to a dense product.  ``launches`` counts wrapper
calls that launched the kernel.
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
    fn = build.load("moe_gmm").moe_gmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gmm(x, w):
    """(E, C, D) x (E, D, F) -> (E, C, F), one matmul per expert."""
    global launches
    if not x.is_cuda:
        return plain.gmm_ref(x, w)
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x/w must share one of {list(_DTYPES)}, got "
                        f"{x.dtype}/{w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}: want "
                         "(E,C,D), (E,D,F)")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    E, C, D = x.shape
    F = w.shape[2]
    if D == 0:
        raise ValueError("gmm needs a contraction width D >= 1")
    if E > 65535 or -(-C // 64) > 65535:
        raise ValueError(f"E={E}, C={C}: the grid takes E <= 65535 and "
                         "C <= 64 * 65535")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D,
                        F, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError {err}")
    launches += 1
    return out
