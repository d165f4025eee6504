"""Wrapper of the hand-written Hopper Mamba2 SSD chunked-scan kernel.

``csrc/ssd_scan.cu`` replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd`` and is held to ``plain.ssd_ref``.  A CPU
tensor goes to the plain version; a CUDA tensor launches the kernel (built
on first use, see :mod:`.build`) or raises — there is no fallback, and no
"short sequence" route to the sequential oracle.  ``launches`` counts
wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_MAX = 256  # the kernel's largest d_state (shared memory)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, Bm, Cm, init_state):
    named = [("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)]
    if init_state is not None:
        named.append(("init_state", init_state))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x/Bm/Cm must share one of {list(_DTYPES)}, got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}")
    for name, t in named[1:3] + named[5:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError("want x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm "
                         "(B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape[:2] != (B, S) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
                         f"{tuple(A.shape)} Bm {tuple(Bm.shape)} Cm "
                         f"{tuple(Cm.shape)} do not match")
    if init_state is not None and init_state.shape != (B, H, P, N):
        raise ValueError(f"init_state {tuple(init_state.shape)}, want "
                         f"{(B, H, P, N)}")
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if min(B, S, P) < 1:
        raise ValueError(f"x {tuple(x.shape)}: the kernel takes B, S, P >= 1")
    if N % 4 or not 4 <= N <= N_MAX:
        raise NotImplementedError(f"d_state N={N}: the kernel takes a "
                                  f"multiple of 4 up to {N_MAX}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: the grid takes at most 65535 each")


def ssd(x, dt, A, Bm, Cm, *, init_state=None, chunk=256):
    """Mamba2 SSD scan, the contract of :func:`plain.ssd_ref`: returns (y
    (B,S,H,P) in x's type, final state (B,H,P,N) float32).  ``chunk`` is
    the chunk length of the plain version, which a CPU tensor runs; the
    kernel walks its own (``csrc/ssd_scan.cu``'s ``Q``), and the function
    does not depend on it."""
    global launches
    if not x.is_cuda:
        return plain.ssd_ref(x, dt, A, Bm, Cm, init_state=init_state,
                             chunk=chunk)
    _check(x, dt, A, Bm, Cm, init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), hf.data_ptr(), B, S, H, P, G, N, _DTYPES[x.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, hf
