"""Wrapper of the hand-written Hopper Mamba2 SSD scan kernels.

``csrc/ssd_scan.cu`` replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd`` and is held to ``plain.ssd_ref``.  A CPU
tensor goes to the plain version; a CUDA tensor launches a kernel (built
on first use, see :mod:`.build`) or raises — there is no fallback to the
plain version on the card.  The source holds two variants, and
:func:`variant_for` picks one from the call: ``"chunked"`` (bf16 at P =
64, N = 128 from ``CHUNKED_MIN_S`` tokens: chunk states, a state pass and
chunk outputs, three kernels on tensor cores, chunks of ``CHUNK_Q``
tokens) and ``"sequential"`` (one kernel that walks 32-token chunks in
order on the CUDA cores; float32, shorter calls and the bf16 calls the
chunked variant does not take).  ``launches`` counts wrapper calls that
launched a kernel, ``chunked_launches`` those that went to the chunked
variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0
chunked_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_MAX = 256  # the sequential kernel's largest d_state (shared memory)
# The chunked kernels' instance (P_ and N_ in the source) and their chunk
# length (Q_ in the source), which sizes the scratch.
CHUNKED_P, CHUNKED_N = 64, 128
CHUNK_Q = 128
# The shortest call variant_for sends to the chunked variant: the
# sequential kernel is ahead at 128 tokens and behind at 256 (device times
# of both at 12-3084 tokens, PERF.md section 6).
CHUNKED_MIN_S = 256
_MAX_GRID = 65535


def takes(variant, dtype, P, N, aligned) -> bool:
    """Whether kernel ``variant`` computes a call of this shape at all;
    ``aligned``: x, Bm, Cm and the initial state (if given) start on
    16-byte boundaries."""
    if variant == "sequential":
        return dtype in _DTYPES and N % 4 == 0 and 4 <= N <= N_MAX
    if variant == "chunked":
        return (dtype == torch.bfloat16 and aligned and P == CHUNKED_P
                and N == CHUNKED_N)
    raise ValueError(f"unknown variant {variant!r}")


def variant_for(dtype, S, P, N, aligned) -> str:
    """The kernel a CUDA call goes to: a bf16 call the chunked variant
    takes, of at least ``CHUNKED_MIN_S`` tokens, goes to it (the prefills
    of the main path); float32, the other bf16 shapes and shorter calls go
    to the sequential kernel."""
    if S >= CHUNKED_MIN_S and takes("chunked", dtype, P, N, aligned):
        return "chunked"
    return "sequential"


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _chunked_kernel():
    fn = build.load("ssd_scan").ssd_scan_chunked_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(x, Bm, Cm, init_state):
    """Whether the tensors the chunked kernels read by 16 bytes start on
    16-byte boundaries (init_state only if given)."""
    ts = (x, Bm, Cm) + (() if init_state is None else (init_state,))
    return all(t.data_ptr() % 16 == 0 for t in ts)


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
    if B > _MAX_GRID or H > _MAX_GRID:
        raise ValueError(f"B={B}, H={H}: the grid takes at most "
                         f"{_MAX_GRID} each")


def _forced(variant, x, Bm, Cm, init_state):
    """Raise unless kernel ``variant`` takes the call."""
    P, N = x.shape[-1], Bm.shape[-1]
    aligned = _aligned(x, Bm, Cm, init_state)
    if not takes(variant, x.dtype, P, N, aligned):
        raise NotImplementedError(
            f"the {variant} kernel does not take {x.dtype} x "
            f"{tuple(x.shape)} Bm {tuple(Bm.shape)} (aligned: {aligned}): "
            f"chunked takes bf16 at P = {CHUNKED_P}, N = {CHUNKED_N} with "
            "16-byte aligned x, Bm, Cm and init_state; sequential float32 "
            f"or bf16 with N a multiple of 4 up to {N_MAX}")


def ssd(x, dt, A, Bm, Cm, *, init_state=None, chunk=256, variant=None):
    """Mamba2 SSD scan, the contract of :func:`plain.ssd_ref`: returns (y
    (B,S,H,P) in x's type, final state (B,H,P,N) float32).  ``chunk`` is
    the chunk length of the plain version, which a CPU tensor runs; the
    kernels walk their own (``CHUNK_Q``; the sequential kernel's ``Q``),
    and the function does not depend on it.  ``variant`` forces
    ``"chunked"`` or ``"sequential"`` instead of :func:`variant_for`'s
    choice; a variant that does not take the call raises
    ``NotImplementedError`` (a CPU call too, which then goes to the plain
    version).  The kernels have no backward yet: a CUDA call made with
    gradients enabled where an input requires grad raises
    ``NotImplementedError`` (a CPU call is differentiated by the plain
    version's autograd)."""
    if variant is not None:
        _forced(variant, x, Bm, Cm, init_state)
    if not x.is_cuda:
        return plain.ssd_ref(x, dt, A, Bm, Cm, init_state=init_state,
                             chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        # y and the final state would carry no grad_fn: the inputs would
        # get no gradient and nothing would say so
        raise NotImplementedError(
            "ssd has no backward kernel yet: a CUDA call whose x, dt, A, "
            "Bm, Cm or init_state requires grad would leave them without a "
            "gradient; call it under torch.no_grad() or with inputs that "
            "need none")
    return _launch(x, dt, A, Bm, Cm, init_state, variant)


def _launch(x, dt, A, Bm, Cm, init_state, variant):
    """Check a CUDA call and launch the variant :func:`variant_for` (or
    ``variant``) picks; returns (y, final state)."""
    global launches, chunked_launches
    _check(x, dt, A, Bm, Cm, init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chosen = variant or variant_for(x.dtype, S, P, N,
                                    _aligned(x, Bm, Cm, init_state))
    y = torch.empty_like(x)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    h0 = init_state.data_ptr() if init_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if chosen == "chunked":
            nc = -(-S // CHUNK_Q)
            states = torch.empty((B, nc, H, P, N), dtype=torch.float32,
                                 device=x.device)
            hin = torch.empty((B, nc, H, 2, P, N), dtype=torch.bfloat16,
                              device=x.device)
            decay = torch.empty((B, nc, H), dtype=torch.float32,
                                device=x.device)
            err = _chunked_kernel()(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), h0, y.data_ptr(), hf.data_ptr(),
                states.data_ptr(), hin.data_ptr(), decay.data_ptr(), B, S, H,
                P, G, N, stream)
        else:
            err = _kernel()(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), h0, y.data_ptr(), hf.data_ptr(), B, S, H, P,
                G, N, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed ({chosen}): "
                           f"cudaError {err}")
    launches += 1
    chunked_launches += chosen == "chunked"
    return y, hf
