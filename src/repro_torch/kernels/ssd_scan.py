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

The backward is held to ``plain.ssd_bwd_ref`` and has two variants,
which :func:`bwd_variant_for` picks as :func:`variant_for` does:
``"chunked"`` (``ssd_scan_chunked_bwd``: bf16 at P = 64, N = 128 from
``CHUNKED_MIN_S`` tokens; the forward's chunk states and state pass
rerun, their mirrors for the state's gradient, then every chunk's
gradients on tensor cores and a fixed-order reduce) and ``"sequential"``
(``ssd_scan_bwd``: the states recomputed in a first walk that keeps each
32-token chunk's entering state, the gradients in a second walk, chunks
last to first, on the CUDA cores; float32, shorter calls and other
shapes).  A CUDA call that autograd records goes through :class:`Ssd`;
its forward keeps :func:`variant_for`'s choice, and any other CUDA call
is the forward launch alone.  ``bwd_launches`` counts backward calls that
launched, ``bwd_chunked_launches`` those that went to the chunked
variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0
chunked_launches = 0
bwd_launches = 0
bwd_chunked_launches = 0

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
BWD_N_MAX = 128  # the backward kernel's largest d_state (N_MAX in bwd::)
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
    version).  A CUDA call where an input needs a gradient is recorded for
    autograd (:class:`Ssd`); a CPU call is differentiated by the plain
    version's autograd."""
    if variant is not None:
        _forced(variant, x, Bm, Cm, init_state)
    if not x.is_cuda:
        return plain.ssd_ref(x, dt, A, Bm, Cm, init_state=init_state,
                             chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        return Ssd.apply(x, dt, A, Bm, Cm, init_state, variant)
    return _launch(x, dt, A, Bm, Cm, init_state, variant)


class Ssd(torch.autograd.Function):
    """The CUDA forward kernels with the backward kernel as their
    gradient.  The forward keeps only the inputs: the backward recomputes
    the states.  An unused y or final state reaches the backward as None
    and counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, variant):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        return _launch(x, dt, A, Bm, Cm, init_state, variant)

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = _bwd_launch(x, dt, A, Bm, Cm, init_state, dy,
                            None if dhf is None else dhf.contiguous(),
                            ctx.needs_input_grad[5])
        return (*grads, None)


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


def bwd_takes(variant, dtype, P, N, aligned) -> bool:
    """Whether backward kernel ``variant`` computes a call of this shape
    at all; ``aligned``: x, Bm, Cm, dy and the initial state and dhf (if
    given) start on 16-byte boundaries."""
    if variant == "sequential":
        return dtype in _DTYPES and N % 4 == 0 and 4 <= N <= BWD_N_MAX
    if variant == "chunked":
        return takes("chunked", dtype, P, N, aligned)
    raise ValueError(f"unknown variant {variant!r}")


def bwd_variant_for(dtype, S, P, N, aligned) -> str:
    """The backward kernel a CUDA call goes to, by :func:`variant_for`'s
    rule: a bf16 call the chunked variant takes, of at least
    ``CHUNKED_MIN_S`` tokens, goes to it (mamba2-370m's training call);
    float32, the other bf16 shapes and shorter calls go to the sequential
    kernel."""
    if S >= CHUNKED_MIN_S and bwd_takes("chunked", dtype, P, N, aligned):
        return "chunked"
    return "sequential"


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.ssd_scan_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 6
    ws.restype = ctypes.c_longlong
    return fn, ws


@functools.lru_cache(maxsize=None)
def _chunked_bwd_kernel():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_chunked_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.ssd_scan_chunked_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    return fn, ws


def bwd_workspace_bytes(B, S, H, P, N, dtype, G=1, variant=None) -> int:
    """Bytes of the workspace of the backward kernel ``variant`` (by
    default :func:`bwd_variant_for`'s choice for aligned inputs), as
    ``csrc/ssd_scan.cu`` lays it out: the sequential kernel's 32-token
    chunks' entering states and its P tiles' partial sums; the chunked
    variant's chunk states, their hi/lo pairs and the state gradient's,
    and the head blocks' float32 dB and dC."""
    variant = variant or bwd_variant_for(dtype, S, P, N, True)
    if variant == "chunked":
        return int(_chunked_bwd_kernel()[1](B, S, H, G))
    return int(_bwd_kernel()[1](B, S, H, P, N, _DTYPES[dtype]))


def _bwd_aligned(x, Bm, Cm, init_state, dy, dhf):
    return _aligned(x, Bm, Cm, init_state) and all(
        t.data_ptr() % 16 == 0 for t in (dy, dhf) if t is not None)


def ssd_bwd(x, dt, A, Bm, Cm, init_state, dy, dhf, *, variant=None):
    """The gradient of :func:`ssd`, the contract of
    :func:`plain.ssd_bwd_ref`: (dx, ddt, dA, dB, dC, dh0 or None).  A CPU
    tensor goes to the plain version; a CUDA call launches the backward
    kernel :func:`bwd_variant_for` picks, or ``variant`` (``"chunked"`` or
    ``"sequential"``); a variant that does not take the call raises
    ``NotImplementedError`` (a CPU call too, which then goes to the plain
    version)."""
    if variant is not None:
        P, N = x.shape[-1], Bm.shape[-1]
        aligned = _bwd_aligned(x, Bm, Cm, init_state, dy, dhf)
        if not bwd_takes(variant, x.dtype, P, N, aligned):
            raise NotImplementedError(
                f"the {variant} backward kernel does not take {x.dtype} x "
                f"{tuple(x.shape)} Bm {tuple(Bm.shape)} (aligned: "
                f"{aligned}): chunked takes bf16 at P = {CHUNKED_P}, N = "
                f"{CHUNKED_N} with 16-byte aligned x, Bm, Cm, dy, "
                "init_state and dhf; sequential float32 or bf16 with N a "
                f"multiple of 4 up to {BWD_N_MAX}")
    if not x.is_cuda:
        return plain.ssd_bwd_ref(x, dt, A, Bm, Cm, init_state, dy, dhf)
    return _bwd_launch(x, dt, A, Bm, Cm, init_state, dy.contiguous(),
                       None if dhf is None else dhf.contiguous(),
                       init_state is not None, variant)


def _bwd_launch(x, dt, A, Bm, Cm, init_state, dy, dhf, need_dh0,
                variant=None):
    """Check a CUDA backward call and launch the kernel
    :func:`bwd_variant_for` (or ``variant``) picks; returns (dx, ddt, dA,
    dB, dC, dh0), dh0 None without an initial state or unless
    ``need_dh0``."""
    global bwd_launches, bwd_chunked_launches
    _check(x, dt, A, Bm, Cm, init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}: want x's shape, "
                         "type and device, contiguous")
    if dhf is not None and (dhf.shape != (B, H, P, N)
                            or dhf.dtype != torch.float32
                            or dhf.device != x.device
                            or not dhf.is_contiguous()):
        raise ValueError(f"dhf {tuple(dhf.shape)} {dhf.dtype}: want float32 "
                         f"{(B, H, P, N)} on x's device, contiguous")
    chosen = variant or bwd_variant_for(
        x.dtype, S, P, N, _bwd_aligned(x, Bm, Cm, init_state, dy, dhf))
    if chosen == "sequential" and N > BWD_N_MAX:
        raise NotImplementedError(f"d_state N={N}: the backward kernel "
                                  f"takes N up to {BWD_N_MAX}")
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    dh0 = (torch.empty_like(init_state)
           if init_state is not None and need_dh0 else None)
    ws = torch.empty(bwd_workspace_bytes(B, S, H, P, N, x.dtype, G, chosen),
                     dtype=torch.uint8, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), ptr(init_state), dy.data_ptr(), ptr(dhf),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(dh0), ws.data_ptr(), B, S, H, P, G, N)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if chosen == "chunked":
            err = _chunked_bwd_kernel()[0](*args, stream)
        else:
            err = _bwd_kernel()[0](*args, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed "
                           f"({chosen}): cudaError {err}")
    bwd_launches += 1
    bwd_chunked_launches += chosen == "chunked"
    return dx, ddt, dA, dB, dC, dh0
