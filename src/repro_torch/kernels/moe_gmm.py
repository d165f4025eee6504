"""Wrapper of the hand-written Hopper grouped (per-expert) matmul kernels.

``csrc/moe_gmm.cu`` replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py::gmm`` and is held to ``plain.gmm_ref``.  A CPU
tensor goes to the plain version; a CUDA tensor launches a kernel (built
on first use, see :mod:`.build`) or raises — there is no fallback, and no
"small problem" route to a dense product.  The source holds four kernels,
and :func:`variant_for` picks one from the call's shape: ``"wgmma"``
(bf16 on Hopper's wgmma, the 768-row source prefill and the 128-row
Memory-LLM), ``"rows"`` (bf16 with few rows, C <= ``ROWS_MAX_C``:
decode and the prompt prefill; F fills the MMA rows), ``"mma_sync"``
(bf16 calls whose rows are not whole 16-byte copies) and ``"float32"``.
``launches`` counts wrapper calls that launched a kernel;
``wgmma_launches`` and ``rows_launches`` those that went to the two
variants.

The backward (``csrc/moe_gmm.cu``'s ``moe_gmm_bwd``: dX = dY Wᵀ reading W
in place, dW = Xᵀ dY, each a hand-written kernel) is held to
``plain.gmm_bwd_ref``.  :func:`bwd_variant_for` picks its kernel:
``"wgmma"`` (bf16 with whole 16-byte rows: the forward's wgmma tile and
ring with the backward's storage orders), ``"mma_sync"`` (the other bf16
calls) or ``"float32"``.  A CUDA call that autograd records (gradients
enabled, x or w requiring grad) goes through :class:`Gmm`, whose backward
launches it for the inputs that need a gradient; any other CUDA call is
the forward launch alone.  ``bwd_launches`` counts backward calls that
launched, ``bwd_dx_launches`` and ``bwd_dw_launches`` the two products,
``bwd_wgmma_launches`` the backward calls that went to the wgmma variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0
wgmma_launches = 0
rows_launches = 0
bwd_launches = 0
bwd_dx_launches = 0
bwd_dw_launches = 0
bwd_wgmma_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"float32": 0, "mma_sync": 0, "wgmma": 1, "rows": 2}

# The rows kernel's widest call (ROWS_MAX_C in the source), and the widest
# call variant_for sends to it.  Set from the kernels' device times that
# chip_smoke.py measures for every variant on an H100 (PERF.md section 6).
ROWS_MAX_C = 32
_MAX_GRID = 65535


def takes(variant, dtype, E, C, D, F, aligned) -> bool:
    """Whether kernel ``variant`` computes a call of this shape at all;
    ``aligned``: x and w start on 16-byte boundaries."""
    if E > _MAX_GRID or -(-C // 64) > _MAX_GRID:
        return False
    if variant == "float32":
        return dtype == torch.float32
    if dtype != torch.bfloat16:
        return False
    whole_rows = aligned and D % 8 == 0 and F % 8 == 0
    return {"mma_sync": True, "wgmma": whole_rows,
            "rows": whole_rows and C <= ROWS_MAX_C}[variant]


def variant_for(dtype, C, D, F, aligned) -> str:
    """The kernel a CUDA call goes to.  float32 runs on the CUDA cores; a
    bf16 call whose rows of x and w are whole 16-byte copies (D and F
    multiples of 8, 16-byte aligned bases) goes to the rows kernel up to
    C = ``ROWS_MAX_C`` and to the wgmma kernel above; the others go
    to mma.sync, which copies element by element."""
    if dtype == torch.float32:
        return "float32"
    if not (aligned and D % 8 == 0 and F % 8 == 0):
        return "mma_sync"
    return "rows" if C <= ROWS_MAX_C else "wgmma"


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("moe_gmm").moe_gmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forced(variant, x, w):
    """Raise unless kernel ``variant`` takes the call (x, w)."""
    if variant not in ("wgmma", "rows", "mma_sync"):
        raise ValueError(f"unknown variant {variant!r}")
    E, C, D = x.shape
    F = w.shape[-1]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if not takes(variant, x.dtype, E, C, D, F, aligned):
        raise NotImplementedError(
            f"the {variant} kernel does not take {x.dtype} x "
            f"{tuple(x.shape)} w {tuple(w.shape)} (aligned: {aligned}): "
            "wgmma and rows take bf16 with D and F multiples of 8 and "
            f"16-byte aligned x and w, rows C <= {ROWS_MAX_C}")


def gmm(x, w, *, variant=None):
    """(E, C, D) x (E, D, F) -> (E, C, F), one matmul per expert.

    ``variant`` forces ``"wgmma"``, ``"rows"`` or ``"mma_sync"`` instead
    of :func:`variant_for`'s choice, so that every bf16 kernel can be held
    to the plain version at one shape; a variant that does not take the
    call raises ``NotImplementedError`` (a CPU call too, which then goes to
    the plain version).  A CUDA call whose x or w needs a gradient is
    recorded for autograd (:class:`Gmm`); a CPU call is differentiated by
    the plain version's autograd."""
    if variant is not None:
        _forced(variant, x, w)
    if not x.is_cuda:
        return plain.gmm_ref(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return Gmm.apply(x, w, variant)
    return _launch(x, w, variant)


class Gmm(torch.autograd.Function):
    """The CUDA forward kernel with the backward kernels as its gradient:
    dX only where x needs a gradient, dW only where w does."""

    @staticmethod
    def forward(ctx, x, w, variant):
        ctx.save_for_backward(x, w)
        return _launch(x, w, variant)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _bwd_launch(x, w, dy.contiguous(), ctx.needs_input_grad[0],
                             ctx.needs_input_grad[1])
        return dx, dw, None


def _launch(x, w, variant):
    """Check a CUDA call and launch the kernel :func:`variant_for` (or
    ``variant``) picks; returns the output."""
    global launches, wgmma_launches, rows_launches
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
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    chosen = variant or variant_for(x.dtype, C, D, F, aligned)
    if not takes(chosen, x.dtype, E, C, D, F, aligned):
        raise ValueError(f"E={E}, C={C}: the grid takes E <= {_MAX_GRID} and "
                         f"C <= 64 * {_MAX_GRID}")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D,
                        F, _DTYPES[x.dtype], _VARIANTS[chosen], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed ({chosen}): "
                           f"cudaError {err}")
    launches += 1
    wgmma_launches += chosen == "wgmma"
    rows_launches += chosen == "rows"
    return out



@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = build.load("moe_gmm").moe_gmm_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_takes(variant, dtype, E, C, D, F, aligned) -> bool:
    """Whether backward kernel ``variant`` computes a call of this shape at
    all; ``aligned``: x, w and dy start on 16-byte boundaries."""
    if E > _MAX_GRID:
        return False
    if variant == "float32":
        return dtype == torch.float32 and -(-max(C, D) // 64) <= _MAX_GRID
    if dtype != torch.bfloat16:
        return False
    if variant == "mma_sync":
        return -(-max(C, D) // 64) <= _MAX_GRID
    if variant == "wgmma":
        return aligned and D % 8 == 0 and F % 8 == 0
    raise ValueError(f"unknown variant {variant!r}")


def bwd_variant_for(dtype, C, D, F, aligned) -> str:
    """The backward kernel a CUDA call goes to: float32 runs on the CUDA
    cores; a bf16 call whose rows of x, w and dy are whole 16-byte copies
    (D and F multiples of 8, 16-byte aligned bases) goes to the wgmma
    kernel, at every C (its tile covers up to 256 rows, so at granite's
    C = 256 each expert's weights are read once); the other bf16 calls go
    to mma.sync."""
    if dtype == torch.float32:
        return "float32"
    if bwd_takes("wgmma", dtype, 1, C, D, F, aligned):
        return "wgmma"
    return "mma_sync"


def gmm_bwd(x, w, dy, *, need_dx=True, need_dw=True, variant=None):
    """The gradient of :func:`gmm`: (dx = dy wᵀ or None, dw = xᵀ dy or
    None).  A CPU tensor goes to ``plain.gmm_bwd_ref``; a CUDA call
    launches the backward kernels for the products asked for.
    ``variant`` forces ``"wgmma"`` or ``"mma_sync"`` instead of
    :func:`bwd_variant_for`'s choice; a variant that does not take the
    call raises ``NotImplementedError`` (a CPU call too, which then goes
    to the plain version)."""
    if variant is not None:
        if variant not in ("wgmma", "mma_sync"):
            raise ValueError(f"unknown variant {variant!r}")
        E, C, D = x.shape
        F = w.shape[-1]
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
        if not bwd_takes(variant, x.dtype, E, C, D, F, aligned):
            raise NotImplementedError(
                f"the {variant} backward kernel does not take {x.dtype} x "
                f"{tuple(x.shape)} w {tuple(w.shape)} (aligned: {aligned}):"
                " wgmma takes bf16 with D and F multiples of 8 and 16-byte "
                "aligned x, w and dy, mma_sync any bf16 call")
    if not x.is_cuda:
        return plain.gmm_bwd_ref(x, w, dy, need_dx, need_dw)
    return _bwd_launch(x, w, dy.contiguous(), need_dx, need_dw, variant)


def _bwd_launch(x, w, dy, need_dx, need_dw, variant=None):
    """Check a CUDA backward call and launch the products asked for with
    the kernel :func:`bwd_variant_for` (or ``variant``) picks; returns (dx
    or None, dw or None)."""
    global bwd_launches, bwd_dx_launches, bwd_dw_launches, bwd_wgmma_launches
    if not (need_dx or need_dw):
        return None, None
    if w.device != x.device or dy.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, dy on "
                         f"{dy.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"x/w/dy must share one of {list(_DTYPES)}, got "
                        f"{x.dtype}/{w.dtype}/{dy.dtype}")
    E, C, D = x.shape
    F = w.shape[2]
    if w.shape != (E, D, F) or dy.shape != (E, C, F):
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} dy "
                         f"{tuple(dy.shape)}: want (E,C,D), (E,D,F), (E,C,F)")
    for name, t in (("x", x), ("w", w), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
    chosen = variant or bwd_variant_for(x.dtype, C, D, F, aligned)
    if not bwd_takes(chosen, x.dtype, E, C, D, F, aligned):
        raise ValueError(f"E={E}, C={C}, D={D}: the grid takes E <= "
                         f"{_MAX_GRID} and C, D <= 64 * {_MAX_GRID}")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bwd_kernel()(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                            dx.data_ptr() if need_dx else None,
                            dw.data_ptr() if need_dw else None, E, C, D, F,
                            _DTYPES[x.dtype], _VARIANTS[chosen], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm backward kernel launch failed "
                           f"({chosen}): cudaError {err}")
    bwd_launches += 1
    bwd_dx_launches += bool(need_dx)
    bwd_dw_launches += bool(need_dw)
    bwd_wgmma_launches += chosen == "wgmma"
    return dx, dw
