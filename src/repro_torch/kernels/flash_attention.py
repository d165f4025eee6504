"""Wrapper of the hand-written Hopper flash-attention kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and is held to
``plain.attention_ref``.  A CPU tensor goes to the plain version; a CUDA
tensor launches a kernel (built on first use, see :mod:`.build`) or
raises — there is no fallback.  The source holds three variants, and
:func:`variant_for` picks one from the call's shape: ``"wgmma"``
(``flash_fwd_wgmma``, bf16 on Hopper's wgmma), ``"mma_sync"``
(``flash_fwd_tc``, bf16 calls that split the KV axis many ways) and
``"float32"`` (``flash_fwd``).  ``launches`` counts wrapper calls that
launched a kernel (a call that splits the KV axis also launches the
merge of the partials); ``wgmma_launches`` counts those that went to the
wgmma variant.

A CUDA call is differentiable: when q, k or v needs a gradient the
forward runs inside :class:`FlashAttention` (an ``autograd.Function``
whose forward is the same kernel call), which saves q, k, v, out and lse,
and its backward launches the hand-written backward kernel of
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`, held to
``plain.attention_bwd_ref``; an ``lse`` cotangent enters it too).  Its
variants: ``"wgmma"`` (``flash_bwd_wgmma``, bf16 on Hopper's wgmma, one
launch for dK/dV and dQ after the D_i pass; :func:`bwd_plan` states its
block order), ``"mma_sync"`` (bf16, three launches) and ``"float32"``;
:func:`bwd_variant_for` picks one.  There is no fallback to the plain
backward: a backward kernel that does not build or launch raises.
``bwd_launches`` counts backward calls, ``bwd_wgmma_launches`` those that
went to the wgmma variant.  With no gradient needed the call is the
plain kernel call, as before.
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

WGMMA_HEAD_DIMS = (64, 128, 256)
WGMMA_MAX_SKV = 1024 * 64    # the kernel's table: 1024 tiles of 64 kv rows
# Most KV splits for which the wgmma variant still takes a call.  The
# split count says how far the (query, head) rows alone fall short of
# filling the card; where the mma.sync variant would cut the KV walk into
# more pieces, its split beats the wgmma variant's serial walk.  Set from
# the kernels' device times that chip_smoke.py measures for both variants
# on an H100 (PERF.md section 6): at every measured call of 1-4 splits the
# wgmma variant is faster or within 0.5 us; at every call of 8 or more it
# is slower or within 2 us.
WGMMA_MAX_SPLITS = 4


def wgmma_takes(dtype, head_dim, skv) -> bool:
    """Whether ``flash_fwd_wgmma`` computes a call of this kind at all."""
    return (dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
            and skv <= WGMMA_MAX_SKV)


def variant_for(dtype, head_dim, skv, nsplit) -> str:
    """The kernel a CUDA call goes to: ``nsplit`` is the KV split count
    the mma.sync variant would take (``flash_attention_splits`` in the
    source).  bf16 calls the wgmma variant takes go to it unless they
    split into more than ``WGMMA_MAX_SPLITS`` (decode and a short prompt
    against a long prefix: few rows over a long walk), which stay on
    mma.sync; float32 runs on the CUDA cores."""
    if dtype == torch.float32:
        return "float32"
    if wgmma_takes(dtype, head_dim, skv) and nsplit <= WGMMA_MAX_SPLITS:
        return "wgmma"
    return "mma_sync"


def tile_class(kv_pos_tile, q_pos_rows, causal) -> str:
    """The kernels' verdict on one KV tile against one block's rows
    (``tile_class`` in ``csrc/tile_class.cuh``): ``kv_pos_tile`` the
    tile's kv positions (negative: a hole, as are rows past the end),
    ``q_pos_rows`` the q positions of the block's rows that exist.
    ``"skipped"``: no pair is visible; ``"mask_free"``: every pair is;
    ``"masked"``: each pair is tested."""
    valid = [int(p) for p in kv_pos_tile if p >= 0]
    holes = len(kv_pos_tile) - len(valid)
    q_lo, q_hi = min(q_pos_rows), max(q_pos_rows)
    if not valid or (causal and min(valid) > q_hi):
        return "skipped"
    if holes == 0 and (not causal or max(valid) <= q_lo):
        return "mask_free"
    return "masked"


BWD_TILE = 64             # rows of every tile of the wgmma backward
BWD_WGMMA_MAX_TILES = 1024  # its table: 1024 tiles of each side
BWD_KV_COST = 4           # products a KV block runs per tile (S, dP, dV, dK)
BWD_Q_COST = 3            # ... and a Q block (S, dP, dQ)
BWD_BLOCKS_PER_SM = {64: 3, 128: 2, 256: 1}  # resident blocks of each width
# split KV walks when the heaviest weighs more than 3/2 of a block slot's
# mean load
BWD_SPLIT_NUM, BWD_SPLIT_DEN = 3, 2


def bwd_wgmma_takes(dtype, head_dim, q_rows, skv) -> bool:
    """Whether ``flash_bwd_wgmma`` computes a backward call at all:
    ``q_rows`` the folded query rows Sq * Hq / Hkv."""
    return (dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
            and -(-q_rows // BWD_TILE) <= BWD_WGMMA_MAX_TILES
            and -(-skv // BWD_TILE) <= BWD_WGMMA_MAX_TILES)


def bwd_variant_for(dtype, head_dim, q_rows, skv) -> str:
    """The backward kernel a CUDA call goes to: every bf16 call the wgmma
    variant takes (it is faster by CUDA-graph device time at every bf16
    shape chip_smoke.py times on an H100, PERF.md section 6), the
    mma.sync variant for the rest; float32 on the CUDA cores."""
    if dtype == torch.float32:
        return "float32"
    if bwd_wgmma_takes(dtype, head_dim, q_rows, skv):
        return "wgmma"
    return "mma_sync"


class _BwdShape:
    """The shape model of ``BwPlan`` (``csrc/flash_attention_bwd.cu``):
    query s at position s + Skv - Sq, kv row j at j, 64-row tiles of the
    G-folded query rows and of the kv rows."""

    def __init__(self, Sq, Skv, Hq, Hkv, causal):
        self.G = Hq // Hkv
        self.rows, T = Sq * self.G, BWD_TILE
        self.nq, self.nkv = -(-self.rows // T), -(-Skv // T)
        self.off, self.causal = Skv - Sq, causal

    def first_u(self, x):
        """The first query tile whose last position reaches x (nq: none)."""
        need = self.G * (x - self.off)
        if need > self.rows - 1:
            return self.nq
        a = need - (BWD_TILE - 1)
        return 0 if a <= 0 else -(-a // BWD_TILE)

    def vis_kv(self, t):  # query tiles KV tile t sees
        return self.nq - self.first_u(BWD_TILE * t) if self.causal else self.nq

    def vis_q(self, u):  # KV tiles query tile u sees
        if not self.causal:
            return self.nkv
        p = min(BWD_TILE * u + BWD_TILE - 1, self.rows - 1) // self.G + self.off
        return 0 if p < 0 else min(self.nkv, p // BWD_TILE + 1)

    def q_above(self, w):  # query tiles heavier than w
        v = w // BWD_Q_COST
        if v + 1 > self.nkv:
            return 0
        return self.nq - self.first_u(BWD_TILE * v) if self.causal else self.nq


def bwd_split(B, Sq, Skv, Hq, Hkv, head_dim, causal, sms, with_dq=True):
    """The blocks a KV tile's walk over the query tiles is split between
    (``bw_plan``): two (each sums half; the second to finish adds the
    other's float32 half and stores the tile) where the heaviest KV block
    weighs more than 3/2 of a block slot's mean load (``sms`` times the
    resident blocks of the width), else one."""
    sh = _BwdShape(Sq, Skv, Hq, Hkv, causal)
    total = sum(BWD_KV_COST * sh.vis_kv(t) for t in range(sh.nkv))
    if with_dq:
        total += sum(BWD_Q_COST * sh.vis_q(u) for u in range(sh.nq))
    heavy = BWD_KV_COST * sh.vis_kv(0)
    slots = sms * BWD_BLOCKS_PER_SM[head_dim]
    return 2 if sh.nq >= 2 and (BWD_SPLIT_DEN * heavy * slots
                                > BWD_SPLIT_NUM * total * Hkv * B) else 1


def bwd_plan(Sq, Skv, Hq, Hkv, causal, split, with_dq=True):
    """The slots of ``flash_bwd_wgmma``'s grid in launch order (``BwPlan``
    in ``csrc/flash_attention_bwd.cu``, restated) for a given ``split``:
    ``("kv", t, p)`` is part p of KV tile t's walk (64 kv rows: dK, dV;
    with two parts, part 0 the query tiles below ``bwd_mid``, part 1 the
    rest), ``("q", u, 0)`` the block of tile u of the G-folded query rows
    (dQ); each slot is one block per KV head and batch, KV heads first.
    Heaviest first: a KV part weighs ``BWD_KV_COST`` times its share (the
    larger) of the query tiles its KV tile sees, a query block
    ``BWD_Q_COST`` times the KV tiles it sees, as ``_BwdShape`` counts them
    (every tile visible without ``causal``); equal weights put KV blocks
    first, KV tiles ascending, query tiles descending.  The kernel finds
    its slot by the same arithmetic (binary searches over the two monotone
    weight lists)."""
    sh = _BwdShape(Sq, Skv, Hq, Hkv, causal)
    nq, nkv = sh.nq, sh.nkv
    if not with_dq:
        return [("kv", t, p) for t in range(nkv) for p in range(split)]

    def kv_slot(k):  # KV block k: part k % split of KV tile k // split
        return k + sh.q_above(BWD_KV_COST * -(-sh.vis_kv(k // split) // split))

    slots = []
    for i in range(nkv * split + nq):
        lo, hi = 0, nkv * split
        while lo < hi:
            m = (lo + hi) // 2
            lo, hi = (m + 1, hi) if kv_slot(m) <= i else (lo, m)
        if lo > 0 and kv_slot(lo - 1) == i:
            slots.append(("kv", (lo - 1) // split, (lo - 1) % split))
        else:
            slots.append(("q", nq - 1 - (i - lo), 0))
    return slots


def bwd_mid(Sq, Skv, Hq, Hkv, causal, t) -> int:
    """The first query tile of part 1 of KV tile t's walk: part 0 takes
    the larger half of the tiles it sees (``BwPlan::mid``)."""
    sh = _BwdShape(Sq, Skv, Hq, Hkv, causal)
    return sh.nq - sh.vis_kv(t) // 2


def bwd_split_at(B, Sq, Skv, Hq, Hkv, head_dim, causal, sms):
    """Per KV tile, the first query tile of the second half of its walk
    (``plain.attention_bwd_tiled``'s ``split_at``), or None unsplit."""
    if bwd_split(B, Sq, Skv, Hq, Hkv, head_dim, causal, sms) == 1:
        return None
    return [bwd_mid(Sq, Skv, Hq, Hkv, causal, t)
            for t in range(-(-Skv // BWD_TILE))]


def bwd_launch_plan(B, Sq, Skv, Hq, Hkv, causal, split, with_dq=True):
    """``flash_bwd_wgmma``'s blocks in grid order: (kind, tile, part, KV
    head, batch) for block index i = slot * Hkv * B + b * Hkv + hk."""
    return [(kind, t, p, hk, b)
            for kind, t, p in bwd_plan(Sq, Skv, Hq, Hkv, causal, split,
                                       with_dq)
            for b in range(B) for hk in range(Hkv)]


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    splits = lib.flash_attention_splits
    splits.argtypes = [ctypes.c_int] * 6
    splits.restype = ctypes.c_int
    wg = lib.flash_attention_fwd_wgmma
    wg.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    wg.restype = ctypes.c_int
    return fn, splits, wg


@functools.lru_cache(maxsize=256)
def _splits(B, Sq, Skv, Hq, Hkv, device_index):
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return _kernel()[1](B, Sq, Skv, Hq, Hkv, sms)


def _check(q, k, v, q_pos, kv_pos):
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("q_pos/kv_pos must be int32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q/k/v must be (B, S, H, D)")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    if k.shape != (B, Skv, Hkv, D) or v.shape[:3] != (B, Skv, Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if Dv != D:
        raise NotImplementedError(
            f"Dv={Dv} != D={D}: the CUDA flash kernel needs equal head dims")
    if q.dtype == torch.bfloat16 and D not in (64, 128, 256):
        raise NotImplementedError(f"head dim {D}: the bf16 kernel takes 64, "
                                  "128 or 256")
    if D % 4 or D > 256:
        raise NotImplementedError(f"head dim {D}: the float32 kernel takes "
                                  "D % 4 == 0, D <= 256")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Skv):
        raise ValueError("q_pos must be (B, Sq) and kv_pos (B, Skv)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, softcap=0.0,
                    scale=None, return_lse=False, variant=None):
    """(B,Sq,Hq,D) x (B,Skv,Hkv,D) -> (B,Sq,Hq,D) [, lse (B,Sq,Hq) f32].

    ``variant`` (CUDA tensors only) forces ``"wgmma"`` or ``"mma_sync"``
    instead of :func:`variant_for`'s choice, so that both bf16 kernels can
    be held to the plain version at one shape; a variant that does not
    take the call raises ``NotImplementedError``.  ``"unsplit"`` keeps
    :func:`variant_for`'s choice at one KV split: each query row walks
    its keys in one pass and in order, as it does in a call over the
    whole sequence, so that a chunk of a chunked compress gives the rows
    of the one-shot call bit for bit.  A CUDA call whose q, k or v needs a
    gradient is recorded for autograd (:class:`FlashAttention`)."""
    if not q.is_cuda:
        return plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                   causal=causal, softcap=softcap,
                                   scale=scale, return_lse=return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, q_pos, kv_pos, causal,
                                        softcap, scale, variant)
    else:
        out, lse = _forward(q, k, v, q_pos, kv_pos, causal, softcap, scale,
                            variant)
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """The CUDA forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, softcap, scale,
                variant):
        out, lse = _forward(q, k, v, q_pos, kv_pos, causal, softcap, scale,
                            variant)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.opts = dict(causal=causal, softcap=softcap, scale=scale)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, dlse, q_pos=q_pos, kv_pos=kv_pos,
            need_dq=ctx.needs_input_grad[0], **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def _forward(q, k, v, q_pos, kv_pos, causal, softcap, scale, variant):
    """Launches the forward kernel on CUDA tensors; returns (out, lse)."""
    global launches, wgmma_launches
    _check(q, k, v, q_pos, kv_pos)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    fn, _, fn_wgmma = _kernel()
    nsplit = _splits(B, Sq, Skv, Hq, Hkv, q.device.index
                     if q.device.index is not None
                     else torch.cuda.current_device())
    if variant == "unsplit":
        nsplit, variant = 1, None
    chosen = variant_for(q.dtype, D, Skv, nsplit)
    if variant is not None:
        if variant not in ("wgmma", "mma_sync"):
            raise ValueError(f"unknown variant {variant!r}")
        if variant == "wgmma" and not wgmma_takes(q.dtype, D, Skv):
            raise NotImplementedError(
                f"the wgmma variant takes bf16 at head dims "
                f"{WGMMA_HEAD_DIMS} and Skv <= {WGMMA_MAX_SKV}, got "
                f"{q.dtype}, D={D}, Skv={Skv}")
        if variant == "mma_sync" and q.dtype != torch.bfloat16:
            raise NotImplementedError("the mma.sync variant takes bf16")
        chosen = variant
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chosen == "wgmma":
            err = fn_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           q_pos.data_ptr(), kv_pos.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), B, Sq, Skv, Hq,
                           Hkv, D, float(scale), float(softcap or 0.0),
                           int(bool(causal)), stream)
        else:
            # split partials: nsplit x (B*Sq*Hq) rows of D outputs + 1 lse
            ws = (torch.empty(nsplit * B * Sq * Hq * (D + 1),
                              dtype=torch.float32, device=q.device)
                  if nsplit > 1 else None)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), ws.data_ptr() if ws is not None else None,
                     B, Sq, Skv, Hq, Hkv, D, float(scale),
                     float(softcap or 0.0), int(bool(causal)), nsplit,
                     _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({chosen}): cudaError {err}")
    launches += 1
    if chosen == "wgmma":
        wgmma_launches += 1
    return out, lse


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    wg = lib.flash_attention_bwd_wgmma
    wg.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    wg.restype = ctypes.c_int
    ws = lib.flash_attention_bwd_wgmma_workspace
    ws.argtypes = [ctypes.c_int] * 9
    ws.restype = ctypes.c_longlong
    return fn, wg, ws


@functools.lru_cache(maxsize=None)
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def bwd_kernel_slots(B, Sq, Skv, Hq, Hkv, head_dim, causal, sms,
                     with_dq=True):
    """``flash_bwd_wgmma``'s slot order as the built library computes it
    (``flash_bwd_wgmma_slots``, the host's copy of the kernel's plan) on a
    card of ``sms`` SMs, in :func:`bwd_plan`'s form; the card tests hold it
    to :func:`bwd_plan` at :func:`bwd_split`'s split."""
    fn = build.load("flash_attention_bwd").flash_bwd_wgmma_slots
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 2 * -(-Skv // BWD_TILE) + -(-Sq * (Hq // Hkv) // BWD_TILE)
    buf = (ctypes.c_int * (3 * n))()
    got = fn(B, Sq, Skv, Hq, Hkv, head_dim, int(bool(causal)),
             int(bool(with_dq)), sms, buf)
    return [("kv" if buf[3 * i] else "q", buf[3 * i + 1], buf[3 * i + 2])
            for i in range(got)]


def flash_attention_bwd(q, k, v, out, lse, dout, dlse=None, *, q_pos, kv_pos,
                        causal=True, softcap=0.0, scale=None, need_dq=True,
                        variant=None):
    """dq, dk, dv of :func:`flash_attention` given its out and lse and the
    cotangents dout (and dlse, or None).  A CPU call goes to
    ``plain.attention_bwd_ref``; a CUDA call launches the backward kernel
    :func:`bwd_variant_for` picks (dq is None when not ``need_dq``) or
    raises.  ``variant`` (CUDA tensors only) forces ``"wgmma"`` or
    ``"mma_sync"``; a variant that does not take the call raises
    ``NotImplementedError``."""
    global bwd_launches, bwd_wgmma_launches
    if not q.is_cuda:
        return plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse,
                                       q_pos=q_pos, kv_pos=kv_pos,
                                       causal=causal, softcap=softcap,
                                       scale=scale)
    _check(q, k, v, q_pos, kv_pos)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    out, dout, lse = (t.contiguous() if t.data_ptr() % 16 == 0
                      else t.clone(memory_format=torch.contiguous_format)
                      for t in (out, dout, lse))  # 16-byte rows for the kernel
    if dout.shape != q.shape or dout.dtype != q.dtype or out.shape != q.shape \
            or out.dtype != q.dtype or lse.shape != (B, Sq, Hq) \
            or lse.dtype != torch.float32:
        raise ValueError("out/dout must match q and lse be (B, Sq, Hq) "
                         "float32")
    if dlse is not None:
        dlse = dlse.to(torch.float32).contiguous()
    q_rows = Sq * (Hq // Hkv)
    chosen = bwd_variant_for(q.dtype, D, q_rows, Skv)
    if variant is not None:
        if variant not in ("wgmma", "mma_sync"):
            raise ValueError(f"unknown variant {variant!r}")
        if variant == "wgmma" and not bwd_wgmma_takes(q.dtype, D, q_rows,
                                                      Skv):
            raise NotImplementedError(
                f"the wgmma backward takes bf16 at head dims "
                f"{WGMMA_HEAD_DIMS} and at most {BWD_WGMMA_MAX_TILES} tiles "
                f"of {BWD_TILE} rows a side, got {q.dtype}, D={D}, "
                f"{q_rows} query rows, Skv={Skv}")
        if variant == "mma_sync" and q.dtype != torch.bfloat16:
            raise NotImplementedError("the mma.sync variant takes bf16")
        chosen = variant
    # every kernel writes every row of its gradients: no zero fill
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    di = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    fn, fn_wgmma, fn_ws = _bwd_kernel()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            dlse.data_ptr() if dlse is not None else None,
            q_pos.data_ptr(), kv_pos.data_ptr(),
            dq.data_ptr() if dq is not None else None, dk.data_ptr(),
            dv.data_ptr(), di.data_ptr())
    rest = (B, Sq, Skv, Hq, Hkv, D, float(scale), float(softcap or 0.0),
            int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chosen == "wgmma":
            # the split KV tiles' float32 halves and their counters
            sms = _sms(q.device.index if q.device.index is not None
                       else torch.cuda.current_device())
            ws = torch.empty(fn_ws(B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
                                   int(bool(need_dq)), sms),
                             dtype=torch.uint8, device=q.device)
            err = fn_wgmma(*ptrs, ws.data_ptr(), *rest, sms, stream)
        else:
            err = fn(*ptrs, *rest, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"({chosen}): cudaError {err}")
    bwd_launches += 1
    if chosen == "wgmma":
        bwd_wgmma_launches += 1
    return dq, dk, dv


def wgmma_tile_check(a, b, *, b_mn_major, n=64, a_mn_major=False):
    """One 64 x ``n`` x 64 bf16 product through ``csrc/wgmma_sm90.cuh``'s
    helpers on the card, f32 result: ``a`` (M, K) read K-major, or
    (``a_mn_major``) ``a`` (K, M) read MN-major, giving a^T b; ``b`` (N, K)
    read K-major or (``b_mn_major``) ``b`` (K, N) read MN-major.  ``n`` =
    64: A from shared memory with K-major ``b``, from registers with
    MN-major ``b`` — the two forms the flash kernel uses.  ``n`` = 96, 128
    or 256: A from shared memory, ``b`` MN-major (the gmm and memcom_xattn
    output kernels; not at 96) or K-major (the memcom_xattn logits and
    backward S / dP kernels); A MN-major with ``b`` MN-major at 128 and
    256 (the memcom_xattn backward's dK and dV).  A check of the helpers,
    held to ``torch.matmul`` by the ``cuda`` tests."""
    b_shape = (64, n) if b_mn_major else (n, 64)
    if not (a.is_cuda and b.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and a.shape == (64, 64) and b.shape == b_shape
            and n in (64, 96, 128, 256) and not (n == 96 and b_mn_major)
            and not (a_mn_major and (n < 128 or not b_mn_major))
            and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a must be (64, 64) and b (64, n) MN-major or (n, "
                         "64) K-major, contiguous bf16 on the card; n = 64, "
                         "96 (b K-major), 128 or 256; a MN-major with b "
                         "MN-major at n = 128 or 256")
    lib = build.load("flash_attention")
    fn = lib.flash_wgmma_tile_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, int(b_mn_major),
                 int(a_mn_major), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma tile check launch failed: cudaError {err}")
    return c
