"""Wrapper of the hand-written Hopper paged decode-attention kernel.

``csrc/paged_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_flash_decode`` and is held to
``plain.paged_decode_attention_ref``.  A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel (built on first use, see
:mod:`.build`) or raises — there is no fallback.  ``launches`` counts
wrapper calls that launched the kernel (a call that splits the table
columns also launches the merge of the partials).
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
    lib = build.load("paged_attention")
    fn = lib.paged_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    splits = lib.paged_decode_splits
    splits.argtypes = [ctypes.c_int] * 7
    splits.restype = ctypes.c_int
    return fn, splits


@functools.lru_cache(maxsize=256)
def _splits(B, S, Hq, Hkv, nb, bs, device_index):
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return _kernel()[1](B, S, Hq, Hkv, nb, bs, sms)


def _check(q, k_pool, v_pool, block_tables, lengths):
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q/k_pool/v_pool must share one of {list(_DTYPES)}, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables/lengths must be int32")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q must be (B, S, Hq, D) and the pools "
                         "(N, block_size, Hkv, D)")
    B, S, Hq, D = q.shape
    N, bs, Hkv, Dv = v_pool.shape
    if k_pool.shape != (N, bs, Hkv, D) or v_pool.shape[:3] != (N, bs, Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
                         "do not match")
    if Dv != D:
        raise NotImplementedError(
            f"Dv={Dv} != D={D}: the CUDA paged kernel needs equal head dims")
    if D not in (64, 128, 256):
        raise NotImplementedError(f"head dim {D}: the paged kernel takes 64, "
                                  "128 or 256")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or lengths.shape != (B,):
        raise ValueError("block_tables must be (B, nb >= 1) and lengths (B,)")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_flash_decode(q, k_pool, v_pool, *, block_tables, lengths,
                       softcap=0.0, scale=None):
    """(B,S,Hq,D) x pools (N,bs,Hkv,D) x tables (B,nb) -> (B,S,Hq,D).

    Slot ``b`` attends causally within its logical positions ``[0,
    lengths[b])``; logical block ``j`` is pool block ``block_tables[b, j]``.
    """
    global launches
    if not q.is_cuda:
        return plain.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables=block_tables, lengths=lengths,
            softcap=softcap, scale=scale)
    _check(q, k_pool, v_pool, block_tables, lengths)
    B, S, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    fn = _kernel()[0]
    nsplit = _splits(B, S, Hq, Hkv, nb, bs, q.device.index
                     if q.device.index is not None
                     else torch.cuda.current_device())
    # split partials: nsplit x (B*S*Hq) rows of D outputs + 1 lse each
    ws = (torch.empty(nsplit * B * S * Hq * (D + 1), dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None, B, S, Hq, Hkv, D,
                 bs, nb, float(scale), float(softcap or 0.0), nsplit,
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
