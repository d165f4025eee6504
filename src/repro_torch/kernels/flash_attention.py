"""Wrapper of the hand-written Hopper flash-attention kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and is held to
``plain.attention_ref``.  A CPU tensor goes to the plain version; a CUDA
tensor launches the kernel (built on first use, see :mod:`.build`) or
raises — there is no fallback.  ``launches`` counts wrapper calls that
launched the kernel (a call that splits the KV axis also launches the
merge of the partials).
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
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    splits = lib.flash_attention_splits
    splits.argtypes = [ctypes.c_int] * 6
    splits.restype = ctypes.c_int
    return fn, splits


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
                    scale=None, return_lse=False):
    """(B,Sq,Hq,D) x (B,Skv,Hkv,D) -> (B,Sq,Hq,D) [, lse (B,Sq,Hq) f32]."""
    global launches
    if not q.is_cuda:
        return plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                   causal=causal, softcap=softcap,
                                   scale=scale, return_lse=return_lse)
    _check(q, k, v, q_pos, kv_pos)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    fn = _kernel()[0]
    nsplit = _splits(B, Sq, Skv, Hq, Hkv, q.device.index
                     if q.device.index is not None
                     else torch.cuda.current_device())
    # split partials: nsplit x (B*Sq*Hq) rows of D outputs + 1 lse each
    ws = (torch.empty(nsplit * B * Sq * Hq * (D + 1), dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 ws.data_ptr() if ws is not None else None, B, Sq, Skv, Hq,
                 Hkv, D, float(scale), float(softcap or 0.0),
                 int(bool(causal)), nsplit, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out
