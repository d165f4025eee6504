"""MemCom's per-layer compression cross-attention (``repro/models/xattn.py``).

Variants: "1head" (paper default — a single head of width d_model, the
``memcom_xattn`` kernel), "mha" (multi-head) and "mqa" (multi-query), both
through ``ops.attention``.  Q comes from the Memory-LLM's post-self-
attention hidden state (pre-normed), K = V are the Source-LLM's raw
layer-input representations:
``O^i = XAttn(Q=H_mem^i, K=H_src^i, V=H_src^i)``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Norm, apply_norm
from repro_torch.models.param import Init, make


class MemXAttn(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        mc = cfg.memcom
        kw = dict(device=device, dtype=dtype)
        qkv, out = ("embed", "heads"), ("heads", "embed")
        self.norm = Norm(cfg, **kw)
        # paper: randomly initialised (trained in Phase-1); wo small so the
        # initial perturbation of the memory stream is mild
        if mc.xattn_kind == "mqa":
            H = mc.xattn_heads
            hd = d // H
            make(self, "wq", (d, H * hd), Init(scale=0.5), axes=qkv, **kw)
            make(self, "wk", (d, hd), Init(scale=0.5), axes=qkv, **kw)
            make(self, "wv", (d, hd), Init(scale=0.5), axes=qkv, **kw)
            make(self, "wo", (H * hd, d), Init(scale=0.1), axes=out, **kw)
        else:  # "1head" (H=1) or "mha"
            make(self, "wq", (d, d), Init(scale=0.5), axes=qkv, **kw)
            make(self, "wk", (d, d), Init(scale=0.5), axes=qkv, **kw)
            make(self, "wv", (d, d), Init(scale=0.5), axes=qkv, **kw)
            make(self, "wo", (d, d), Init(scale=0.1), axes=out, **kw)

    def forward(self, mem_h, src_h):
        return apply_memcom_xattn(self, self.cfg, mem_h, src_h)


def apply_memcom_xattn(p: MemXAttn, cfg: ModelConfig, mem_h, src_h):
    """mem_h (B, m, D) memory residual; src_h (B, T, D) source layer reps.
    Returns the cross-attention output (B, m, D), to be added residually."""
    mc = cfg.memcom
    q_in = apply_norm(p.norm, cfg, mem_h)
    B, M, D = q_in.shape
    T = src_h.shape[1]

    if mc.xattn_kind == "1head":
        q = q_in @ p.wq
        k = src_h @ p.wk
        v = src_h @ p.wv
        return ops.memcom_xattn(q, k, v) @ p.wo

    H = mc.xattn_heads
    kv_heads = 1 if mc.xattn_kind == "mqa" else H
    hd = D // H
    q = (q_in @ p.wq).reshape(B, M, H, hd)
    k = (src_h @ p.wk).reshape(B, T, kv_heads, hd)
    v = (src_h @ p.wv).reshape(B, T, kv_heads, hd)
    q_pos = torch.zeros((B, M), dtype=torch.int32, device=q.device)
    kv_pos = torch.zeros((B, T), dtype=torch.int32, device=q.device)
    o = ops.attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=False)
    return o.reshape(B, M, D) @ p.wo
