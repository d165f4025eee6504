"""Transformer block: attention + dense MLP (``repro/models/blocks.py``).

``memcom`` (when given) injects the paper's compression cross-attention
between the self-attention and MLP residual branches and returns ``omega``
— the layer's compressed representation O^i handed to the target.
MLA, Mamba, MoE and enc-dec blocks are not in this slice of the port.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.config import LayerDesc, ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, desc: LayerDesc, *, device, dtype):
        super().__init__()
        if desc.mixer != "attn" or desc.mlp != "dense" or desc.cross_attn:
            raise NotImplementedError(
                f"block {desc.tag()}: only attn/dense blocks are ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg, **kw)
        self.attn = Attention(cfg, **kw)
        self.norm2 = Norm(cfg, **kw)
        self.mlp = MLP(cfg, **kw)

    def forward(self, h, *, positions, mask_offset=0,
                prefix: Optional[dict] = None, cache: Optional[dict] = None,
                cache_index=None, decode: bool = False,
                memcom: Optional[tuple] = None, block_tables=None,
                lane_valid=None):
        """Returns (h, cache_or_None, omega_or_None).  ``memcom`` is
        (MemXAttn module, source hiddens (B, T, D)) for this layer."""
        o, cache = self.attn(
            self.norm1(h), positions=positions, mask_offset=mask_offset,
            prefix=prefix, cache=cache, cache_index=cache_index,
            decode=decode, block_tables=block_tables, lane_valid=lane_valid)
        h = h + o
        omega = None
        if memcom is not None:
            memx, src = memcom
            h = h + memx(h, src)
            omega = h  # O^i — the layer's compressed representation
        h = h + self.mlp(self.norm2(h))
        return h, cache, omega

