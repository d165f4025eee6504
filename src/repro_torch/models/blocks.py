"""Transformer block: attention + dense or MoE MLP
(``repro/models/blocks.py``).

``memcom`` (when given) injects the paper's compression cross-attention
between the self-attention and MLP residual branches and returns ``omega``
— the layer's compressed representation O^i handed to the target.  A MoE
block also returns its load-balance loss.  MLA, Mamba and enc-dec blocks
are not in the port yet.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.config import LayerDesc, ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.moe import MoE


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, desc: LayerDesc, *, device, dtype):
        super().__init__()
        if desc.mixer != "attn" or desc.mlp not in ("dense", "moe") \
                or desc.cross_attn:
            raise NotImplementedError(
                f"block {desc.tag()}: only attn/dense and attn/moe blocks "
                "are ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg, **kw)
        self.attn = Attention(cfg, **kw)
        self.norm2 = Norm(cfg, **kw)
        if desc.mlp == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)

    def forward(self, h, *, positions, mask_offset=0,
                prefix: Optional[dict] = None, cache: Optional[dict] = None,
                cache_index=None, decode: bool = False,
                memcom: Optional[tuple] = None, block_tables=None):
        """Returns (h, cache_or_None, aux) with aux {"omega": O^i or None,
        "moe_loss": float32 scalar, None for a dense MLP}.  ``memcom`` is
        (MemXAttn module, source hiddens (B, T, D)) for this layer."""
        o, cache = self.attn(
            self.norm1(h), positions=positions, mask_offset=mask_offset,
            prefix=prefix, cache=cache, cache_index=cache_index,
            decode=decode, block_tables=block_tables)
        h = h + o
        omega = None
        if memcom is not None:
            memx, src = memcom
            h = h + memx(h, src)
            omega = h  # O^i — the layer's compressed representation
        hn = self.norm2(h)
        moe_loss = None
        if hasattr(self, "moe"):
            o, moe_loss = self.moe(hn)
        else:
            o = self.mlp(hn)
        return h + o, cache, {"omega": omega, "moe_loss": moe_loss}

