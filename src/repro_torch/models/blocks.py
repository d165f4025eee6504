"""Block: sequence mixer (attention or Mamba2) + dense, MoE or no MLP
(``repro/models/blocks.py``).

``memcom`` (when given) injects the paper's compression cross-attention
between the mixer and MLP residual branches and returns ``omega`` — the
layer's compressed representation O^i handed to the target.  A MoE block
also returns its load-balance loss.  A block with ``mlp == "none"`` (the
mixer-only Mamba2 layers) has no ``norm2``.  MLA, enc-dec blocks and the
hybrid MemCom's SSM-state prefix (``prefix["ssm"]``) are not in the port
yet.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.config import LayerDesc, ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.mamba2 import Mamba
from repro_torch.models.moe import MoE


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, desc: LayerDesc, *, device, dtype):
        super().__init__()
        if desc.mixer not in ("attn", "mamba") \
                or desc.mlp not in ("dense", "moe", "none") or desc.cross_attn:
            raise NotImplementedError(
                f"block {desc.tag()}: only attention and Mamba2 mixers with "
                "a dense, MoE or no MLP are ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg, **kw)
        if desc.mixer == "mamba":
            self.mamba = Mamba(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        if desc.mlp != "none":
            self.norm2 = Norm(cfg, **kw)
        if desc.mlp == "moe":
            self.moe = MoE(cfg, **kw)
        elif desc.mlp == "dense":
            self.mlp = MLP(cfg, **kw)

    def forward(self, h, *, positions, mask_offset=0,
                prefix: Optional[dict] = None, cache: Optional[dict] = None,
                cache_index=None, decode: bool = False,
                memcom: Optional[tuple] = None, block_tables=None,
                lane_valid=None):
        """Returns (h, cache_or_None, aux) with aux {"omega": O^i or None,
        "moe_loss": float32 scalar, None without a MoE layer}.  ``memcom``
        is (MemXAttn module, source hiddens (B, T, D)) for this layer.  A
        Mamba2 layer's cache stays per slot on both layouts (the block
        tables address only attention K/V).  ``lane_valid`` masks the
        fused step's ragged lanes in the attention cache writes; a Mamba2
        layer cannot honour it (its state would advance over the padding
        lanes), which is why the engine keeps the fused step to
        attention-only layouts."""
        hn = self.norm1(h)
        if hasattr(self, "mamba"):
            if prefix is not None and "ssm" in prefix:
                raise NotImplementedError(
                    "the hybrid MemCom SSM-state prefix is not ported yet")
            o = self.mamba(hn, cache=cache, decode=decode)
        else:
            o, cache = self.attn(
                hn, positions=positions, mask_offset=mask_offset,
                prefix=prefix, cache=cache, cache_index=cache_index,
                decode=decode, block_tables=block_tables,
                lane_valid=lane_valid)
        h = h + o
        omega = None
        if memcom is not None:
            memx, src = memcom
            h = h + memx(h, src)
            omega = h  # O^i — the layer's compressed representation
        moe_loss = None
        if hasattr(self, "moe"):
            o, moe_loss = self.moe(self.norm2(h))
            h = h + o
        elif hasattr(self, "mlp"):
            h = h + self.mlp(self.norm2(h))
        return h, cache, {"omega": omega, "moe_loss": moe_loss}
