"""Block: sequence mixer (attention, MLA or Mamba2) + dense, MoE or no MLP
(``repro/models/blocks.py``).

``memcom`` (when given) injects the paper's compression cross-attention
between the mixer and MLP residual branches and returns ``omega`` — the
layer's compressed representation O^i handed to the target.  A MoE block
also returns its load-balance loss.  A block with ``mlp == "none"`` (the
mixer-only Mamba2 layers) has no ``norm2``.  A Mamba2 layer's prefix
entry ``{"ssm": state}`` (the hybrid MemCom's handoff of the source's
final SSM state) seeds its recurrence.  A decoder block of an enc-dec
stack (``desc.cross_attn``, Whisper) adds ``norm_x`` and the enc-dec
cross-attention ``xattn_enc`` between the self-attention and the MemCom
cross-attention: to ``encoder_out`` where given, else to the cache's
``ck`` / ``cv`` where it has them, else (neither) the fall-through of
:mod:`repro_torch.models.attention`.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.config import LayerDesc, ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.mamba2 import Mamba
from repro_torch.models.mla import MLA
from repro_torch.models.moe import MoE


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, desc: LayerDesc, *, device, dtype):
        super().__init__()
        if desc.mixer not in ("attn", "mla", "mamba") \
                or desc.mlp not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"block {desc.tag()}: the mixers are attention, MLA and "
                "Mamba2, the MLPs dense, MoE or none")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg, **kw)
        if desc.mixer == "mamba":
            self.mamba = Mamba(cfg, **kw)
        elif desc.mixer == "mla":
            self.attn = MLA(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        if desc.cross_attn:
            self.norm_x = Norm(cfg, **kw)
            self.xattn_enc = Attention(cfg, **kw)
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
                lane_valid=None, encoder_out=None):
        """Returns (h, cache_or_None, aux) with aux {"omega": O^i or None,
        "moe_loss": float32 scalar, None without a MoE layer}.  ``memcom``
        is (MemXAttn module, source hiddens (B, T, D)) for this layer, or
        None (a Mamba2 layer of a hybrid stack has no cross-attention).  A
        Mamba2 layer's cache stays per slot on both layouts (the block
        tables address only attention K/V and MLA latents).
        ``lane_valid`` masks the fused step's ragged lanes in the
        attention and MLA cache writes; a Mamba2 layer cannot honour it
        (its state would advance over the padding lanes), which is why the
        engine keeps the fused step to attention/MLA-only layouts.  The
        cross entries ``ck`` / ``cv`` of a decoder block's cache stay per
        slot on both layouts; the self-attention sees the rest."""
        hn = self.norm1(h)
        if hasattr(self, "mamba"):
            init_state = prefix.get("ssm") if prefix is not None else None
            o = self.mamba(hn, cache=cache, decode=decode,
                           init_state=init_state)
        else:
            # an empty dict: a layer the cache does not cover (the
            # hybrid's one-shot compress keeps only Mamba2 state)
            self_cache = cache
            if cache and "ck" in cache:
                self_cache = {k: t for k, t in cache.items()
                              if k not in ("ck", "cv")}
            o, _ = self.attn(
                hn, positions=positions, mask_offset=mask_offset,
                prefix=prefix, cache=self_cache or None,
                cache_index=cache_index, decode=decode,
                block_tables=block_tables, lane_valid=lane_valid)
        h = h + o
        if hasattr(self, "xattn_enc"):
            cross = None
            if cache and "ck" in cache:
                cross = {"ck": cache["ck"], "cv": cache["cv"]}
            o, cross = self.xattn_enc(self.norm_x(h), positions=positions,
                                      kv_source=encoder_out, cache=cross)
            if cross is not None:  # entries rebound to another frame count
                cache.update(cross)
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
