"""The model: embedding → blocks → head (``repro/models/transformer.py``).

One ``forward`` serves all three MemCom stacks:

* Source-LLM — ``capture_hiddens=True`` → per-layer input reps H^i
* Memory-LLM — ``memcom={"params": [MemXAttn...], "src": [H^i...]}`` → O^i
* Target-LLM — ``prefix=[...]`` or a seated ``cache`` → attends to the
  compressed per-layer context

The JAX package stacks the ``period`` layers for ``lax.scan``; here the
stack is a per-layer ``nn.ModuleList`` in layer order, and every
layer-wise quantity (hiddens, O^i, prefixes, caches) is a Python list in
the same order.  :mod:`repro_torch.bridge` converts between the two.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.attention import (init_attn_cache,
                                          init_paged_attn_cache)
from repro_torch.models.blocks import Block
from repro_torch.models.layers import Norm, softcap
from repro_torch.models.mamba2 import init_mamba_cache
from repro_torch.models.param import Init, initialize, make

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig, dtype=None) -> torch.dtype:
    if dtype is not None:
        return dtype
    return DTYPES[cfg.dtype]


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        make(self, "tokens", (cfg.vocab_size, cfg.d_model),
             Init("normal", scale=cfg.d_model ** -0.5), device=device,
             dtype=dtype)


class Transformer(nn.Module):
    """Parameters are declared uninitialised; :func:`init_params` draws
    them from a seed and :mod:`repro_torch.bridge` loads JAX ones."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        cfg.validate()
        if cfg.pos_embed not in ("rope", "none") or cfg.encoder is not None \
                or cfg.mrope_sections:
            raise NotImplementedError(
                f"{cfg.name}: learned positions, encoders and M-RoPE are not "
                "ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = Embed(cfg, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, desc, **kw) for desc in cfg.layout.descriptors())
        self.final_norm = Norm(cfg, **kw)
        if not cfg.tie_embeddings:
            make(self, "lm_head", (cfg.d_model, cfg.vocab_size), **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.tokens.dtype

    def forward(
        self,
        *,
        tokens=None,
        embeds=None,
        positions=None,
        mask_offset=0,
        prefix: Optional[list] = None,  # per-layer compressed context
        cache: Optional[list] = None,  # per-layer cache (updated in place)
        cache_index=None,  # int (static offset) or (B,) tensor (per slot)
        decode: bool = False,
        capture_hiddens: bool = False,
        memcom: Optional[dict] = None,  # {"params": [MemXAttn], "src": [H^i]}
        logits: bool = True,
        block_tables=None,  # (B, nb) int32: the cache is a paged pool
        lane_valid=None,  # (B,) int: the fused step's ragged-lane mask
        remat: bool = False,
    ):
        """Returns (logits_or_hidden, aux) with aux keys "cache",
        "hiddens" (layer inputs H^i), "omega" (Memory-LLM O^i) and
        "moe_loss" (the layers' load-balance losses summed, a float32
        scalar; 0.0 without a MoE layer).  One block table resolves every
        layer's pool; ``lane_valid`` (decode) marks how many of each
        slot's S lanes carry tokens (the others write no cache row).
        ``remat`` (training) wraps each block in
        ``torch.utils.checkpoint`` when a graph is being recorded, as the
        JAX package's ``remat`` does: its activations are recomputed in
        the backward pass (so the kernels' forward counters count such a
        block twice)."""
        cfg = self.cfg
        if embeds is None:
            h = F.embedding(tokens, self.embed.tokens)
        else:
            h = embeds
        B, S = h.shape[0], h.shape[1]
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                                 device=h.device)
        ar = torch.arange(S, dtype=torch.int32, device=h.device)
        if positions is None:
            if decode and torch.is_tensor(cache_index) and cache_index.dim() == 1:
                # continuous batching: each slot decodes at its own length
                positions = cache_index.to(torch.int32)[:, None] + ar[None, :]
            else:
                start = cache_index if (decode and cache_index is not None) \
                    else mask_offset
                positions = (int(start) + ar).expand(B, S)

        hiddens, omegas = [], []
        moe_loss = None
        for i, block in enumerate(self.layers):
            if capture_hiddens:
                hiddens.append(h)
            mem = None
            if memcom is not None:
                mem = (memcom["params"][i], memcom["src"][i])
            kw = dict(positions=positions, mask_offset=mask_offset,
                      prefix=prefix[i] if prefix is not None else None,
                      cache=cache[i] if cache is not None else None,
                      cache_index=cache_index, decode=decode, memcom=mem,
                      block_tables=block_tables, lane_valid=lane_valid)
            if remat and torch.is_grad_enabled():
                h, _, a = checkpoint(block, h, use_reentrant=False, **kw)
            else:
                h, _, a = block(h, **kw)
            if a["moe_loss"] is not None:
                moe_loss = (a["moe_loss"] if moe_loss is None
                            else moe_loss + a["moe_loss"])
            if a["omega"] is not None:
                omegas.append(a["omega"])

        out = self.final_norm(h)
        if logits:
            head = self.embed.tokens.t() if cfg.tie_embeddings else self.lm_head
            out = softcap(out @ head, cfg.final_logit_softcap)
        aux = {
            "cache": cache,
            "hiddens": hiddens if capture_hiddens else None,
            "omega": omegas if memcom is not None else None,
            "moe_loss": 0.0 if moe_loss is None else moe_loss,
        }
        return out, aux


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype=None) -> Transformer:
    """A Transformer with every parameter drawn from ``seed`` (shapes and
    scales of ``repro/models/param.py``), on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device, dtype=torch_dtype(cfg, dtype))
    return initialize(model, seed)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> list:
    """Per-layer dense caches: (batch, max_len, Hkv, hd) K/V stripes for
    attention layers, per-slot conv/ssm state for Mamba2 layers."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg, dtype)
    return [init_mamba_cache(cfg, batch, dtype, device)
            if desc.mixer == "mamba"
            else init_attn_cache(cfg, batch, max_len, dtype, device)
            for desc in cfg.layout.descriptors()]


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=None, device=None) -> list:
    """Block-pool cache: one (num_blocks, block_size, Hkv, hd) K/V pool per
    attention layer, addressed through per-slot block tables; a Mamba2
    layer's conv/ssm state stays per slot (``slots`` rows), a fixed size
    that paging would not shrink."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg, dtype)
    return [init_mamba_cache(cfg, slots, dtype, device)
            if desc.mixer == "mamba"
            else init_paged_attn_cache(cfg, num_blocks, block_size, dtype,
                                       device)
            for desc in cfg.layout.descriptors()]
