"""MemCom — the paper's contribution (§4), as PyTorch modules
(``repro/core/memcom.py``).

A :class:`MemCom` holds the Source-LLM and the Memory-LLM (both initialised
as copies of the target), the per-layer cross-attention ``memx`` and the
``m`` learnable memory-token embeddings.  :func:`compress` runs the
Source-LLM with per-layer capture, then the Memory-LLM over the memory
tokens with the compression cross-attention, and packages the per-layer
O^i as the prefix the frozen target consumes.

``memcom_loss`` (training) and the chunked ``begin/compress_chunk/finish``
compression are not in this slice of the port.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.param import Init, initialize, make
from repro_torch.models.transformer import Transformer
from repro_torch.models.xattn import MemXAttn


class MemCom(nn.Module):
    """Source-LLM, Memory-LLM, per-layer ``memx`` and ``mem_tokens``; the
    last two are declared uninitialised on the stacks' device."""

    def __init__(self, cfg: ModelConfig, source: Transformer,
                 memory_llm: Transformer):
        super().__init__()
        if cfg.memcom is None:
            raise ValueError(f"{cfg.name}: set ModelConfig.memcom")
        self.cfg = cfg
        kw = dict(device=source.device, dtype=source.dtype)
        self.memx = nn.ModuleList(
            MemXAttn(cfg, **kw) for _ in cfg.layout.descriptors())
        make(self, "mem_tokens", (cfg.memcom.num_memory_tokens, cfg.d_model),
             Init("normal", scale=cfg.d_model ** -0.5), **kw)
        self.source = source
        self.memory_llm = memory_llm


def init_memcom(cfg: ModelConfig, target: Transformer, seed: int = 0) -> MemCom:
    """Source and Memory-LLM are copies of ``target``; ``memx`` and the
    memory tokens are drawn from ``seed``.  Lives on the target's device."""
    mc = MemCom(cfg, copy.deepcopy(target), copy.deepcopy(target))
    return initialize(mc, seed, skip=("source", "memory_llm"))


@torch.no_grad()
def compress(mc: MemCom, cfg: ModelConfig, source_tokens=None, *,
             source_embeds=None):
    """Many-shot tokens (B, T) -> per-layer compressed prefix for the target.

    Returns (prefix, info): ``prefix[i] = {"h": O^i (B, m, D)}``."""
    if source_tokens is not None and not torch.is_tensor(source_tokens):
        source_tokens = torch.as_tensor(source_tokens, dtype=torch.long,
                                        device=mc.mem_tokens.device)
    _, aux_s = mc.source(tokens=source_tokens, embeds=source_embeds,
                         capture_hiddens=True, logits=False)
    src = source_tokens if source_tokens is not None else source_embeds
    B = src.shape[0]
    m = cfg.memcom.num_memory_tokens
    mem_embeds = mc.mem_tokens[None].expand(B, m, cfg.d_model)
    _, aux_m = mc.memory_llm(
        embeds=mem_embeds,
        memcom={"params": list(mc.memx), "src": aux_s["hiddens"]},
        logits=False)
    return build_prefix(cfg, aux_m["omega"]), {"encoder_out": None}


def build_prefix(cfg: ModelConfig, omega: list) -> list:
    """Assemble the target's per-layer compressed context."""
    if len(omega) != cfg.num_layers:
        raise ValueError(f"{len(omega)} O^i for {cfg.num_layers} layers")
    return [{"h": o} for o in omega]
