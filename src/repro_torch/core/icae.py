"""ICAE / ICAE+ / ICAE++ baselines (``repro/core/icae.py``; paper §5.1,
Fig. 3, Table 4).

One compressor LLM (a copy of the target): the source sequence is appended
with m learnable memory embeddings, one full forward pass is taken, and the
final-layer memory outputs become m soft tokens *prepended to the target's
input* — coarse final-layer compression, against which MemCom's layer-wise
compression is compared.

Variants (increasing compressor capacity):
  icae    — LoRA(r=32) on W_q, W_k            (original paper setup)
  icae+   — LoRA(r=32) on W_q, W_k, W_v, W_o
  icae++  — full attention modules trainable

Trained with next-token loss only, as MemCom is.  An :class:`ICAE` holds
the compressor (its own copy of the target's tensors), the adapters, the
memory embeddings and the variant; the compressor runs on its LoRA-merged
weights through ``Transformer.forward(params=...)``, which under ``remat``
recomputes each block on the same merged tensors.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.core.lora import LoRA, init_lora, merge_lora
from repro_torch.core.memcom import next_token_loss
from repro_torch.models.param import Init, initialize, make
from repro_torch.models.transformer import Transformer, torch_dtype

VARIANTS = {
    "icae": ("wq", "wk"),
    "icae+": ("wq", "wk", "wv", "wo"),
    "icae++": (),  # full attention trainable, no LoRA
}


class ICAE(nn.Module):
    """``compressor`` (a Transformer), ``lora`` (empty for icae++),
    ``mem_embed`` (m, d_model) in the config's type, and the variant (the
    JAX tree cannot hold it; here it stays on the module)."""

    def __init__(self, cfg: ModelConfig, compressor: Transformer, lora: LoRA,
                 variant: str):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown ICAE variant {variant!r}; choose from "
                             f"{tuple(VARIANTS)}")
        if cfg.memcom is None:
            raise ValueError(f"{cfg.name}: the memcom config carries "
                             "num_memory_tokens")
        self.cfg = cfg
        self.variant = variant
        self.compressor = compressor
        self.lora = lora
        make(self, "mem_embed", (cfg.memcom.num_memory_tokens, cfg.d_model),
             Init("normal", scale=cfg.d_model ** -0.5),
             device=compressor.device, dtype=torch_dtype(cfg))


def init_icae(cfg: ModelConfig, target: Transformer, variant: str = "icae++",
              seed: int = 0) -> ICAE:
    """The compressor is a copy of ``target`` (storage of its own); the
    adapters (rank 32 on the variant's targets) and ``mem_embed`` are drawn
    from ``seed``.  Lives on the target's device."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown ICAE variant {variant!r}")
    compressor = copy.deepcopy(target)
    lora = init_lora(compressor, VARIANTS[variant], rank=32, seed=seed)
    ic = ICAE(cfg, compressor, lora, variant)
    return initialize(ic, seed, skip=("compressor", "lora"))


def icae_compress(ic: ICAE, cfg: ModelConfig, source_tokens, *,
                  remat: bool = False):
    """(B, T) source tokens -> (B, m, D) soft memory tokens: the compressor,
    on its merged weights, over [source embeddings ; mem_embed] (raw
    embeddings: a model that scales its inputs scales both)."""
    comp = ic.compressor
    B, T = source_tokens.shape
    m = cfg.memcom.num_memory_tokens
    src_emb = F.embedding(source_tokens.long(), comp.embed.tokens)
    mem_emb = ic.mem_embed[None].expand(B, m, cfg.d_model).to(src_emb.dtype)
    embeds = torch.cat([src_emb, mem_emb], dim=1)
    merged = merge_lora(comp, ic.lora) if ic.lora.adapters() else None
    hidden, _ = comp(embeds=embeds, logits=False, remat=remat, params=merged)
    return hidden[:, T:, :]


def icae_loss(ic: ICAE, target: Transformer, cfg: ModelConfig, batch, *,
              remat: bool = False):
    """Soft memory prepended to the target's input; CE on the target tokens
    (``logits[:, m:]``), plus the target's MoE load-balance loss.

    batch: {"source": (B,T), "target": (B,S), "target_mask": (B,S)}
    tensors.  Returns (loss, {"ce": ..., "moe": ...})."""
    soft = icae_compress(ic, cfg, batch["source"], remat=remat)
    tgt = batch["target"]
    m = soft.shape[1]
    tgt_emb = F.embedding(tgt.long(), target.embed.tokens)
    embeds = torch.cat([soft.to(tgt_emb.dtype), tgt_emb], dim=1)
    logits, aux = target(embeds=embeds, remat=remat)
    loss = next_token_loss(logits[:, m:], tgt, batch.get("target_mask"))
    return loss + aux["moe_loss"], {"ce": loss, "moe": aux["moe_loss"]}


def _trainable_path(path: str, variant: str) -> bool:
    """``repro/core/icae.py:91``'s rule on a JAX parameter path."""
    if path.startswith(("lora", "mem_embed")):
        return True
    return (variant == "icae++" and path.startswith("compressor")
            and "/attn/" in path)


def icae_trainable_mask(ic: ICAE) -> dict:
    """{JAX parameter path: bool}: which of ``ic``'s parameters train,
    keyed as ``repro.core.icae.icae_trainable_mask``'s tree flattens
    (``bridge.jax_path``)."""
    from repro_torch import bridge

    out = {}
    for name, _ in ic.named_parameters():
        path = bridge.jax_path(ic.cfg, "icae", name)
        out[path] = _trainable_path(path, ic.variant)
    return out


def set_trainable(ic: ICAE) -> dict:
    """Turn ``requires_grad`` on for the variant's trainable parameters and
    off for the others; returns {port name: parameter} of the trainable
    ones, in ``named_parameters`` order."""
    from repro_torch import bridge

    out = {}
    for name, p in ic.named_parameters():
        on = _trainable_path(bridge.jax_path(ic.cfg, "icae", name),
                             ic.variant)
        p.requires_grad_(on)
        if on:
            out[name] = p
    return out
