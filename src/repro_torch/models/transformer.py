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

Enc-dec (Whisper): an :class:`Encoder` over precomputed frame embeddings
(sinusoidal positions, then per layer a layernorm, non-causal self-
attention and a gelu MLP, and a final norm) whose output the decoder
blocks cross-attend to; the decoder adds learned positions
(``embed.pos``).  Qwen2-VL's M-RoPE takes (3, B, S) positions; without
explicit ones the text positions are broadcast to three equal streams.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.attention import (Attention, init_attn_cache,
                                          init_cross_cache,
                                          init_paged_attn_cache)
from repro_torch.models.blocks import Block
from repro_torch.models.layers import (MLP, Norm, sinusoidal_pos_embed,
                                       softcap)
from repro_torch.models.mamba2 import init_mamba_cache
from repro_torch.models.mla import init_mla_cache, init_paged_mla_cache
from repro_torch.models.param import Init, initialize, make
from repro_torch.sharding.serving import gather_model, reduce_model

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig, dtype=None) -> torch.dtype:
    if dtype is not None:
        return dtype
    return DTYPES[cfg.dtype]


class Embed(nn.Module):
    # under a mesh the table may split by vocabulary (shard_module): this
    # rank holds rows [vocab_start, vocab_start + tokens.shape[0])
    tp = None
    vocab_start = 0

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        make(self, "tokens", (cfg.vocab_size, cfg.d_model),
             Init("normal", scale=cfg.d_model ** -0.5), device=device,
             dtype=dtype, axes=("vocab", "embed"))
        if cfg.pos_embed == "learned":
            make(self, "pos", (cfg.max_seq, cfg.d_model),
                 Init("normal", scale=0.02), device=device, dtype=dtype,
                 axes=(None, "embed"))


class EncoderLayer(nn.Module):
    """layernorm -> non-causal self-attention -> layernorm -> gelu MLP."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg, **kw)
        self.attn = Attention(cfg, **kw)
        self.norm2 = Norm(cfg, **kw)
        self.mlp = MLP(cfg, d_ff=cfg.encoder.d_ff, mlp_type="gelu_mlp", **kw)

    def forward(self, h):
        hn = self.norm1(h)
        o, _ = self.attn(hn, positions=None, kv_source=hn)
        h = h + o
        return h + self.mlp(self.norm2(h))


class Encoder(nn.Module):
    """Whisper's encoder over precomputed frame embeddings (the conv
    front end is the JAX package's stub too)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw)
                                    for _ in range(cfg.encoder.num_layers))
        self.final_norm = Norm(cfg, **kw)

    def forward(self, frames):
        """frames (B, F, D) -> encoder output (B, F, D)."""
        F_, D = frames.shape[1], frames.shape[2]
        h = frames + sinusoidal_pos_embed(F_, D, device=frames.device).to(
            frames.dtype)[None]
        for layer in self.layers:
            h = layer(h)
        return self.final_norm(h)


class Transformer(nn.Module):
    """Parameters are declared uninitialised; :func:`init_params` draws
    them from a seed and :mod:`repro_torch.bridge` loads JAX ones.

    Under a mesh (:func:`repro_torch.sharding.serving.shard_module`) each
    rank holds its slice of the split parameters: the embedding looks up
    the rank's vocabulary range and sums over the ranks, and the logits of
    a vocabulary-split head (tied or ``lm_head``) are gathered whole
    before the final softcap, so every rank holds the same logits."""

    tp = None  # this rank's ModelShard where lm_head splits (shard_module)

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = Embed(cfg, **kw)
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, desc, **kw) for desc in cfg.layout.descriptors())
        self.final_norm = Norm(cfg, **kw)
        if not cfg.tie_embeddings:
            make(self, "lm_head", (cfg.d_model, cfg.vocab_size),
                 axes=("embed", "vocab"), **kw)

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
        params: Optional[dict] = None,  # {"layers.{i}.<name>": tensor}
        encoder_frames=None,  # (B, F, D): run the encoder first
        encoder_out=None,  # (B, F, D): the encoder's output, given
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
        block twice).  ``params`` stands tensors in for block parameters of
        the same names in this call (the ICAE compressor's LoRA-merged
        weights): autograd reaches the tensors given, and a block
        recomputed under ``remat`` reads the same ones.

        Enc-dec: ``encoder_frames`` runs the encoder (unless
        ``encoder_out`` is given), whose output the decoder blocks
        cross-attend to and aux["encoder_out"] returns.  ``positions``
        may be (3, B, S) under M-RoPE."""
        cfg = self.cfg
        block_params = [{} for _ in self.layers]
        for name, t in (params or {}).items():
            head, li, rest = name.split(".", 2)
            if head != "layers":
                raise ValueError(f"params: {name} is no block parameter")
            block_params[int(li)][rest] = t
        if embeds is None:
            h = _embed_lookup(self.embed, tokens)
        else:
            h = embeds
        B, S = h.shape[0], h.shape[1]
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                                 device=h.device)
        ar = torch.arange(S, dtype=torch.int32, device=h.device)
        per_slot = (decode and torch.is_tensor(cache_index)
                    and cache_index.dim() == 1)
        start = None
        if per_slot:
            # continuous batching: each slot decodes at its own length
            pos2d = cache_index.to(torch.int32)[:, None] + ar[None, :]
        else:
            start = int(cache_index if (decode and cache_index is not None)
                        else mask_offset)
            pos2d = (start + ar).expand(B, S)
        if cfg.pos_embed == "learned":
            h = h + _learned_positions(self.embed.pos, pos2d, start).to(
                h.dtype)
        if positions is None:
            positions = pos2d
            if cfg.mrope_sections:
                positions = positions.expand(3, B, S)
        if cfg.encoder is not None and encoder_frames is not None \
                and encoder_out is None:
            encoder_out = self.encoder(encoder_frames)

        hiddens, omegas = [], []
        moe_loss = None
        for i, block in enumerate(self.layers):
            if capture_hiddens:
                hiddens.append(h)
            mem = None
            if memcom is not None and memcom["params"][i] is not None:
                mem = (memcom["params"][i], memcom["src"][i])
            kw = dict(positions=positions, mask_offset=mask_offset,
                      prefix=prefix[i] if prefix is not None else None,
                      cache=cache[i] if cache is not None else None,
                      cache_index=cache_index, decode=decode, memcom=mem,
                      block_tables=block_tables, lane_valid=lane_valid)
            if encoder_out is not None:
                kw["encoder_out"] = encoder_out
            if remat and torch.is_grad_enabled():
                h, _, a = checkpoint(_run_block, block, block_params[i], h, kw,
                                     use_reentrant=False)
            else:
                h, _, a = _run_block(block, block_params[i], h, kw)
            if a["moe_loss"] is not None:
                moe_loss = (a["moe_loss"] if moe_loss is None
                            else moe_loss + a["moe_loss"])
            if a["omega"] is not None:
                omegas.append(a["omega"])

        out = self.final_norm(h)
        if logits:
            if cfg.tie_embeddings:
                head, tp = self.embed.tokens.t(), self.embed.tp
            else:
                head, tp = self.lm_head, self.tp
            out = softcap(gather_model(out @ head, -1, tp),
                          cfg.final_logit_softcap)
        aux = {
            "cache": cache,
            "hiddens": hiddens if capture_hiddens else None,
            "omega": omegas if memcom is not None else None,
            "moe_loss": 0.0 if moe_loss is None else moe_loss,
            "encoder_out": encoder_out,
        }
        return out, aux


def _embed_lookup(embed: Embed, tokens):
    """Rows of the embedding table; a vocabulary-split table contributes
    the rows of its own range (zero elsewhere), summed over the ranks."""
    if embed.tp is None:
        return F.embedding(tokens, embed.tokens)
    n = embed.tokens.shape[0]
    local = tokens - embed.vocab_start
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), embed.tokens)
    return reduce_model(rows * mine[..., None].to(rows.dtype), embed.tp)


def _learned_positions(table, pos2d, start):
    """Rows of the learned position table at ``pos2d`` (B, S), as the JAX
    package reads them: per slot (``start`` None) a gather whose rows past
    the table are NaN (``jnp.take``'s fill; the index is clamped first, so
    the card never reads out of range), else the slice from the python
    int ``start``, clamped so that it fits (``dynamic_slice``)."""
    n = table.shape[0]
    if start is None:
        rows = table[pos2d.clamp(0, n - 1).long()]
        ok = ((pos2d >= 0) & (pos2d < n))[..., None]
        return torch.where(ok, rows, torch.full_like(rows, float("nan")))
    S = pos2d.shape[1]
    start = min(max(start, 0), n - S)
    return table[start:start + S][None]


def _run_block(block: Block, params: dict, h, kw: dict):
    """``block(h, **kw)``, with ``params`` standing in for its parameters
    of those names."""
    if not params:
        return block(h, **kw)
    return functional_call(block, params, (h,), kw)


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
    attention layers, (batch, max_len, kv_lora / rope) latent stripes for
    MLA layers, per-slot conv/ssm state for Mamba2 layers, and a decoder
    block's (batch, num_frames, H, hd) cross entries ``ck`` / ``cv``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg, dtype)

    def one(desc):
        if desc.mixer == "mamba":
            return init_mamba_cache(cfg, batch, dtype, device)
        if desc.mixer == "mla":
            return init_mla_cache(cfg, batch, max_len, dtype, device)
        return init_attn_cache(cfg, batch, max_len, dtype, device)
    return [_with_cross(cfg, desc, one(desc), batch, dtype, device)
            for desc in cfg.layout.descriptors()]


def _with_cross(cfg: ModelConfig, desc, c: dict, slots: int, dtype,
                device) -> dict:
    """A decoder block's cache gains its per-slot cross entries."""
    if desc.cross_attn:
        c.update(init_cross_cache(cfg, slots, cfg.encoder.num_frames, dtype,
                                  device))
    return c


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=None, device=None) -> list:
    """Block-pool cache: one (num_blocks, block_size, Hkv, hd) K/V pool per
    attention layer and one (num_blocks, block_size, kv_lora / rope)
    latent pool per MLA layer, addressed through per-slot block tables; a
    Mamba2 layer's conv/ssm state and a decoder block's cross entries stay
    per slot (``slots`` rows), a fixed size that paging would not
    shrink."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg, dtype)

    def one(desc):
        if desc.mixer == "mamba":
            return init_mamba_cache(cfg, slots, dtype, device)
        if desc.mixer == "mla":
            return init_paged_mla_cache(cfg, num_blocks, block_size, dtype,
                                        device)
        return init_paged_attn_cache(cfg, num_blocks, block_size, dtype,
                                     device)
    return [_with_cross(cfg, desc, one(desc), slots, dtype, device)
            for desc in cfg.layout.descriptors()]
