"""MemCom — the paper's contribution (§4), as PyTorch modules
(``repro/core/memcom.py``).

A :class:`MemCom` holds the Source-LLM and the Memory-LLM (both initialised
as copies of the target), the per-layer cross-attention ``memx`` and the
``m`` learnable memory-token embeddings.  :func:`compress` runs the
Source-LLM with per-layer capture, then the Memory-LLM over the memory
tokens with the compression cross-attention, and packages the per-layer
O^i as the prefix the frozen target consumes; it records no autograd
graph (serving).  In a hybrid stack (Jamba) only the attention / MLA
layers get a cross-attention and an O^i; a Mamba2 layer hands off the
Source-LLM's exact final SSM state instead (``{"ssm": state}``), and its
``memx`` entry is a hole (``None`` in :func:`memx_list`).
:func:`begin_compress` / :func:`compress_chunk` /
:func:`finish_compress` (and :func:`compress_chunked`) compute the same
prefix in slices of the shot set, the Source-LLM's cache carried across
slices.  On the card a slice of any width gives the one-shot's O^i bit
for bit (for the attention-only stacks): its flash call walks each row's
keys unsplit, as the one-shot call does, and its rows are padded to a
multiple of ``CHUNK_ROWS``, at which the card's matmuls compute each row
as they do in the one-shot's (fewer rows take other GEMM kernels, whose
sums round otherwise).

Enc-dec (Whisper): ``encoder_frames`` (B, F, D) run the Source-LLM's
encoder, and its output is what the Source-LLM's, the Memory-LLM's and
(in ``memcom_loss``) the target's decoder blocks cross-attend to, as the
JAX package threads it; ``info["encoder_out"]`` returns it.  Without
frames a cross block falls through as the JAX package's does (see
:mod:`repro_torch.models.attention`): the one-shot compress runs it as a
causal self-attention, while a chunked compress, whose Source-LLM cache
holds zero cross entries, attends to them, so the two prefixes differ
(as they do in the JAX package).

Training (``memcom_loss``): Phase-1 trains only ``memx`` and
``mem_tokens``; Phase-2 also the Source- and Memory-LLM; the target is
frozen in both.  :func:`set_trainable` turns ``requires_grad`` on for the
phase's parameters only (the counterpart of the JAX step's
``stop_gradient`` on frozen leaves), so no weight gradient forms for the
others and the Phase-1 source pass records nothing for the backward.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.param import Init, initialize, make
from repro_torch.models.transformer import Transformer
from repro_torch.models.xattn import MemXAttn
from repro_torch.sharding.collectives import sum_over, unsharded
from repro_torch.sharding.ctx import data_group


#: On the card a compress slice of w tokens runs ceil(w / CHUNK_ROWS) *
#: CHUNK_ROWS rows (the rest token 0, their K/V written past the slice
#: and overwritten by the next one, their hidden states dropped): at 128
#: rows and more the card's bf16 GEMMs give each row the one-shot's bits
#: (``scripts/compile_width_drift.py``).
CHUNK_ROWS = 128


def _pads_chunks(cfg: ModelConfig, device: torch.device) -> bool:
    """Whether a compress slice is padded to ``CHUNK_ROWS``: on the card,
    for a Source-LLM of attention layers and dense MLPs.  A Mamba2 state
    would advance over the padding and a MoE layer's capacity would count
    it, so those stacks run their slices as they come."""
    return device.type == "cuda" and cfg.encoder is None and all(
        d.mixer == "attn" and d.mlp != "moe" and not d.cross_attn
        for d in cfg.layout.descriptors())


def _chunks_as_decode(cfg: ModelConfig) -> bool:
    """Whether a compress slice runs as a static-start decode (attention
    stacks: each layer writes the slice's K/V and makes one unsplit causal
    call over the cached keys, row for row the one-shot call) or, where a
    Mamba2 or MLA layer sits in the stack, as the reference's prefill
    continuation (the recurrence continues from the cached state; an MLA
    layer attends to its cached latents as a prefix, merged by lse)."""
    return all(d.mixer == "attn" for d in cfg.layout.descriptors())


def _needs_state_handoff(cfg: ModelConfig) -> bool:
    if cfg.memcom is None or not cfg.memcom.ssm_state_handoff:
        return False
    return any(d.mixer == "mamba" for d in cfg.layout.descriptors())


def _memx(cfg: ModelConfig, *, device, dtype) -> nn.ModuleList:
    """One uninitialised cross-attention for each attention / MLA layer;
    a Mamba2 layer's entry is an ``nn.Identity`` that holds nothing (the
    JAX tree's ``None``), so the parameter names keep the layer index."""
    return nn.ModuleList(
        MemXAttn(cfg, device=device, dtype=dtype)
        if d.mixer in ("attn", "mla") else nn.Identity()
        for d in cfg.layout.descriptors())


def memx_list(memx: nn.ModuleList) -> list:
    """The per-layer cross-attentions with ``None`` at the holes."""
    return [x if isinstance(x, MemXAttn) else None for x in memx]


class MemCom(nn.Module):
    """Source-LLM, Memory-LLM, per-layer ``memx`` and ``mem_tokens``; the
    last two are declared uninitialised on the stacks' device."""

    def __init__(self, cfg: ModelConfig, source: Transformer,
                 memory_llm: Transformer, device=None):
        super().__init__()
        if cfg.memcom is None:
            raise ValueError(f"{cfg.name}: set ModelConfig.memcom")
        self.cfg = cfg
        kw = dict(device=device or source.device, dtype=source.dtype)
        self.memx = _memx(cfg, **kw)
        make(self, "mem_tokens", (cfg.memcom.num_memory_tokens, cfg.d_model),
             Init("normal", scale=cfg.d_model ** -0.5), axes=(None, "embed"),
             **kw)
        self.source = source
        self.memory_llm = memory_llm


def init_memcom(cfg: ModelConfig, target: Transformer, seed: int = 0, *,
                mesh=None, rules=None) -> MemCom:
    """Source and Memory-LLM are copies of ``target``; ``memx`` and the
    memory tokens are drawn from ``seed``.  Lives on the target's device.
    With ``mesh`` (``target`` placed on it by ``init_params(...,
    mesh=)``), ``memx`` and the memory tokens are drawn one at a time and
    cut to this rank's slices by ``rules`` (the stacks are the target's
    slices already)."""
    if mesh is None:
        mc = MemCom(cfg, copy.deepcopy(target), copy.deepcopy(target))
        return initialize(mc, seed, skip=("source", "memory_llm"))
    from repro_torch.sharding.rules import FSDP_RULES
    from repro_torch.sharding.serving import shard_module

    mc = MemCom(cfg, copy.deepcopy(target), copy.deepcopy(target),
                device="meta")
    return shard_module(mc, mesh, rules or FSDP_RULES, seed=seed,
                        device=target.device)


def init_memx(cfg: ModelConfig, seed: int = 0, *, device=None,
              dtype=None) -> nn.ModuleList:
    """The per-layer cross-attention ``memx`` alone, drawn from ``seed`` as
    :func:`init_memcom` draws its ``memx`` (on the card by default)."""
    from repro_torch import resolve_device
    from repro_torch.models.transformer import torch_dtype

    holder = nn.Module()
    holder.memx = _memx(cfg, device=resolve_device(device),
                        dtype=torch_dtype(cfg, dtype))
    return initialize(holder, seed).memx


def _as_tokens(mc: MemCom, tokens):
    if tokens is not None and not torch.is_tensor(tokens):
        tokens = torch.as_tensor(tokens, dtype=torch.long,
                                 device=mc.mem_tokens.device)
    return tokens


def _memory(mc: MemCom, cfg: ModelConfig, hiddens: list, source_cache=None,
            remat=False, encoder_out=None):
    """The Memory-LLM over the m memory tokens with the per-layer
    cross-attention into the source hiddens H^i (and its enc-dec blocks
    into the Source-LLM's ``encoder_out``); returns the prefix (the
    Mamba2 layers' entries are ``source_cache``'s final states)."""
    B = hiddens[0].shape[0]
    m = cfg.memcom.num_memory_tokens
    with unsharded(mc):  # fully sharded memory tokens, gathered whole
        mem_embeds = mc.mem_tokens[None].expand(B, m, cfg.d_model)
    _, aux_m = mc.memory_llm(
        embeds=mem_embeds,
        memcom={"params": memx_list(mc.memx), "src": hiddens},
        logits=False, remat=remat, encoder_out=encoder_out)
    return build_prefix(cfg, aux_m["omega"], source_cache)


def compress_with_grad(mc: MemCom, cfg: ModelConfig, source_tokens=None, *,
                       source_embeds=None, encoder_frames=None,
                       remat: bool = False):
    """:func:`compress` with autograd on (training): the gradient reaches
    whichever parameters require it."""
    source_tokens = _as_tokens(mc, source_tokens)
    state_cache = None
    if _needs_state_handoff(cfg):
        B = (source_tokens if source_tokens is not None
             else source_embeds).shape[0]
        state_cache = _mamba_only_cache(cfg, B, mc)
    _, aux_s = mc.source(tokens=source_tokens, embeds=source_embeds,
                         capture_hiddens=True, cache=state_cache,
                         cache_index=0 if state_cache is not None else None,
                         logits=False, remat=remat,
                         encoder_frames=encoder_frames)
    enc = aux_s["encoder_out"]
    return (_memory(mc, cfg, aux_s["hiddens"], state_cache, remat, enc),
            {"encoder_out": enc})


@torch.no_grad()
def compress(mc: MemCom, cfg: ModelConfig, source_tokens=None, *,
             source_embeds=None, encoder_frames=None):
    """Many-shot tokens (B, T) -> per-layer compressed prefix for the target.

    Returns (prefix, info): ``prefix[i] = {"h": O^i (B, m, D)}`` for an
    attention / MLA layer, ``{"ssm": final source state (B, H, P, N)
    float32}`` for a Mamba2 layer; ``info["encoder_out"]`` the Source-
    LLM's encoder output over ``encoder_frames`` (None without).  Records
    no autograd graph."""
    return compress_with_grad(mc, cfg, source_tokens,
                              source_embeds=source_embeds,
                              encoder_frames=encoder_frames)


# ---------------------------------------------------------------------------
# Chunked compression (the online-serving variant)
# ---------------------------------------------------------------------------


@dataclass
class CompressionState:
    """Carry-over between :func:`compress_chunk` calls: the Source-LLM's
    per-layer cache, the H^i captured so far (one list per chunk) and the
    encoder's output over the frames (enc-dec; None without)."""

    cache: list
    offset: int = 0
    hiddens: List[list] = field(default_factory=list)
    encoder_out: Optional[torch.Tensor] = None


@torch.no_grad()
def begin_compress(cfg: ModelConfig, batch: int, total_len: int, *,
                   mc: MemCom, encoder_frames=None) -> CompressionState:
    """Open a chunked compression over ``total_len`` source tokens: a full
    Source-LLM cache (K/V of attention layers, recurrent state of Mamba2
    ones, an enc-dec block's cross entries) on ``mc``'s device, in its
    type, with room for the last slice's padding rows where slices are
    padded; with ``encoder_frames`` the Source-LLM's encoder runs once
    here."""
    from repro_torch.models.transformer import init_cache

    device = mc.mem_tokens.device
    if _pads_chunks(cfg, device):
        total_len += CHUNK_ROWS - 1
    encoder_out = None
    if cfg.encoder is not None and encoder_frames is not None:
        encoder_out = mc.source.encoder(encoder_frames)
    return CompressionState(cache=init_cache(
        cfg, batch, total_len, dtype=mc.mem_tokens.dtype, device=device),
        encoder_out=encoder_out)


@torch.no_grad()
def compress_chunk(mc: MemCom, cfg: ModelConfig, state: CompressionState,
                   tokens) -> CompressionState:
    """Run the Source-LLM over one chunk (B, w) of the shot set behind the
    cached [0, offset) context and fold it into ``state``.

    In an attention stack each layer writes the chunk's K/V into the cache
    and makes one causal call over the cached keys [0, offset + w),
    unsplit, row for row the call :func:`compress` makes over the whole
    shot set (a stack with Mamba2 or MLA layers runs the prefill
    continuation instead, see :func:`_chunks_as_decode`); on the
    card the slice is padded to a multiple of ``CHUNK_ROWS`` rows (see
    :func:`_pads_chunks`): the chunked O^i are then bitwise those of the
    one-shot compress at any slice width.  (The JAX package runs the
    chunk through the prefill continuation, two partial calls merged by
    their log-sum-exp, which in bf16 rounds each row twice;
    ``scripts/chunk_compile_rounding.py`` measures how far that lands
    from the one-shot result.)"""
    tokens = _as_tokens(mc, tokens)
    offset = state.offset
    w = tokens.shape[1]
    if _pads_chunks(cfg, tokens.device):
        tokens = F.pad(tokens, (0, -(-w // CHUNK_ROWS) * CHUNK_ROWS - w))
    _, aux = mc.source(tokens=tokens, capture_hiddens=True,
                       cache=state.cache, cache_index=offset,
                       mask_offset=0 if _chunks_as_decode(cfg) else offset,
                       decode=_chunks_as_decode(cfg), logits=False,
                       encoder_out=state.encoder_out)
    hid = aux["hiddens"]
    if tokens.shape[1] != w:
        hid = [h[:, :w] for h in hid]
    return replace(state, offset=offset + w, hiddens=state.hiddens + [hid])


@torch.no_grad()
def finish_compress(mc: MemCom, cfg: ModelConfig, state: CompressionState):
    """Close a chunked compression: the captured H^i joined along the
    source-time axis, the Memory-LLM run once.  Same return as
    :func:`compress`."""
    if not state.hiddens:
        raise ValueError("no chunks were compressed")
    hiddens = [torch.cat(xs, dim=1) for xs in zip(*state.hiddens)]
    return (_memory(mc, cfg, hiddens, state.cache,
                    encoder_out=state.encoder_out),
            {"encoder_out": state.encoder_out})


def compress_chunked(mc: MemCom, cfg: ModelConfig, source_tokens, *,
                     chunk_size: int, encoder_frames=None):
    """:func:`compress` computed in ``chunk_size``-token slices with the
    Source-LLM cache carried across slices."""
    source_tokens = _as_tokens(mc, source_tokens)
    B, T = source_tokens.shape
    state = begin_compress(cfg, B, T, mc=mc, encoder_frames=encoder_frames)
    for lo in range(0, T, chunk_size):
        state = compress_chunk(mc, cfg, state,
                               source_tokens[:, lo:lo + chunk_size])
    return finish_compress(mc, cfg, state)


def _mamba_only_cache(cfg: ModelConfig, batch: int, mc: MemCom) -> list:
    """A Source-LLM cache holding only the Mamba2 layers' conv / SSM state
    (``{}`` for the others: no K/V is allocated for a one-shot compress)."""
    from repro_torch.models.mamba2 import init_mamba_cache

    kw = dict(dtype=mc.mem_tokens.dtype, device=mc.mem_tokens.device)
    return [init_mamba_cache(cfg, batch, **kw) if d.mixer == "mamba" else {}
            for d in cfg.layout.descriptors()]


def build_prefix(cfg: ModelConfig, omega: list, source_cache=None) -> list:
    """Assemble the target's per-layer compressed context: ``{"h": O^i}``
    for each attention / MLA layer (``omega`` holds one O^i for each, in
    layer order), ``{"ssm": state}`` from ``source_cache`` for each Mamba2
    layer (``{}`` without a state handoff)."""
    descs = cfg.layout.descriptors()
    n_attn = sum(d.mixer in ("attn", "mla") for d in descs)
    if len(omega) != n_attn:
        raise ValueError(f"{len(omega)} O^i for {n_attn} attention layers")
    out, it = [], iter(omega)
    for i, d in enumerate(descs):
        if d.mixer in ("attn", "mla"):
            out.append({"h": next(it)})
        elif source_cache is not None:
            out.append({"ssm": source_cache[i]["ssm"]})
        else:
            out.append({})
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def memcom_loss(mc: MemCom, target: Transformer, cfg: ModelConfig, batch, *,
                remat: bool = False):
    """Next-token CE on the target segment (the paper's objective), with
    the compressor run under autograd.

    batch: {"source": (B,T), "target": (B,S), "target_mask": (B,S)}
    tensors, and "frames" (B, F, D) for an enc-dec model.  Returns (loss,
    {"ce": ..., "moe": ...})."""
    prefix, info = compress_with_grad(
        mc, cfg, batch.get("source"),
        source_embeds=batch.get("source_embeds"),
        encoder_frames=batch.get("frames"), remat=remat)
    m = cfg.memcom.num_memory_tokens
    logits, aux = target(tokens=batch["target"], prefix=prefix,
                         mask_offset=m, remat=remat,
                         encoder_out=info["encoder_out"])
    loss = next_token_loss(logits, batch["target"], batch.get("target_mask"))
    return loss + aux["moe_loss"], {"ce": loss, "moe": aux["moe_loss"]}


def next_token_loss(logits, tokens, mask=None):
    """Mean negative log-likelihood of tokens[:, 1:] under logits[:, :-1]
    in float32, weighted by ``mask[:, 1:]``.  The pick of each target's
    log-probability is ``nll_loss`` (its backward writes one element a
    row, deterministic on the card).

    Under a placement whose batch is split over data ranks
    (``sharding.ctx.data_group``) each rank holds a batch shard: the
    numerator and the mask count are summed over the data ranks, so every
    rank returns the global mean (the mean of the ranks' means would
    weigh the ranks' masks wrongly), and the numerator's backward is the
    identity, so each rank's gradient is its own share of the global one,
    which the parameters' data reduction sums."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    ll = -F.nll_loss(lp.reshape(-1, lp.shape[-1]), tgt.reshape(-1),
                     reduction="none").reshape(tgt.shape)
    w = (mask[:, 1:].float() if mask is not None else torch.ones_like(ll))
    group = data_group()
    if group is None:
        return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)
    num = sum_over(-(ll * w).sum(), group)
    return num / torch.clamp(sum_over(w.sum().detach(), group), min=1.0)


def _trainable_path(path: str, phase: int) -> bool:
    return phase == 2 or path.startswith(("memx", "mem_tokens"))


def trainable_mask(mc: MemCom, phase: int) -> dict:
    """{JAX parameter path: bool}: which compressor parameters receive
    gradients in ``phase``, keyed as ``repro.core.memcom.trainable_mask``'s
    tree flattens (``bridge.jax_path``)."""
    from repro_torch import bridge

    return {bridge.jax_path(mc.cfg, "memcom", name):
            _trainable_path(bridge.jax_path(mc.cfg, "memcom", name), phase)
            for name, _ in mc.named_parameters()}


def set_trainable(mc: MemCom, phase: int) -> dict:
    """Turn ``requires_grad`` on for the phase's trainable parameters and
    off for the others; returns {port name: parameter} of the trainable
    ones, in ``named_parameters`` order."""
    from repro_torch import bridge

    out = {}
    for name, p in mc.named_parameters():
        on = _trainable_path(bridge.jax_path(mc.cfg, "memcom", name), phase)
        p.requires_grad_(on)
        if on:
            out[name] = p
    return out
