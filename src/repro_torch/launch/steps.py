"""Makers of step functions (``repro/launch/steps.py``'s
``build_memcom_train_step``, ``build_lm_train_step``,
``build_compress_step``, ``build_prefill_step`` and ``build_decode_step``,
and the ICAE step ``benchmarks/common.py``'s
``train_compressor(kind="icae")`` jits; the dry-run's compile-only
makers are not ported).

Each training maker returns ``(step, opt, params)``: ``params`` the
flat dict of the tensors the step trains (leaves of the live modules,
``requires_grad`` on), ``opt`` the AdamW whose ``init(params)`` makes the
step's state, and ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``, which updates both in place.  The serving makers return the
step alone; ``batch["frames"]`` (B, F, D) is how an enc-dec model's
encoder frames reach it, as in the JAX package (the engine takes none).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import icae, memcom
from repro_torch.optim import AdamW, warmup_constant, warmup_cosine
from repro_torch.train import build_train_step


def build_memcom_train_step(cfg: ModelConfig, mc: memcom.MemCom, target, *,
                            phase: int = 1, remat: bool = True,
                            clip: float = 1.0, lr: Optional[Callable] = None):
    """The phase's trainable parameters get ``requires_grad`` (the others
    none: no weight gradient forms for them, as under the reference's
    ``stop_gradient``; activation gradients still flow through every
    stack).  ``lr`` defaults to the reference's schedule: warmup_cosine
    from 2e-4 (Phase 1) or 2e-6 (Phase 2), 500 warmup steps of 20,000."""
    params = memcom.set_trainable(mc, phase)
    for p in target.parameters():
        p.requires_grad_(False)
    sched = lr or warmup_cosine(2e-4 if phase == 1 else 2e-6,
                                warmup_steps=500, total_steps=20_000)
    opt = AdamW(lr=sched)

    def loss_fn(params, batch):
        return memcom.memcom_loss(mc, target, cfg, batch, remat=remat)

    return build_train_step(loss_fn, opt, clip=clip), opt, params


def build_icae_train_step(cfg: ModelConfig, ic: icae.ICAE, target, *,
                          remat: bool = True, clip: float = 1.0,
                          lr: Optional[Callable] = None):
    """``icae_loss`` on the variant's trainable parameters (the adapters
    and ``mem_embed``; for icae++ also the compressor's attention), the
    target and the compressor's other tensors frozen (no gradient forms
    for them), global-norm clip at ``clip``, AdamW.  ``lr`` defaults to
    the reference's ``warmup_constant(2e-3, 30)``."""
    params = icae.set_trainable(ic)
    for p in target.parameters():
        p.requires_grad_(False)
    opt = AdamW(lr=lr or warmup_constant(2e-3, 30))

    def loss_fn(params, batch):
        return icae.icae_loss(ic, target, cfg, batch, remat=remat)

    return build_train_step(loss_fn, opt, clip=clip), opt, params


def build_lm_train_step(cfg: ModelConfig, model, *, remat: bool = True,
                        clip: float = 1.0, lr: Optional[Callable] = None):
    """Plain next-token training of every parameter of ``model`` on
    ``batch["tokens"]``."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = AdamW(lr=lr or warmup_cosine(1e-4, warmup_steps=500,
                                       total_steps=20_000))

    def loss_fn(params, batch):
        logits, aux = model(tokens=batch["tokens"], remat=remat,
                            encoder_frames=batch.get("frames"))
        loss = memcom.next_token_loss(logits, batch["tokens"])
        return loss + aux["moe_loss"], {"ce": loss}

    return build_train_step(loss_fn, opt, clip=clip), opt, params


def build_compress_step(cfg: ModelConfig):
    """``step(mc, target, batch) -> (materialized compressed cache,
    encoder_out or None)``: ``memcom.compress`` of ``batch["source"]``
    (with ``batch["frames"]``, an enc-dec model's encoder frames) and
    ``materialize_prefix`` through the target's projections."""
    from repro_torch.serving.prefix_store import materialize_prefix

    def step(mc, target, batch):
        prefix, info = memcom.compress(mc, cfg, batch.get("source"),
                                       encoder_frames=batch.get("frames"))
        return materialize_prefix(target, cfg, prefix), info["encoder_out"]

    return step


def build_prefill_step(cfg: ModelConfig, max_len: int):
    """``step(model, batch) -> (last logits (B, 1, V), cache)``: a plain
    prefill of ``batch["source"]`` into a fresh ``max_len`` cache (and,
    with ``batch["frames"]``, the encoder's output into its cross
    entries)."""
    from repro_torch.models.transformer import init_cache

    @torch.no_grad()
    def step(model, batch):
        B = batch["source"].shape[0]
        cache = init_cache(cfg, B, max_len, dtype=model.dtype,
                           device=model.device)
        logits, aux = model(tokens=batch["source"], cache=cache,
                            cache_index=0,
                            encoder_frames=batch.get("frames"))
        return logits[:, -1:], aux["cache"]

    return step


def build_decode_step(cfg: ModelConfig):
    """``step(model, cache, batch) -> (logits (B, S, V), cache)``: one
    decode step of ``batch["tokens"]`` at ``batch["cache_index"]`` (an int,
    or (B,) per-slot lengths); an enc-dec block reads its cross entries
    from the cache."""

    @torch.no_grad()
    def step(model, cache, batch):
        logits, aux = model(tokens=batch["tokens"], cache=cache,
                            cache_index=batch["cache_index"], decode=True)
        return logits, aux["cache"]

    return step
