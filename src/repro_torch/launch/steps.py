"""Makers of step functions (``repro/launch/steps.py``'s
``build_memcom_train_step``, ``build_lm_train_step``,
``build_compress_step``, ``build_prefill_step`` and ``build_decode_step``,
and the ICAE step ``benchmarks/common.py``'s
``train_compressor(kind="icae")`` jits; the dry-run's compile-only
makers are not ported), its cell helpers: ``shape_by_name``,
``cell_is_skipped``, ``input_specs`` (shapes, dtypes and, given a mesh,
placements) and ``default_objective``, and its sharding helpers:
``_batch_spec``, ``act_sharding_for``, ``param_shardings``,
``memcom_shardings``, ``opt_shardings`` and ``default_rules_for``, which
return the port's :class:`~repro_torch.sharding.rules.Placement` records
where the JAX ones return ``NamedSharding``s.  ``cache_shardings`` (the
dry-run's decode placement) and ``build_cell`` wait for the dry-run
(ROADMAP Queue 1 step 5.3); the engine places its caches by head.

Each training maker returns ``(step, opt, params)``: ``params`` the
flat dict of the tensors the step trains (leaves of the live modules,
``requires_grad`` on), ``opt`` the AdamW whose ``init(params)`` makes the
step's state, and ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``, which updates both in place.  The serving makers return the
step alone; ``batch["frames"]`` (B, F, D) is how an enc-dec model's
encoder frames reach it, as in the JAX package (the engine takes none).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.config import SHAPES, ModelConfig, ShapeSpec
from repro_torch.configs import get_config
from repro_torch.core import icae, memcom
from repro_torch.launch import costs
from repro_torch.optim import AdamW, warmup_constant, warmup_cosine
from repro_torch.sharding.rules import (FSDP_EP_EMBED_RULES, FSDP_RULES,
                                        PartitionSpec, Placement, Rules,
                                        _data_axes, axis_sizes,
                                        logical_to_shardings,
                                        opt_state_shardings)
from repro_torch.train import build_train_step


# Archs whose family makes MemCom inapplicable (train falls back to LM).
ATTENTION_FREE = ("mamba2-370m",)
# Sub-quadratic archs that run long_500k.
SUBQUADRATIC = ("mamba2-370m", "jamba-1.5-large-398b")


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_skipped(arch: str, shape_name: str) -> Optional[str]:
    """Return a skip reason or None (long_500k is sub-quadratic-only)."""
    shape = shape_by_name(shape_name)
    if shape.subquadratic_only and arch not in SUBQUADRATIC:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def default_objective(arch: str, shape: ShapeSpec) -> str:
    if shape.kind == "train":
        return "lm_train" if arch in ATTENTION_FREE else "memcom_train"
    if shape.kind == "prefill":
        return "prefill" if arch in ATTENTION_FREE else "compress"
    return "decode"


class TensorSpec(NamedTuple):
    """The shape, dtype and (given a mesh) placement of one model input
    (no storage)."""
    shape: tuple
    dtype: torch.dtype
    sharding: Optional[Placement] = None


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def _n_data(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _data_axes(mesh):
        n *= sizes[a]
    return n


def _batch_spec(mesh, batch: int, ndim: int) -> Placement:
    """The batch dimension over the data axes where they divide it."""
    lead = _data_axes(mesh) if batch % _n_data(mesh) == 0 else None
    return Placement(mesh, PartitionSpec(lead, *([None] * (ndim - 1))))


def act_sharding_for(mesh, cfg: ModelConfig, batch: int,
                     seq: int) -> Placement:
    """The residual stream's placement: batch over the data axes,
    sequence over "model" (the JAX record; the port takes the batch
    split and keeps the sequence whole, ``sharding.ctx``)."""
    b = _data_axes(mesh) if batch % _n_data(mesh) == 0 else None
    model = axis_sizes(mesh).get("model", 1)
    s = "model" if seq % model == 0 and seq > 1 else None
    return Placement(mesh, PartitionSpec(b, s, None))


def param_shardings(cfg: ModelConfig, mesh, rules: Rules = FSDP_RULES):
    """``({name: Placement}, abstract target)``: the target's parameters
    placed by ``rules``, the target built on the meta device."""
    from repro_torch.models.transformer import Transformer, torch_dtype

    abstract = Transformer(cfg, device="meta", dtype=torch_dtype(cfg))
    return logical_to_shardings(abstract, mesh, rules), abstract


def memcom_shardings(cfg: ModelConfig, mesh, rules: Rules = FSDP_RULES):
    """``({name: Placement}, abstract MemCom)`` (meta device)."""
    _, tgt = param_shardings(cfg, mesh, rules)
    import copy

    mc = memcom.MemCom(cfg, copy.deepcopy(tgt), copy.deepcopy(tgt))
    return logical_to_shardings(mc, mesh, rules), mc


def opt_shardings(state, p_shardings, mesh) -> dict:
    return opt_state_shardings(state, p_shardings, mesh)


def default_rules_for(cfg: ModelConfig, mesh) -> Rules:
    """FSDP with expert-parallel expert weights, unless the expert count
    does not divide the model axis (then the expert d_model shards over
    the data axes too), as the JAX function chooses."""
    if cfg.moe is not None and \
            cfg.moe.num_experts % axis_sizes(mesh).get("model", 1):
        return FSDP_EP_EMBED_RULES
    return FSDP_RULES


def input_specs(arch: str, shape_name: str,
                objective: Optional[str] = None, *, mesh=None) -> dict:
    """Every batch input of one cell as a :class:`TensorSpec`, keyed as
    the step makers read them (the reference's ``input_specs``; with
    ``mesh`` each carries its placement: the batch over the data axes).
    An enc-dec model's training and compress / prefill cells carry
    ``frames`` (B, num_frames, d_model) in the config's dtype."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    objective = objective or default_objective(arch, shape)
    B = shape.global_batch
    i32 = torch.int32

    def placed(b, ndim):
        return None if mesh is None else _batch_spec(mesh, b, ndim)

    def tok(n, b=B):
        return TensorSpec((b, n), i32, placed(b, 2))

    out: dict = {}
    if objective == "memcom_train":
        T, S = costs.train_split(shape)
        out["source"] = tok(T)
        out["target"] = tok(S)
        out["target_mask"] = TensorSpec((B, S), i32, placed(B, 2))
    elif objective == "lm_train":
        out["tokens"] = tok(shape.seq_len)
    elif objective in ("compress", "prefill"):
        out["source"] = tok(shape.seq_len)
    elif objective.startswith("decode"):
        out["tokens"] = tok(1)
        out["cache_index"] = TensorSpec((), i32)  # replicated
    else:
        raise ValueError(objective)
    if cfg.encoder is not None and objective in (
            "memcom_train", "lm_train", "compress", "prefill"):
        e = cfg.encoder
        out["frames"] = TensorSpec((B, e.num_frames, cfg.d_model),
                                   getattr(torch, cfg.dtype), placed(B, 3))
    return out


def build_memcom_train_step(cfg: ModelConfig, mc: memcom.MemCom, target, *,
                            phase: int = 1, remat: bool = True,
                            clip: float = 1.0, lr: Optional[Callable] = None,
                            mesh=None, act: Optional[Placement] = None):
    """The phase's trainable parameters get ``requires_grad`` (the others
    none: no weight gradient forms for them, as under the reference's
    ``stop_gradient``; activation gradients still flow through every
    stack).  ``lr`` defaults to the reference's schedule: warmup_cosine
    from 2e-4 (Phase 1) or 2e-6 (Phase 2), 500 warmup steps of 20,000.

    With ``mesh`` (``mc`` and ``target`` placed on it, each batch the
    rank's data shard) the step runs under a
    :class:`~repro_torch.sharding.training.TrainPlacement` of the trained
    slices and ``act`` (the residual stream's placement,
    ``act_sharding_for``), exposed as ``step.placement``."""
    params = memcom.set_trainable(mc, phase)
    for p in target.parameters():
        p.requires_grad_(False)
    sched = lr or warmup_cosine(2e-4 if phase == 1 else 2e-6,
                                warmup_steps=500, total_steps=20_000)
    opt = AdamW(lr=sched)
    placement = None
    if mesh is not None:
        from repro_torch.sharding.serving import placed_specs
        from repro_torch.sharding.training import TrainPlacement

        specs = placed_specs(mc)
        placement = TrainPlacement(mesh, {n: specs[n] for n in params}, act)

    def loss_fn(params, batch):
        return memcom.memcom_loss(mc, target, cfg, batch, remat=remat)

    return (build_train_step(loss_fn, opt, clip=clip, placement=placement),
            opt, params)


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
