"""Analytic FLOP / HBM-byte model for the roofline (``repro/launch/
costs.py``, ported term for term: every function gives the JAX module's
float bit for bit, its evaluation order kept).

Why analytic: the reference's compiler counts a scanned layer body once,
and a profiler's FLOP counter sees only the ops it recognises; every
matmul of this framework is known in closed form, so FLOPs and bytes are
accounted analytically.  ``launch/roofline.py`` divides them by the
card's peaks.

One addition: ``memcom_train_cost(..., split=(T, S))`` costs the source /
target split a run actually used (``train_split``'s 75/25 when None).

Conventions
-----------
* FLOPs are GLOBAL (whole step, all chips); the roofline divides by chips.
* A matmul (m×k)·(k×n) costs 2mkn.
* Backward-pass multipliers: trainable stack ×3 (fwd + dL/dx + dL/dW),
  frozen-but-backpropagated stack ×2 (fwd + dL/dx — the Target-LLM in
  MemCom training: activations carry gradients to the compressed prefix
  but no weight grads are formed), frozen forward-only ×1.
* HBM bytes are a structural estimate: weight traffic × passes, optimizer
  traffic for trainable params, activation traffic ~ C·tokens·d per layer,
  KV-cache traffic for decode.  Coarser than FLOPs but the decode cells it
  classifies as memory-bound are unambiguous (arith intensity < 10).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import LayerDesc, ModelConfig, ShapeSpec

BF16 = 2


@dataclass
class CellCost:
    flops: float  # global
    hbm_bytes: float  # global
    model_flops: float  # 6·N_active·tokens (the "useful" reference)
    detail: dict


# ---------------------------------------------------------------------------
# per-block FLOPs for processing n_q tokens attending to avg ctx tokens
# ---------------------------------------------------------------------------


def _attn_flops(cfg: ModelConfig, n_q: float, ctx: float, cross: bool = False) -> float:
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    proj = 2 * d * nh * hd + 2 * 2 * d * nkv * hd + 2 * nh * hd * d
    attn = 4 * ctx * nh * hd  # scores + AV
    total = n_q * (proj + attn)
    if cross:
        total *= 2  # whisper decoder has self + cross modules
    return total


def _mla_flops(cfg: ModelConfig, n_q: float, ctx: float, decode: bool) -> float:
    m = cfg.mla
    d, nh = cfg.d_model, cfg.num_heads
    q_proj = 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * nh * m.qk_head_dim
    latent = 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
    if decode:  # absorbed: attention runs in latent space
        absorb = 2 * nh * m.qk_nope_head_dim * m.kv_lora_rank * 2  # q fold + out
        attn = 2 * ctx * nh * (m.kv_lora_rank + m.qk_rope_head_dim) \
            + 2 * ctx * nh * m.kv_lora_rank
        out = 2 * nh * m.v_head_dim * d
        return n_q * (q_proj + latent + absorb + attn + out)
    expand = 2 * m.kv_lora_rank * nh * (m.qk_nope_head_dim + m.v_head_dim)
    attn = 2 * ctx * nh * m.qk_head_dim + 2 * ctx * nh * m.v_head_dim
    out = 2 * nh * m.v_head_dim * d
    return n_q * (q_proj + latent + expand + attn + out)


def _mamba_flops(cfg: ModelConfig, n_q: float, decode: bool) -> float:
    mb = cfg.mamba
    d = cfg.d_model
    di, N, P = mb.d_inner(d), mb.d_state, mb.headdim
    nh, g = mb.nheads(d), mb.ngroups
    proj = 2 * d * (2 * di + 2 * g * N + nh) + 2 * di * d
    conv = 2 * mb.conv_width * (di + 2 * g * N)
    if decode:
        ssd = nh * 4 * N * P
    else:
        Q = mb.chunk_size
        ssd = nh * (2 * Q * N + 2 * Q * P + 4 * N * P)
    return n_q * (proj + conv + ssd)


def _mlp_flops(cfg: ModelConfig, desc: LayerDesc, n_q: float) -> float:
    d = cfg.d_model
    if desc.mlp == "none":
        return 0.0
    if desc.mlp == "moe":
        m = cfg.moe
        router = 2 * d * m.num_experts
        experts = 6 * m.capacity_factor * m.top_k * d * m.expert_d_ff
        shared = 6 * d * m.num_shared_experts * m.shared_ff()
        return n_q * (router + experts + shared)
    per = 4 * d * cfg.d_ff if cfg.mlp_type == "gelu_mlp" else 6 * d * cfg.d_ff
    return n_q * per


def _block_flops(cfg, desc, n_q, ctx, decode=False) -> float:
    if desc.mixer == "attn":
        f = _attn_flops(cfg, n_q, ctx, cross=desc.cross_attn)
    elif desc.mixer == "mla":
        f = _mla_flops(cfg, n_q, ctx, decode)
    else:
        f = _mamba_flops(cfg, n_q, decode)
    return f + _mlp_flops(cfg, desc, n_q)


def _stack_flops(cfg: ModelConfig, n_q: float, ctx_self: float,
                 extra_ctx: float = 0.0, decode: bool = False) -> float:
    """All blocks; ctx per attn layer = ctx_self + extra_ctx (prefix)."""
    total = 0.0
    for desc in cfg.layout.descriptors():
        ctx = (ctx_self + extra_ctx) if desc.mixer in ("attn", "mla") else 0.0
        total += _block_flops(cfg, desc, n_q, ctx, decode)
    return total


def _encoder_flops(cfg: ModelConfig, batch: float) -> float:
    if cfg.encoder is None:
        return 0.0
    e = cfg.encoder
    n = batch * e.num_frames
    per = (2 * 4 * cfg.d_model * cfg.d_model  # qkvo
           + 4 * e.num_frames * e.num_heads * (cfg.d_model // e.num_heads)
           + 4 * cfg.d_model * e.d_ff)
    return n * per * e.num_layers


def _xattn_flops(cfg: ModelConfig, n_mem: float, n_src: float) -> float:
    """MemCom compression cross-attention, per layer with a module."""
    d = cfg.d_model
    n_layers = sum(1 for de in cfg.layout.descriptors()
                   if de.mixer in ("attn", "mla"))
    per_layer = (2 * n_mem * d * d  # wq
                 + 2 * 2 * n_src * d * d  # wk, wv over source reps
                 + 2 * n_mem * n_src * d * 2  # scores + AV
                 + 2 * n_mem * d * d)  # wo
    return n_layers * per_layer


def _logits_flops(cfg: ModelConfig, n_q: float) -> float:
    return 2 * n_q * cfg.d_model * cfg.vocab_size


# ---------------------------------------------------------------------------
# HBM byte estimates (global)
# ---------------------------------------------------------------------------


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * BF16


def _active_param_bytes(cfg: ModelConfig) -> float:
    return cfg.active_param_count() * BF16


def _act_bytes(cfg: ModelConfig, tokens: float, passes: float) -> float:
    # residual stream + a few intermediates per layer, read+write
    C = 6.0
    return tokens * cfg.d_model * cfg.num_layers * BF16 * C * passes


def _kv_bytes_per_token(cfg: ModelConfig) -> float:
    per = 0.0
    for desc in cfg.layout.descriptors():
        if desc.mixer == "attn":
            per += 2 * cfg.num_kv_heads * cfg.hd * BF16
        elif desc.mixer == "mla":
            per += (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * BF16
    return per


def _state_bytes(cfg: ModelConfig, batch: float) -> float:
    if cfg.mamba is None:
        return 0.0
    mb = cfg.mamba
    n_mamba = sum(1 for d in cfg.layout.descriptors() if d.mixer == "mamba")
    per = mb.nheads(cfg.d_model) * mb.headdim * mb.d_state * 4
    return batch * n_mamba * per


# ---------------------------------------------------------------------------
# Cell-level costs
# ---------------------------------------------------------------------------


def train_split(shape: ShapeSpec) -> tuple[int, int]:
    """source/target split for MemCom training (paper: ~75/25)."""
    t = int(shape.seq_len * 0.75)
    return t, shape.seq_len - t


def memcom_train_cost(cfg: ModelConfig, shape: ShapeSpec, phase: int = 2,
                      split: tuple[int, int] | None = None) -> CellCost:
    """``split``: the (source, target) token counts a run used; None keeps
    ``train_split(shape)``.  ``model_flops`` counts ``shape.seq_len``
    either way."""
    B = shape.global_batch
    T, S = train_split(shape) if split is None else split
    mtok = cfg.memcom.num_memory_tokens

    src_mult = 3.0 if phase == 2 else 1.0  # phase-1: forward-only source
    memstack_mult = 3.0 if phase == 2 else 2.0  # phase-1: grads to mem_tokens
    f_src = src_mult * (B * _stack_flops(cfg, T, T / 2) + _encoder_flops(cfg, B))
    f_mem = memstack_mult * B * _stack_flops(cfg, mtok, mtok / 2)
    f_x = 3.0 * B * _xattn_flops(cfg, mtok, T)
    f_tgt = 2.0 * B * (_stack_flops(cfg, S, S / 2, extra_ctx=mtok)
                       + _logits_flops(cfg, S))
    flops = f_src + f_mem + f_x + f_tgt

    tokens = B * (T + S + mtok)
    trainable = (2 * cfg.param_count() if phase == 2
                 else cfg.memcom.num_memory_tokens * cfg.d_model
                 + 4 * cfg.d_model**2 * cfg.num_layers)
    weights = 3 * _param_bytes(cfg)  # three stacks read (fwd)
    weights += 2 * _param_bytes(cfg)  # bwd re-reads (source+memory or target)
    opt = trainable * (BF16 + 4 * 3 * 2)  # grads + adam mu/nu/master r+w
    hbm = weights + opt + _act_bytes(cfg, tokens, passes=2.0) \
        + 2 * B * S * cfg.vocab_size * BF16
    model_flops = 6 * cfg.active_param_count() * B * shape.seq_len
    return CellCost(flops, hbm, model_flops, {
        "source": f_src, "memory": f_mem, "xattn": f_x, "target": f_tgt,
        "split": (T, S), "phase": phase})


def lm_train_cost(cfg: ModelConfig, shape: ShapeSpec) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    flops = 3.0 * B * (_stack_flops(cfg, S, S / 2) + _logits_flops(cfg, S)
                       ) + 3.0 * _encoder_flops(cfg, B)
    hbm = (3 * _param_bytes(cfg)
           + cfg.param_count() * (BF16 + 4 * 3 * 2)
           + _act_bytes(cfg, B * S, passes=2.0)
           + 2 * B * S * cfg.vocab_size * BF16)
    model_flops = 6 * cfg.active_param_count() * B * S
    return CellCost(flops, hbm, model_flops, {})


def prefill_cost(cfg: ModelConfig, shape: ShapeSpec) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    flops = B * (_stack_flops(cfg, S, S / 2) + _logits_flops(cfg, 1)
                 ) + _encoder_flops(cfg, B)
    hbm = (_param_bytes(cfg) + _act_bytes(cfg, B * S, passes=1.0)
           + B * S * _kv_bytes_per_token(cfg))  # cache write
    model_flops = 2 * cfg.active_param_count() * B * S
    return CellCost(flops, hbm, model_flops, {})


def decode_cost(cfg: ModelConfig, shape: ShapeSpec) -> CellCost:
    B, L = shape.global_batch, shape.seq_len
    flops = B * (_stack_flops(cfg, 1, L, decode=True) + _logits_flops(cfg, 1))
    hbm = (_active_param_bytes(cfg)  # every weight read once per step
           + B * L * _kv_bytes_per_token(cfg)  # cache read
           + _state_bytes(cfg, B)
           + B * cfg.vocab_size * BF16)
    model_flops = 2 * cfg.active_param_count() * B
    return CellCost(flops, hbm, model_flops, {})


def cell_cost(cfg: ModelConfig, shape: ShapeSpec, objective: str) -> CellCost:
    if objective == "memcom_train":
        return memcom_train_cost(cfg, shape)
    if objective == "lm_train":
        return lm_train_cost(cfg, shape)
    if objective == "prefill":
        return prefill_cost(cfg, shape)
    if objective == "decode":
        return decode_cost(cfg, shape)
    raise ValueError(objective)
