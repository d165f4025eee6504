"""Multi-head Latent Attention, DeepSeek-V2 (``repro/models/mla.py``).

Train / prefill run the non-absorbed form: the latent ``ckv`` (kv_lora
wide, RMS-normed) and one shared RoPE'd key ``kr`` are expanded through
``wukv`` into per-head keys of width qk_nope + qk_rope and values of width
v_head_dim, so the flash kernel sees a key width (192 at full width)
other than the value width (128).  Decode runs the *absorbed* form: the
queries are folded through W_uk, and the step is MQA with one shared KV
head whose key is ``[ckv | kr]`` (kv_lora + rope = 576 wide) and whose
value is ``ckv`` (kv_lora = 512 wide); the scale stays
``qk_head_dim ** -0.5`` of the non-absorbed form.  The cache holds the
latents only, ``{"ckv": (.., kv_lora), "kr": (.., rope)}``: a dense
(slots, max_len, ..) stripe or a (num_blocks, block_size, ..) pool
addressed through block tables, written in place.

MemCom: a prefix ``{"h": O^i}`` is pushed through this layer's ``_latent``
(positions 0..m-1), so the compressed cache is itself a latent cache; a
prefix ``{"ckv", "kr"}`` is one already materialized.

As in the reference, the absorbed decode concatenates ``ckv`` and ``kr``
into the key over the whole cache (or pool) every step; reading the two
parts separately inside the kernel would remove that copy.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import scatter_rows
from repro_torch.models.layers import apply_rope
from repro_torch.models.param import Init, make


class MLA(nn.Module):
    """Parameters ``wdq``, ``q_norm``, ``wuq``, ``wdkv``, ``kv_norm``,
    ``wukv``, ``wo``: the names and shapes of the JAX tree."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, nh = cfg.d_model, cfg.num_heads
        kw = dict(device=device, dtype=dtype)
        make(self, "wdq", (d, m.q_lora_rank), axes=("embed", "mla_lora"),
             **kw)
        make(self, "q_norm", (m.q_lora_rank,), Init("ones"),
             axes=("mla_lora",), **kw)
        make(self, "wuq", (m.q_lora_rank, nh * m.qk_head_dim),
             axes=("mla_lora", "heads"), **kw)
        make(self, "wdkv", (d, m.kv_lora_rank + m.qk_rope_head_dim),
             axes=("embed", "mla_lora"), **kw)
        make(self, "kv_norm", (m.kv_lora_rank,), Init("ones"),
             axes=("mla_lora",), **kw)
        make(self, "wukv", (m.kv_lora_rank,
                            nh * (m.qk_nope_head_dim + m.v_head_dim)),
             axes=("mla_lora", "heads"), **kw)
        make(self, "wo", (nh * m.v_head_dim, d),
             Init(fan_in=nh * m.v_head_dim), axes=("heads", "embed"), **kw)

    def forward(self, x, **kw):
        return apply_mla(self, self.cfg, x, **kw)


def _rms(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def latent(p: MLA, cfg: ModelConfig, x, positions):
    """x (B, S, D) -> (ckv (B, S, kv_lora), kr (B, S, rope)): the MLA cache
    entries (``_latent`` of the reference, its k_rope's head axis
    dropped)."""
    m = cfg.mla
    ckv, kr = (x @ p.wdkv).split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = _rms(ckv, p.kv_norm, cfg.norm_eps)
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _queries(p: MLA, cfg: ModelConfig, x, positions):
    m = cfg.mla
    cq = _rms(x @ p.wdq, p.q_norm, cfg.norm_eps)
    q = (cq @ p.wuq).reshape(*x.shape[:-1], cfg.num_heads, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _expand_kv(p: MLA, cfg: ModelConfig, ckv, kr):
    """Latents -> per-head keys (B, S, nh, qk_head_dim) and values (B, S,
    nh, v_head_dim); the shared rope key is broadcast to every head."""
    m = cfg.mla
    nh = cfg.num_heads
    kv = (ckv @ p.wukv).reshape(*ckv.shape[:-1], nh,
                                m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim).to(k_nope.dtype)], -1)
    return k, v


def _wukv(p: MLA, cfg: ModelConfig):
    m = cfg.mla
    return p.wukv.reshape(m.kv_lora_rank, cfg.num_heads,
                          m.qk_nope_head_dim + m.v_head_dim)


def apply_mla(
    p: MLA,
    cfg: ModelConfig,
    x,
    *,
    positions,
    mask_offset=0,
    prefix: Optional[dict] = None,
    cache: Optional[dict] = None,
    cache_index=None,
    decode: bool = False,
    block_tables=None,
    lane_valid=None,
):
    """Returns (out (B, S, D), cache_or_None); the arguments mean what they
    mean for :func:`repro_torch.models.attention.apply_attention`.  With
    ``block_tables`` the latents are pooled; ``lane_valid`` (per-slot
    decode) drops the ragged lanes' latent writes (dense) or routes them
    to the trash block (paged)."""
    m = cfg.mla
    B, S, _ = x.shape
    scale = m.qk_head_dim ** -0.5
    q_nope, q_rope = _queries(p, cfg, x, positions)

    if decode:  # ---------------- absorbed decode ----------------
        if cache is None or cache_index is None:
            raise ValueError("decode needs a cache and a cache_index")
        ckv_new, kr_new = latent(p, cfg, x, positions)
        per_slot = torch.is_tensor(cache_index) and cache_index.dim() == 1
        if block_tables is not None:
            if not per_slot:
                raise ValueError("paged decode needs (slots,) lengths")
            ops.paged_scatter((cache["ckv"], cache["kr"]), (ckv_new, kr_new),
                              block_tables, cache_index, valid=lane_valid)
        elif per_slot:
            scatter_rows(cache["ckv"], ckv_new, cache_index, valid=lane_valid)
            scatter_rows(cache["kr"], kr_new, cache_index, valid=lane_valid)
        else:
            start = int(cache_index)
            cache["ckv"][:, start:start + S] = ckv_new.to(cache["ckv"].dtype)
            cache["kr"][:, start:start + S] = kr_new.to(cache["kr"].dtype)
        wukv = _wukv(p, cfg)
        # fold q through W_uk: q_abs[b, s, h, r] = q_nope[b, s, h] . wuk[r, h]
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope,
                             wukv[:, :, :m.qk_nope_head_dim])
        q_eff = torch.cat([q_abs, q_rope], -1)  # (B, S, nh, kv_lora + rope)
        # MQA over one shared latent head (dense: axis 1 = positions; paged:
        # the whole pool, as the reference concatenates it)
        k_eff = torch.cat([cache["ckv"], cache["kr"]], -1)[:, :, None] \
            .to(q_eff.dtype)
        v_eff = cache["ckv"][:, :, None].to(q_eff.dtype)
        if block_tables is not None:
            o_lat = ops.paged_decode_attention(
                q_eff, k_eff, v_eff, block_tables=block_tables,
                lengths=cache_index + S, scale=scale)
        elif per_slot:
            o_lat = ops.decode_attention(q_eff, k_eff, v_eff,
                                         lengths=cache_index + S, scale=scale)
        else:
            L = k_eff.shape[1]
            slot = torch.arange(L, dtype=torch.int32, device=x.device)
            kv_pos = torch.where(slot < start + S, slot, -1).expand(B, L)
            q_pos = (start + torch.arange(S, dtype=torch.int32,
                                          device=x.device)).expand(B, S)
            o_lat = ops.attention(q_eff, k_eff, v_eff, q_pos=q_pos,
                                  kv_pos=kv_pos, causal=True, scale=scale)
        out = torch.einsum("bshr,rhd->bshd", o_lat,
                           wukv[:, :, m.qk_nope_head_dim:])
        return out.reshape(B, S, -1) @ p.wo, cache

    # ---------------- train / prefill: non-absorbed ----------------
    if (prefix is None and cache is not None
            and isinstance(cache_index, int) and cache_index > 0):
        # prefill continuation over already seated latent slots
        if block_tables is not None:
            bs = cache["ckv"].shape[1]
            blk = block_tables[:, :-(-cache_index // bs)]
            prefix = {key: ops.paged_gather(cache[key], blk)[:, :cache_index]
                      for key in ("ckv", "kr")}
        else:
            prefix = {key: cache[key][:, :cache_index]
                      for key in ("ckv", "kr")}
    ckv, kr = latent(p, cfg, x, positions)
    k, v = _expand_kv(p, cfg, ckv, kr)
    q = torch.cat([q_nope, q_rope], -1)
    if prefix is not None:
        if "ckv" in prefix:
            ckv_pre, kr_pre = prefix["ckv"], prefix["kr"]
        else:  # the latent prefix from the compressed memory O^i
            h = prefix["h"]
            mlen = h.shape[1]
            pos = torch.arange(mlen, dtype=torch.int32,
                               device=h.device).expand(B, mlen)
            ckv_pre, kr_pre = latent(p, cfg, h, pos)
        k_pre, v_pre = _expand_kv(p, cfg, ckv_pre.to(x.dtype),
                                  kr_pre.to(x.dtype))
        mlen = ckv_pre.shape[1]
        out = ops.attention_with_prefix(
            q, k, v, k_pre.to(q.dtype), v_pre.to(q.dtype),
            offset=mask_offset if mask_offset else mlen, scale=scale)
    else:
        out = ops.self_attention_causal(q, k, v, offset=mask_offset,
                                        scale=scale)
    if cache is not None:  # prefill writes the latents
        start = cache_index if cache_index is not None else 0
        if block_tables is not None:
            starts = torch.full((B,), start, dtype=torch.int32,
                                device=x.device)
            ops.paged_scatter((cache["ckv"], cache["kr"]), (ckv, kr),
                              block_tables, starts)
        else:
            cache["ckv"][:, start:start + S] = ckv.to(cache["ckv"].dtype)
            cache["kr"][:, start:start + S] = kr.to(cache["kr"].dtype)
    return out.reshape(B, S, -1) @ p.wo, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def init_paged_mla_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                         dtype, device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((num_blocks, block_size, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((num_blocks, block_size, m.qk_rope_head_dim),
                              dtype=dtype, device=device)}
