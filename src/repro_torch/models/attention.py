"""GQA attention block (``repro/models/attention.py``): prefill, prefill
continuation behind a seated cache, MemCom prefix, static and per-slot
decode, and enc-dec cross-attention (Whisper).

MemCom integration: ``prefix`` carries the layer's compressed memory,
either as hidden states ``{"h": (B, m, D)}`` (K/V derived through this
layer's projections) or as a precomputed compressed KV cache ``{"k": (B,
m, Hkv, hd), "v": ...}``.  Target tokens sit at positions ``m..m+S`` and
see every memory slot (positions ``0..m-1``).

Caches are updated in place (``cache["k"][...] = ...``): the serving engine
keeps one (slots, max_len, Hkv, hd) tensor per layer, or one (num_blocks,
block_size, Hkv, hd) pool per layer addressed through per-slot block
tables (the paged layout), and never copies it.

Under a mesh (:func:`repro_torch.sharding.serving.shard_module`) a layer
whose heads split holds its rank's query and KV heads: the projections are
column slices, every kernel runs on the local heads, and the row-split
``wo`` is summed over the "model" ranks.

Cross-attention (Whisper's decoder, and its encoder's self-attention):
with ``kv_source`` (B, F, D), or a cache holding the cross entries
``{"ck", "cv"}`` (B, F, H, hd), the queries are not roped and attend to
every frame, not causally, all positions 0.  With both, the frames'
K/V are projected and stored into the cache (prefill); with the cache
alone they are read from it (decode, and the engine's prefill, which
has no frames: it reads the zero entries ``init_cross_cache`` made).
With neither, a cross block falls through to the self-attention path
with its own weights, causal from position 0, as the JAX package's does
(its one-shot compress and ``memcom_loss`` without frames).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.param import Init, make
from repro_torch.sharding.serving import matmul_reduce


class Attention(nn.Module):
    tp = None  # this rank's ModelShard where the heads split (shard_module)

    def __init__(self, cfg: ModelConfig, num_heads: int | None = None, *,
                 device, dtype):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.hd
        nh = num_heads or cfg.num_heads
        nkv = num_heads or cfg.num_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.head_counts = (nh, nkv)  # the placement rule's (module_specs)
        make(self, "wq", (d, nh * hd), axes=("embed", "heads"), **kw)
        make(self, "wk", (d, nkv * hd), axes=("embed", "kv_heads"), **kw)
        make(self, "wv", (d, nkv * hd), axes=("embed", "kv_heads"), **kw)
        make(self, "wo", (nh * hd, d), Init(fan_in=nh * hd),
             axes=("heads", "embed"), **kw)
        self.has_bias = cfg.attn_qkv_bias
        if self.has_bias:
            make(self, "bq", (nh * hd,), Init("zeros"), axes=("heads",),
                 **kw)
            make(self, "bk", (nkv * hd,), Init("zeros"),
                 axes=("kv_heads",), **kw)
            make(self, "bv", (nkv * hd,), Init("zeros"),
                 axes=("kv_heads",), **kw)

    def forward(self, x, **kw):
        return apply_attention(self, self.cfg, x, **kw)


def _out(p: Attention, o):
    """The output projection of the (local) heads' attention ``o`` (B, S,
    heads * hd): row-split ``wo`` under a mesh, summed over the ranks."""
    return matmul_reduce(o, p.wo, p.tp)


def _proj(x, w, b, hd):
    y = x @ w
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:-1], -1, hd)


def project_q(p: Attention, cfg: ModelConfig, x, positions):
    q = _proj(x, p.wq, p.bq if p.has_bias else None, cfg.hd)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    return q


def project_kv(p: Attention, cfg: ModelConfig, x, positions):
    """Roped K and V from hidden states — also builds the MemCom compressed
    cache from memory representations (positions 0..m-1)."""
    k = _proj(x, p.wk, p.bk if p.has_bias else None, cfg.hd)
    v = _proj(x, p.wv, p.bv if p.has_bias else None, cfg.hd)
    if cfg.pos_embed == "rope":
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return k, v


def scatter_rows(cache, new, starts, valid=None):
    """Write ``new[b]`` into ``cache[b]`` at per-slot offsets ``starts[b]``
    along the sequence axis, in place; returns ``cache``.  The write needs
    no device sync.

    Without ``valid`` each start is clamped so that the whole window fits,
    as ``jax.lax.dynamic_update_slice`` does.  ``valid`` (B,) int (the
    fused step's ragged lanes) writes only lanes ``s < valid[b]`` whose
    row is below the stripe's end, unclamped: the clamp would shift a
    window whose padding lanes cross the end back over valid rows.  The
    written lanes are a prefix of each slot's; every other lane writes
    the last written lane's row again with the same value (or, in a slot
    with none, one row's own value back), so the dropped lanes change
    nothing whatever order the device runs the writes in."""
    B, S = new.shape[:2]
    L = cache.shape[1]
    lane = torch.arange(S, device=new.device)
    rows = torch.arange(B, device=new.device)[:, None].expand(B, S)
    if valid is None:
        start = starts.to(torch.long).clamp(0, L - S)
        cache[rows, start[:, None] + lane[None, :]] = new.to(cache.dtype)
        return cache
    start = starts.to(torch.long)
    n_ok = torch.minimum(valid.to(torch.long), L - start).clamp(0, S)
    src = torch.minimum(lane[None, :], (n_ok - 1)[:, None])  # (B, S)
    dest = torch.where(n_ok[:, None] > 0, start[:, None] + src,
                       start.clamp(0, L - 1)[:, None])
    vals = torch.where(
        (n_ok > 0).view(B, 1, *([1] * (new.dim() - 2))),
        new.gather(1, src.clamp(min=0).view(B, S, *([1] * (new.dim() - 2)))
                   .expand(new.shape)).to(cache.dtype),
        cache[rows, dest])
    cache[rows, dest] = vals
    return cache


def prefix_positions(cfg: ModelConfig, B: int, m: int, device):
    """The m memory slots' positions 0..m-1: (B, m), or (3, B, m) equal
    streams under M-RoPE."""
    pos = torch.arange(m, dtype=torch.int32, device=device).expand(B, m)
    return pos.expand(3, B, m) if cfg.mrope_sections else pos


def _prefix_kv(p: Attention, cfg: ModelConfig, prefix: dict):
    if "k" in prefix:
        return prefix["k"], prefix["v"]
    h = prefix["h"]
    return project_kv(p, cfg, h,
                      prefix_positions(cfg, h.shape[0], h.shape[1], h.device))


def _cross_attention(p: Attention, cfg: ModelConfig, x, kv_source, cache):
    """Enc-dec attention: unroped queries over every frame of
    ``kv_source`` or of the cache's ``ck`` / ``cv``, not causal.  With
    both, the frames' K/V are written into the cache: in place where the
    cache holds as many frames, else the entries are rebound to the new
    ones (the JAX package's cache takes the frames' length)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = _proj(x, p.wq, p.bq if p.has_bias else None, hd)
    if kv_source is not None:
        k = _proj(kv_source, p.wk, p.bk if p.has_bias else None, hd)
        v = _proj(kv_source, p.wv, p.bv if p.has_bias else None, hd)
    if cache is not None:
        if kv_source is not None:
            for key, t in (("ck", k), ("cv", v)):
                if cache[key].shape == t.shape:
                    cache[key].copy_(t)
                else:
                    cache[key] = t.to(cache[key].dtype)
        k, v = cache["ck"], cache["cv"]
    F = k.shape[1]
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((B, F), dtype=torch.int32, device=x.device)
    out = ops.attention(q, k.to(q.dtype), v.to(q.dtype), q_pos=q_pos,
                        kv_pos=kv_pos, causal=False,
                        softcap=cfg.attn_logit_softcap, scale=hd ** -0.5)
    return _out(p, out.reshape(B, S, -1)), cache


def apply_attention(
    p: Attention,
    cfg: ModelConfig,
    x,
    *,
    positions,
    mask_offset=0,
    prefix: Optional[dict] = None,
    cache: Optional[dict] = None,
    cache_index=None,
    decode: bool = False,
    kv_source=None,
    block_tables=None,
    lane_valid=None,
):
    """Returns (out (B,S,D), cache_or_None).  ``cache_index`` is a python
    int (static offset) or a (B,) tensor (per-slot lengths, decode).

    With ``block_tables`` (B, nb) int32 the cache is *paged*: ``k``/``v``
    are shared (num_blocks, block_size, Hkv, hd) pools and slot ``b``'s
    position ``p`` lives at ``(block_tables[b, p // bs], p % bs)``.  Decode
    needs the per-slot length vector; prefill continues behind the seated
    blocks (static ``cache_index`` base, as in the dense path).

    Per-slot decode writes every lane, as the reference's classic step
    does: slot ``b``'s rows land at ``cache_index[b]`` (dense: clamped into
    the stripe; paged: through its block table, column clamped).
    ``lane_valid`` (B,) int (the fused serving step) marks how many of the
    S lanes carry tokens in each slot: the other lanes' K/V writes are
    dropped (dense) or routed to the trash block (paged).  The read needs
    no mask: lane ``s`` of slot ``b`` queries position ``cache_index[b] +
    s``, and causality hides every row an invalid lane could have
    written.

    ``kv_source`` (B, F, D), or a cache with ``ck`` / ``cv``, makes the
    call a cross-attention (the module's docstring)."""
    if kv_source is not None or (cache is not None and "ck" in cache):
        return _cross_attention(p, cfg, x, kv_source, cache)
    B, S, _ = x.shape
    softcap = cfg.attn_logit_softcap
    scale = cfg.hd ** -0.5
    q = project_q(p, cfg, x, positions)

    # ---------------- decode: read/write KV cache ----------------
    if decode:
        if cache is None or cache_index is None:
            raise ValueError("decode needs a cache and a cache_index")
        k_new, v_new = project_kv(p, cfg, x, positions)
        if block_tables is not None:
            # paged: scatter the new tokens into each slot's tail block,
            # then walk the block tables (shared prefix blocks are read by
            # every slot seated on the task but stored once)
            if not (torch.is_tensor(cache_index) and cache_index.dim() == 1):
                raise ValueError("paged decode needs (slots,) lengths")
            ops.paged_scatter((cache["k"], cache["v"]), (k_new, v_new),
                              block_tables, cache_index, valid=lane_valid)
            out = ops.paged_decode_attention(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                block_tables=block_tables, lengths=cache_index + S,
                softcap=softcap, scale=scale)
            return _out(p, out.reshape(B, S, -1)), cache
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            # per-slot lengths (continuous batching): each slot writes at
            # its own offset and is masked to its own seated region only
            scatter_rows(cache["k"], k_new, cache_index, valid=lane_valid)
            scatter_rows(cache["v"], v_new, cache_index, valid=lane_valid)
            out = ops.decode_attention(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                lengths=cache_index + S, softcap=softcap, scale=scale)
            return _out(p, out.reshape(B, S, -1)), cache
        # static start (a chunk of a chunked compress): write the rows,
        # then one causal call over the keys [0, start + S) they can see,
        # unsplit, so that each row walks its keys as in the one-shot call
        start = int(cache_index)
        end = start + S
        cache["k"][:, start:end] = k_new.to(cache["k"].dtype)
        cache["v"][:, start:end] = v_new.to(cache["v"].dtype)
        kv_pos = torch.arange(end, dtype=torch.int32,
                              device=x.device).expand(B, end)
        out = ops.attention(q, cache["k"][:, :end].to(q.dtype),
                            cache["v"][:, :end].to(q.dtype),
                            q_pos=kv_pos[:, start:], kv_pos=kv_pos,
                            causal=True, softcap=softcap, scale=scale,
                            variant="unsplit")
        return _out(p, out.reshape(B, S, -1)), cache

    # ---------------- train / prefill: full self-attention ----------------
    k, v = project_kv(p, cfg, x, positions)
    if (prefix is None and cache is not None
            and isinstance(cache_index, int) and cache_index > 0):
        # prefill continuation: slots [0, cache_index) are already seated
        # (compressed memory or an earlier prefill segment) — attend to
        # them as a fully-visible prefix.  Static start only.
        if block_tables is not None:
            bs = cache["k"].shape[1]
            blk = block_tables[:, :-(-cache_index // bs)]  # covers the base
            prefix = {key: ops.paged_gather(cache[key], blk)[:, :cache_index]
                      .to(x.dtype) for key in ("k", "v")}
        else:
            prefix = {"k": cache["k"][:, :cache_index].to(x.dtype),
                      "v": cache["v"][:, :cache_index].to(x.dtype)}
    if prefix is not None:
        k_pre, v_pre = _prefix_kv(p, cfg, prefix)
        m = k_pre.shape[1]
        out = ops.attention_with_prefix(
            q, k, v, k_pre.to(q.dtype), v_pre.to(q.dtype),
            offset=mask_offset if mask_offset else m,
            softcap=softcap, scale=scale)
    else:
        out = ops.self_attention_causal(q, k, v, offset=mask_offset,
                                        softcap=softcap, scale=scale)
    if cache is not None:  # prefill writes the cache
        start = cache_index if cache_index is not None else 0
        if block_tables is not None:
            starts = torch.full((B,), start, dtype=torch.int32,
                                device=x.device)
            ops.paged_scatter((cache["k"], cache["v"]), (k, v),
                              block_tables, starts)
        else:
            cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
            cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
    return _out(p, out.reshape(B, S, -1)), cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_attn_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                          dtype, device) -> dict:
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cross_cache(cfg: ModelConfig, batch: int, num_frames: int, dtype,
                     device) -> dict:
    """Per-slot cross-attention K/V over the encoder's frames, zero until a
    prefill with encoder output writes them (both layouts keep them per
    slot: a fixed size that paging would not shrink)."""
    shape = (batch, num_frames, cfg.num_heads, cfg.hd)
    return {"ck": torch.zeros(shape, dtype=dtype, device=device),
            "cv": torch.zeros(shape, dtype=dtype, device=device)}
