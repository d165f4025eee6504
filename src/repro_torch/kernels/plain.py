"""Plain PyTorch versions of the port's kernels.

They are the CPU path (a kernel wrapper given a CPU tensor calls them) and
the yardstick the CUDA kernels are held against on the card.  Each mirrors
an oracle of the JAX package (``repro/kernels/ref.py`` and
``jnp_impl.combine_attention_partials``) and computes in float32
internally, casting the result to the input's type at the end — the same
arithmetic the kernels do, so a bf16 comparison measures the kernel and
not a different rounding schedule.

The paged-KV index ops (``paged_scatter``/``paged_gather``, after
``jnp_impl.py:254-292``) have no kernel: every device runs them as
written here.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, q_pos, kv_pos, causal=True, softcap=0.0,
                  scale=None, return_lse=False):
    """Dense GQA attention with position-derived masking (``ref.py:14``).

    q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv), q_pos (B,Sq),
    kv_pos (B,Skv) (-1 marks an invalid slot) -> out (B,Sq,Hq,Dv) [, lse
    (B,Sq,Hq) float32].  A query row that sees no valid key gets output 0
    and lse -1e30."""
    B, Sq, Hq, Dk = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = Dk ** -0.5
    qh = q.float().reshape(B, Sq, Hkv, G, Dk)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qh, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    valid = (kv_pos[:, None, :] >= 0)  # (B, 1, Skv)
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    else:
        valid = valid.expand(B, Sq, Skv)
    valid = valid[:, None, None]  # (B,1,1,Sq,Skv)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m) * valid
    s = e.sum(dim=-1, keepdim=True)
    any_valid = s > 0
    p = torch.where(any_valid, e / torch.clamp(s, min=1e-37),
                    torch.zeros_like(e))
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(any_valid, m + torch.log(torch.clamp(s, min=1e-37)),
                      torch.full_like(m, NEG_INF))[..., 0]  # (B,Hkv,G,Sq)
    return out, lse.permute(0, 3, 1, 2).reshape(B, Sq, Hq)


def memcom_xattn_ref(q, k, v, *, scale=None):
    """The paper's 1-head cross-attention (``ref.py:50``): m memory queries
    over t source tokens, head width = d_model, no mask."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    logits = torch.einsum("bmd,btd->bmt", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bmt,btd->bmd", p, v.float()).to(q.dtype)


def paged_scatter(pool, new, block_tables, starts, valid=None):
    """Write ``new[b, s]`` into the block pool at logical position
    ``starts[b] + s`` of slot ``b``, in place; returns ``pool``.

    pool (N, bs, ...), new (B, S, ...), block_tables (B, nb) int, starts
    (B,) int.  Position ``p`` of slot ``b`` lives at ``(block_tables[b,
    p // bs], p % bs)``, so one write may straddle blocks that are not
    adjacent in the pool.  ``valid`` (B,) (optional): only lanes ``s <
    valid[b]`` are real; the others are routed to block 0, the
    allocator's trash block, and can never touch an allocated block.
    The table column is clamped to the table's width (JAX's gather clamps
    an out-of-range column the same way; torch would raise), so a lane
    past the table end writes through the last column — with ``valid``
    such a lane is a padding lane and lands in block 0.  Duplicate
    writes to block 0 race harmlessly: nothing reads it."""
    bs = pool.shape[1]
    B, S = new.shape[:2]
    lane = torch.arange(S, device=new.device)
    pos = starts.to(torch.long)[:, None] + lane[None, :]  # (B, S)
    col = pos.div(bs, rounding_mode="floor").clamp(0, block_tables.shape[1] - 1)
    blk = torch.gather(block_tables.to(torch.long), 1, col)
    if valid is not None:
        blk = torch.where(lane[None, :] < valid.to(torch.long)[:, None], blk,
                          torch.zeros_like(blk))
    pool[blk, pos % bs] = new.to(pool.dtype)
    return pool


def paged_gather(pool, block_tables):
    """Each slot's logical cache view: (N, bs, ...) x (B, nb) -> (B, nb*bs,
    ...)."""
    B, nb = block_tables.shape
    view = pool[block_tables.to(torch.long)]  # (B, nb, bs, ...)
    return view.reshape(B, nb * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_ref(q, k_pool, v_pool, *, block_tables, lengths,
                               softcap=0.0, scale=None):
    """Decode attention through block tables (``jnp_impl.py:295``
    ``paged_decode_attention_lengths``): q (B,S,Hq,D) holds each slot's
    last S query rows; pools (N,bs,Hkv,D); block_tables (B,nb); lengths
    (B,) each slot's valid length including the S new rows.  Row ``r`` of
    slot ``b`` sits at position ``lengths[b] - S + r`` and sees the
    positions at or before it (logical block ``j`` is pool block
    ``block_tables[b, j]``); a row that sees no key gives 0."""
    B, S = q.shape[:2]
    k = paged_gather(k_pool, block_tables)
    v = paged_gather(v_pool, block_tables)
    L = k.shape[1]
    kv_pos = torch.arange(L, dtype=torch.int32, device=q.device).expand(B, L)
    q_pos = (lengths.to(torch.int32)[:, None] - S
             + torch.arange(S, dtype=torch.int32, device=q.device)[None, :])
    return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                         softcap=softcap, scale=scale)


def combine_attention_partials(parts):
    """Exact merge of attention computed over disjoint KV sets
    (``jnp_impl.py:353``): parts are (out (B,S,H,Dv), lse (B,S,H))."""
    lses = torch.stack([p[1] for p in parts])
    outs = torch.stack([p[0] for p in parts])
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    w = w / torch.clamp(w.sum(dim=0), min=1e-37)
    out = (outs.float() * w[..., None]).sum(dim=0)
    return out.to(parts[0][0].dtype)


def scaled_err(out, ref) -> float:
    """Largest ``|out - ref| / (|ref| + rms of ref's row)`` over the
    elements, a row being the last axis: the error of a kernel's result
    in units of the reference's own scale, so that a small output (a mean
    of V over thousands of keys) is held as tightly as a large one.  A row
    whose reference is all 0 (a query that sees no key) must be 0 exactly
    (the result is inf otherwise)."""
    ref = ref.float()
    d = (out.float() - ref).abs()
    scale = ref.abs() + ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    ratio = torch.where(scale > 0, d / scale.clamp(min=1e-37),
                        torch.where(d > 0, torch.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0
