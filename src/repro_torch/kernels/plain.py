"""Plain PyTorch versions of the port's kernels.

They are the CPU path (a kernel wrapper given a CPU tensor calls them) and
the yardstick the CUDA kernels are held against on the card.  Each mirrors
an oracle of the JAX package (``repro/kernels/ref.py``,
``jnp_impl.combine_attention_partials`` and ``jnp_impl.ssd_chunked``) and
computes in float32
internally, casting the result to the input's type at the end — the same
arithmetic the kernels do, so a bf16 comparison measures the kernel and
not a different rounding schedule.

``ssd_chunk_parallel``, ``ssd_bwd_chunked``, ``paged_decode_split_ref``,
``memcom_xattn_tiled`` and ``attention_bwd_tiled`` are no kernel's CPU
path: they restate the chunked Hopper ``ssd`` kernel's three phases, order
and rounding points, the ``ssd`` backward kernel's two walks and chunk
products, the paged decode kernel's split of each slot's positions, the
wgmma ``memcom_xattn`` variant's per-tile softmax and the wgmma flash
backward's tiles and rounding points, for the tests.

The paged-KV index ops (``paged_scatter``/``paged_gather``, after
``jnp_impl.py:254-292``) and the Mamba2 one-token update
``ssd_decode_step`` (``jnp_impl.py:426-441``) have no kernel: every device
runs them as written here.
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


def attention_bwd_ref(q, k, v, out, lse, dout, dlse=None, *, q_pos, kv_pos,
                      causal=True, softcap=0.0, scale=None):
    """The gradient of :func:`attention_ref` (with its lse) by explicit
    formulas, not autograd: the yardstick of the backward kernel.

    q (B,Sq,Hq,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), out/dout
    (B,Sq,Hq,Dv), lse/dlse (B,Sq,Hq) float32 (``dlse`` None: no lse cotangent) -> dq, dk, dv in
    the inputs' types.  With x = scale q.k and s = cap tanh(x / cap) (s =
    x without a cap), P = exp(s - lse) on the visible pairs (0 elsewhere),
    dP = dO V^T, D_i = rowsum(dO o O) - dlse_i, dS = P o (dP - D_i), dX =
    dS o (1 - (s / cap)^2); dq = scale dX K, dk = scale dX^T Q and dv =
    P^T dO, dk and dv summed over each group of G = Hq / Hkv query heads.
    A row that sees no key (lse -1e30) has P = 0 and gets no gradient."""
    B, Sq, Hq, Dk = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = Dk ** -0.5
    qh = q.float().reshape(B, Sq, Hkv, G, Dk)
    doh = dout.float().reshape(B, Sq, Hkv, G, -1)
    x = torch.einsum("bqhgd,bshd->bhgqs", qh, k.float()) * scale
    s = softcap * torch.tanh(x / softcap) if softcap else x
    valid = kv_pos[:, None, :] >= 0
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    else:
        valid = valid.expand(B, Sq, Skv)
    valid = valid[:, None, None]                       # (B,1,1,Sq,Skv)
    lse_h = lse.float().reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    p = torch.where(valid, torch.exp(s - lse_h), torch.zeros_like(s))
    dp = torch.einsum("bqhgd,bshd->bhgqs", doh, v.float())
    d_i = (dout.float() * out.float()).sum(-1)        # (B,Sq,Hq)
    if dlse is not None:
        d_i = d_i - dlse.float()
    d_i = d_i.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - d_i)
    if softcap:
        ds = ds * (1 - (s / softcap) ** 2)
    dq = torch.einsum("bhgqs,bshd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqs,bqhgd->bshd", ds, qh) * scale
    dv = torch.einsum("bhgqs,bqhgd->bshd", p, doh)
    return (dq.reshape(B, Sq, Hq, Dk).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_bwd_tiled(q, k, v, out, lse, dout, dlse=None, *, q_pos,
                        kv_pos, causal=True, softcap=0.0, scale=None,
                        round_p=True, split_at=None, tile=64):
    """The wgmma flash backward's arithmetic (``flash_bwd_wgmma`` in
    ``csrc/flash_attention_bwd.cu``), restated for the tests; no kernel's
    CPU path.  Arguments and result as :func:`attention_bwd_ref` (v, out
    and dout may be Dv wide, Dv != D).

    The query rows of each KV head are G-folded (row rho = s * G + g is
    query s of head hk * G + g) and cut into ``tile``-row tiles, the kv
    rows too (rows past the end are zero, and see nothing).  A tile pair
    with no visible pair is skipped (the kernels' ``tile_class``): it adds
    nothing.  dK and dV: for each KV tile, the query tiles in order, S^T
    and dP^T in float32, P^T = exp(s - lse) on the visible pairs and dS^T
    = P^T o (dP^T - D) o (1 - (s / cap)^2) from the unrounded P^T, both
    rounded to bf16 when ``round_p`` before dV += P^T dO and dK += dS^T Q
    (float32 sums, one tile after another).  ``split_at`` (one entry per
    KV tile, or None) cuts a KV tile's walk in two: the query tiles below
    its entry and the rest are summed apart, then added.  dQ: for each
    query tile, the KV tiles in order, dS likewise, dQ += dS K.  dK and dQ
    times scale at the end; out in the inputs' types."""
    import torch.nn.functional as F

    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    rows = Sq * G
    if scale is None:
        scale = D ** -0.5
    nq, nkv = -(-rows // tile), -(-Skv // tile)
    Rp, Kp = nq * tile, nkv * tile

    def fold(x, value=0.0):  # (B, Sq, Hq[, D]) -> (B, Hkv, Rp[, D])
        x = x.float().reshape(B, Sq, Hkv, G, -1).permute(0, 2, 1, 3, 4)
        x = x.reshape(B, Hkv, rows, -1)
        return F.pad(x, (0, 0, 0, Rp - rows), value=value)

    def heads(x):  # (B, Skv, Hkv, D) -> (B, Hkv, Kp, D)
        return F.pad(x.float().permute(0, 2, 1, 3), (0, 0, 0, Kp - Skv))

    qf, dof, kf, vf = fold(q), fold(dout), heads(k), heads(v)
    d_i = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        d_i = d_i - dlse.float()
    lse_f = fold(lse[..., None], value=-NEG_INF)[..., 0]  # past the end: P 0
    di_f = fold(d_i[..., None])[..., 0]
    ar = torch.arange(Rp, device=q.device)
    qp = q_pos[:, torch.clamp(ar, max=rows - 1) // G]       # (B, Rp)
    kvp = F.pad(kv_pos, (0, Kp - Skv), value=-1)           # (B, Kp)
    vis = (kvp[:, None, :] >= 0) & (ar < rows)[None, :, None]
    if causal:
        vis = vis & (kvp[:, None, :] <= qp[:, :, None])    # (B, Rp, Kp)
    live = vis.reshape(B, nq, tile, nkv, tile).any(dim=4).any(dim=2)

    def p_ds(s_raw, dp, l_rows, d_rows, seen):
        x = s_raw * scale
        f = 1.0
        if softcap:
            th = torch.tanh(x / softcap)
            x, f = softcap * th, 1 - th * th
        p = torch.where(seen, torch.exp(x - l_rows), torch.zeros_like(x))
        ds = p * (dp - d_rows) * f
        if round_p:
            p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
        return p, ds

    # the two halves of every KV tile's walk: [0, split_at) and the rest
    half = torch.arange(nq)[:, None] < torch.tensor(
        split_at if split_at is not None else [nq] * nkv)[None, :]
    half = half.repeat_interleave(tile, dim=1).to(q.device)  # (nq, Kp)
    dk = torch.zeros(2, B, Hkv, Kp, D, device=q.device)
    dv = torch.zeros(2, B, Hkv, Kp, v.shape[-1], device=q.device)
    for u in range(nq):  # KV blocks: this query tile against every KV tile
        r = slice(u * tile, (u + 1) * tile)
        p, ds = p_ds(kf @ qf[:, :, r].transpose(-1, -2),
                     vf @ dof[:, :, r].transpose(-1, -2),
                     lse_f[:, :, None, r], di_f[:, :, None, r],
                     vis[:, None, r].transpose(-1, -2))
        keep = live[:, u].repeat_interleave(tile, dim=1)[:, None, :, None]
        h = torch.stack([half[u], ~half[u]])[:, None, None, :, None]
        dv = torch.where(keep & h, dv + p @ dof[:, :, r], dv)
        dk = torch.where(keep & h, dk + ds @ qf[:, :, r], dk)
    dk, dv = dk[0] + dk[1], dv[0] + dv[1]
    dq = torch.zeros(B, Hkv, Rp, D, device=q.device)
    for t in range(nkv):  # Q blocks: this KV tile against every query tile
        c = slice(t * tile, (t + 1) * tile)
        _, ds = p_ds(qf @ kf[:, :, c].transpose(-1, -2),
                     dof @ vf[:, :, c].transpose(-1, -2),
                     lse_f[..., None], di_f[..., None], vis[:, None, :, c])
        keep = live[:, :, t].repeat_interleave(tile, dim=1)[:, None, :, None]
        dq = torch.where(keep, dq + ds @ kf[:, :, c], dq)
    dq = (dq[:, :, :rows] * scale).reshape(B, Hkv, Sq, G, D)
    dq = dq.permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, D)
    dk = (dk[:, :, :Skv] * scale).permute(0, 2, 1, 3)
    dv = dv[:, :, :Skv].permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def memcom_xattn_ref(q, k, v, *, scale=None, return_lse=False):
    """The paper's 1-head cross-attention (``ref.py:50``): m memory queries
    over t source tokens, head width = d_model, no mask.  ``return_lse``:
    also each row's logsumexp of the float32 logits, (B, M) float32."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    logits = torch.einsum("bmd,btd->bmt", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bmt,btd->bmd", p, v.float()).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def memcom_xattn_bwd_ref(q, k, v, dout, *, scale=None):
    """The gradient of :func:`memcom_xattn_ref` by explicit formulas: P =
    softmax(scale Q K^T), dP = dO V^T, dS = P o (dP - rowsum(P o dP)), dQ
    = scale dS K, dK = scale dS^T Q, dV = P^T dO; float32 inside, the
    inputs' types out.  The yardstick of the backward kernel."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.softmax(torch.einsum("bmd,btd->bmt", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bmd,btd->bmt", dof, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bmt,btd->bmd", ds, kf) * scale
    dk = torch.einsum("bmt,bmd->btd", ds, qf) * scale
    dv = torch.einsum("bmt,bmd->btd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def memcom_xattn_bwd_tiled(q, k, v, out, lse, dout, *, round_p=True,
                           splits=1, scale=None):
    """The wgmma ``memcom_xattn`` backward's arithmetic (``csrc/
    memcom_xattn.cu``), restated for the tests; no kernel's CPU path.

    D_i = rowsum(dO o O) in float32 from the given ``out`` (the forward's
    output).  S = scale Q K^T and dP = dO V^T in float32; P = exp(S -
    lse) from the given ``lse`` and dS = P o (dP - D_i), both from the
    unrounded float32 values, then rounded to bf16 when ``round_p`` (the
    S / dP kernel stores them in bf16).  dQ = scale dS K summed in float32
    as ``splits`` stretches of whole 64-column slabs of T (ceil(slabs /
    splits) slabs each), added in split order; dK = scale dS^T Q and dV =
    P^T dO summed over M in float32.  The tile width of S and dP does not
    enter: every element of P comes from lse alone.  Gradients in q's
    type."""
    B, M, D = q.shape
    T = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    di = (dof * out.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bmd,btd->bmt", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    ds = p * (torch.einsum("bmd,btd->bmt", dof, vf) - di)
    if round_p:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    nk = -(-T // 64)
    per = -(-nk // splits)
    dq = torch.zeros(B, M, D, dtype=torch.float32, device=q.device)
    for i in range(splits):
        lo, hi = min(T, i * per * 64), min(T, (i + 1) * per * 64)
        dq = dq + torch.einsum("bmt,btd->bmd", ds[..., lo:hi], kf[:, lo:hi])
    dk = torch.einsum("bmt,bmd->btd", ds, qf) * scale
    dv = torch.einsum("bmt,bmd->btd", p, dof)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def memcom_xattn_tiled(q, k, v, *, block_t=128, round_p=True, splits=1,
                       scale=None, cut=100.0):
    """The wgmma ``memcom_xattn`` variant's arithmetic (``csrc/
    memcom_xattn.cu``), restated for the tests; no kernel's CPU path.

    S = scale Q K^T in float32, cut into tiles of ``block_t`` columns (the
    last one short: columns past T are -inf).  Per row and tile j: m_j =
    the tile's maximum, l_j = sum exp(S - m_j) in float32 from the
    unrounded values, P~_j = exp(S - m_j), rounded to bf16 when
    ``round_p``.  Per row: m_row = max_j m_j, l_row = sum_j exp(m_j -
    m_row) l_j, c_j = exp(m_j - m_row) / l_row, and c_j = 0 where m_row -
    m_j >= ``cut``.  A = c_j P~_j, rounded to bf16 again when ``round_p``
    (P is rounded twice: P~, then c_j P~).  O = A V in float32, summed as
    ``splits`` stretches of whole 64-column slabs of T (the output
    kernel's split: ceil(slabs / splits) slabs each), added in split
    order; out in q's type."""
    p, m, l_t = memcom_xattn_tiled_pieces(q, k, block_t=block_t,
                                          round_p=round_p, scale=scale)
    return memcom_xattn_tiled_out(p, m, l_t, v, round_p=round_p,
                                  splits=splits, cut=cut).to(q.dtype)


def memcom_xattn_tiled_pieces(q, k, *, block_t=128, round_p=True,
                              scale=None):
    """The first pass of :func:`memcom_xattn_tiled`: the P~ tiles (B, M,
    nt, block_t) in float32 (0 past T; bf16 values when ``round_p``) and
    each tile's row maximum m_j and sum l_j (B, M, nt)."""
    B, M, D = q.shape
    T = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    nt = -(-T // block_t)
    s = torch.einsum("bmd,btd->bmt", q.float(), k.float()) * scale
    s = torch.nn.functional.pad(s, (0, nt * block_t - T),
                                value=float("-inf"))
    s = s.reshape(B, M, nt, block_t)
    m = s.amax(dim=-1)                                  # (B, M, nt)
    e = torch.exp(s - m[..., None])                     # past T: 0
    l_t = e.sum(dim=-1)
    if round_p:
        e = e.to(torch.bfloat16).float()
    return e, m, l_t


def memcom_xattn_tiled_out(p, m, l, v, *, round_p=True, splits=1,
                           cut=100.0):
    """The output pass of :func:`memcom_xattn_tiled` from the first pass's
    pieces: ``p`` (B, M, nt, block_t) the P~ tiles (0 past T), ``m`` and
    ``l`` (B, M, nt) each tile's row maximum and sum.  Returns O in
    float32, so that a kernel's own pieces (read from its workspace) can
    be taken through it."""
    B, M, nt, block_t = p.shape
    T, D = v.shape[1], v.shape[2]
    m_row = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - m_row)
    l_row = (w * l).sum(dim=-1, keepdim=True)
    c = torch.where(m_row - m >= cut, torch.zeros_like(w), w / l_row)
    a = p * c[..., None]
    if round_p:
        a = a.to(torch.bfloat16).float()
    a = a.reshape(B, M, nt * block_t)[..., :T]
    nk = -(-T // 64)
    per = -(-nk // splits)
    out = torch.zeros(B, M, D, dtype=torch.float32, device=v.device)
    for i in range(splits):
        lo, hi = min(T, i * per * 64), min(T, (i + 1) * per * 64)
        out = out + torch.einsum("bmt,btd->bmd", a[..., lo:hi],
                                 v[:, lo:hi].float())
    return out


def gmm_ref(x, w):
    """Grouped (per-expert) matmul (``ref.py:67``): (E, C, D) x (E, D, F)
    -> (E, C, F), summed in float32 and returned in ``x``'s type."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def gmm_bwd_ref(x, w, dy, need_dx=True, need_dw=True):
    """The gradient of :func:`gmm_ref` by explicit formulas, not autograd:
    the yardstick of the backward kernels.  x (E, C, D), w (E, D, F), dy
    (E, C, F) -> (dx = dy wᵀ (E, C, D) in x's type or None, dw = xᵀ dy
    (E, D, F) in w's type or None), each summed in float32."""
    dx = (torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(x.dtype)
          if need_dx else None)
    dw = (torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(w.dtype)
          if need_dw else None)
    return dx, dw


def paged_scatter(pools, news, block_tables, starts, valid=None):
    """Write ``news[i][b, s]`` into ``pools[i]`` at logical position
    ``starts[b] + s`` of slot ``b``, in place; returns ``pools``.  The
    pools (K and V) share one table walk.

    pools: sequence of (N, bs, ...), news: matching (B, S, ...),
    block_tables (B, nb) int, starts (B,) int.  Position ``p`` of slot
    ``b`` lives at ``(block_tables[b, p // bs], p % bs)``, so one write
    may straddle blocks that are not adjacent in the pool.  The table
    column is clamped to the table's width (JAX's gather clamps an
    out-of-range column the same way; torch would raise), so a lane past
    the table end writes through the last column.

    ``valid`` (B,) int (the fused step's ragged lanes): only lanes ``s <
    valid[b]`` carry tokens; the others are routed to the trash block 0
    (at offset ``p % bs``), so that an invalid lane past the table width
    cannot land, through the clamped column, in the last column's real
    block.

    Several lanes may name one pool row: idle decode slots whose tables
    point at the trash block 0, or that sit on a shared prefix's tail
    block, write at their stale lengths, and an idle slot reads those rows
    back (with a MoE layer its hidden state then competes for expert
    capacity).  The last lane in (slot, position) order wins, as in the
    reference's sequential scatter: every lane that names a row writes
    that lane's value, so the result does not depend on the order in
    which the device runs the writes."""
    bs = pools[0].shape[1]
    B, S = news[0].shape[:2]
    lane = torch.arange(S, device=news[0].device)
    pos = starts.to(torch.long)[:, None] + lane[None, :]  # (B, S)
    col = pos.div(bs, rounding_mode="floor").clamp(0, block_tables.shape[1] - 1)
    blk = torch.gather(block_tables.to(torch.long), 1, col)
    if valid is not None:
        blk = torch.where(lane[None, :] < valid.to(torch.long)[:, None], blk,
                          0)  # 0 is the trash block
    rows = (blk * bs + pos % bs).reshape(B * S)
    order = torch.argsort(rows, stable=True)
    last = torch.searchsorted(rows[order], rows, right=True) - 1
    src = order[last]  # the last lane that names each lane's row
    for pool, new in zip(pools, news):
        flat = new.reshape(B * S, *new.shape[2:])
        pool.view(-1, *pool.shape[2:])[rows] = flat[src].to(pool.dtype)
    return pools


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


def paged_decode_split_ref(q, k_pool, v_pool, *, block_tables, lengths,
                           nsplit, softcap=0.0, scale=None):
    """``paged_decode_attention_ref`` computed as the Hopper kernel cuts
    it: split ``i`` of slot ``b`` attends over the positions
    ``paged_attention.split_plan(lengths[b], bs, nb, nsplit)[i]`` alone,
    reading only their table entries, and the float32 partials (out, lse)
    merge through ``combine_attention_partials``."""
    from repro_torch.kernels.paged_attention import split_plan

    B, S, Hq, D = q.shape
    _, bs, Hkv, Dv = v_pool.shape
    nb = block_tables.shape[1]
    k_rows = k_pool.reshape(-1, Hkv, D).float()
    v_rows = v_pool.reshape(-1, Hkv, Dv).float()
    q_pos = (lengths.to(torch.int32)[:, None] - S
             + torch.arange(S, dtype=torch.int32, device=q.device)[None, :])
    plans = [split_plan(int(n), bs, nb, nsplit) for n in lengths.tolist()]
    parts = []
    for i in range(nsplit):
        out = torch.zeros(B, S, Hq, Dv, device=q.device)
        lse = torch.full((B, S, Hq), NEG_INF, device=q.device)
        for b in range(B):
            lo, hi = plans[b][i]
            if hi <= lo:
                continue
            pos = torch.arange(lo, hi, device=q.device)
            rows = block_tables[b].long()[pos // bs] * bs + pos % bs
            out[b], lse[b] = (x[0] for x in attention_ref(
                q[b:b + 1].float(), k_rows[rows][None], v_rows[rows][None],
                q_pos=q_pos[b:b + 1], kv_pos=pos[None].to(torch.int32),
                causal=True, softcap=softcap, scale=scale, return_lse=True))
        parts.append((out, lse))
    return combine_attention_partials(parts).to(q.dtype)


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


def ssd_ref(x, dt, A, Bm, Cm, *, init_state=None, chunk=256):
    """Mamba2 SSD scan (``ref.py:75`` ``ssd_ref``) in the chunked form of
    ``jnp_impl.ssd_chunked``: per chunk of Q tokens, ``cum = cumsum(dt·A)``,
    ``y = (C Bᵀ ∘ L ∘ dt_j) x + (C ∘ e^cum) stateᵀ`` with ``L_ij =
    e^(cum_i - cum_j)`` for j <= i, then ``state = state·e^cum_Q + xᵀ
    (e^(cum_Q - cum) ∘ dt ∘ B)``.  The result does not depend on Q.

    x (B,S,H,P), dt (B,S,H) float32, A (H,) float32, Bm/Cm (B,S,G,N) with
    head h reading group ``h // (H // G)``, init_state (B,H,P,N) float32
    or None (zeros) -> (y (B,S,H,P) in x's type, final state float32).
    Rows past S are padded with dt = 0, an exact no-op.  L's entries above
    the diagonal are never exponentiated (their exponent is positive and
    overflows once dt·|A| sums past ~88 within a chunk).

    Sums are taken in float32, as the JAX package takes them, and in
    float64 for float64 inputs: the yardstick the Hopper kernel's float32
    inputs (which it sums in float64) are held to, since a row of y can be
    the cancelled remainder of its terms and float32 sums stray up to
    ~5e-4 of such a row's scale."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    rep = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32

    def chunks(t, heads=False):
        t = t.to(ft)
        if heads:  # groups -> heads
            t = t.repeat_interleave(rep, dim=2)
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape(Bsz, nc, Q, *t.shape[2:]).unbind(1)

    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
         if init_state is None else init_state.to(ft))
    upper = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for xc, dtc, bc, cc in zip(chunks(x), chunks(dt), chunks(Bm, True),
                               chunks(Cm, True)):
        cum = torch.cumsum(dtc * A.to(ft), dim=1)  # (B,Q,H) inclusive
        decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Qi,Qj,H)
        L = torch.exp(decay.masked_fill(upper[None, :, :, None], -torch.inf))
        w = torch.einsum("bihn,bjhn->bijh", cc, bc) * L * dtc[:, None]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.einsum("bihn,bhpn->bihp", cc * torch.exp(cum)[..., None],
                             h)
        seg = torch.exp(cum[:, -1:] - cum) * dtc  # (B,Q,H)
        h = h * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjhp,bjhn->bhpn", xc * seg[..., None], bc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), h.float()


def ssd_bwd_ref(x, dt, A, Bm, Cm, init_state, dy, dhf):
    """The gradient of :func:`ssd_ref` by the recurrence written out, not
    autograd: the yardstick of the backward kernel.

    Inputs as :func:`ssd_ref`'s, with ``dy`` (B,S,H,P) the cotangent of y
    and ``dhf`` (B,H,P,N) that of the final state (either may be None:
    zeros) -> (dx in x's type, ddt float32, dA float32, dB and dC in Bm's
    type, dh0 float32 or None without an initial state).  With a_t =
    e^{dt_t A} and h_t = a_t h_{t-1} + dt_t x_t B_tᵀ, walking back from
    dh_S = dhf + dy_S C_Sᵀ through dh_t = a_{t+1} dh_{t+1} + dy_t C_tᵀ:
    dC_t = h_tᵀ dy_t, dx_t = dt_t dh_t B_t, dB_t = dt_t dh_tᵀ x_t, ddt_t
    = A a_t <dh_t, h_{t-1}> + <dh_t, x_t B_tᵀ>, dA = Σ dt_t a_t <dh_t,
    h_{t-1}>, dh0 = a_1 dh_1; dB and dC summed over each group's heads.
    The states h_{t-1} are recomputed from the initial state in a first
    walk and kept (S states of (B,H,P,N)); nothing divides by a_t.  Sums
    in float32, in float64 for float64 inputs."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, Af = x.to(ft), dt.to(ft), A.to(ft)
    Bh = Bm.to(ft).repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = Cm.to(ft).repeat_interleave(rep, dim=2)
    dyf = (torch.zeros_like(xf) if dy is None else dy.to(ft))
    a = torch.exp(dtf * Af)  # (B,S,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
         if init_state is None else init_state.to(ft))
    states = [h]  # states[t] = h_{t-1} of token t (0-based); then h_S
    for t in range(S):
        h = (a[:, t, :, None, None] * h
             + (dtf[:, t, :, None] * xf[:, t])[..., None]
             * Bh[:, t, :, None, :])
        states.append(h)
    g = (torch.zeros_like(h) if dhf is None else dhf.to(ft))
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dBh = torch.empty_like(Bh)
    dCh = torch.empty_like(Ch)
    dA = torch.zeros_like(Af)
    for t in reversed(range(S)):
        dh = g + dyf[:, t, :, :, None] * Ch[:, t, :, None, :]  # (B,H,P,N)
        dCh[:, t] = torch.einsum("bhpn,bhp->bhn", states[t + 1], dyf[:, t])
        u = torch.einsum("bhpn,bhn->bhp", dh, Bh[:, t])
        dx[:, t] = dtf[:, t, :, None] * u
        dBh[:, t] = dtf[:, t, :, None] * torch.einsum("bhpn,bhp->bhn", dh,
                                                      xf[:, t])
        dl = a[:, t] * torch.einsum("bhpn,bhpn->bh", dh, states[t])
        ddt[:, t] = Af * dl + torch.einsum("bhp,bhp->bh", xf[:, t], u)
        dA = dA + (dtf[:, t] * dl).sum(dim=0)
        g = a[:, t, :, None, None] * dh
    dB = dBh.reshape(Bsz, S, G, rep, N).sum(dim=3)
    dC = dCh.reshape(Bsz, S, G, rep, N).sum(dim=3)
    dh0 = None if init_state is None else g.to(init_state.dtype)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype), dh0)


def ssd_bwd_chunked(x, dt, A, Bm, Cm, init_state, dy, dhf, *, Q=32, PT=16):
    """:func:`ssd_bwd_ref` as the backward kernel (``csrc/ssd_scan.cu``,
    ``bwd::ssd_bwd``) computes it, for the tests: per tile of PT state
    rows, a first walk over Q-token chunks keeps each chunk's entering
    state (the checkpoints); a second walk, chunks last to first, carries
    G, the gradient of the state leaving the chunk, and forms every
    gradient from the chunk's own products (u_i = Σ_{k>=i} M_ki dy_k + D_i
    G B_i, dB, dC and the decay term a_t <dh_t, h_{t-1}> as four sums,
    none of which cancels another); the tiles' parts of dB, dC, ddt and
    dA are added last.  Sums in float64 for float32 inputs, float32
    otherwise, as the kernel's.  Same contract and results as
    :func:`ssd_bwd_ref` (its sums in another order)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f = torch.float64 if x.dtype in (torch.float32, torch.float64) \
        else torch.float32
    pad = (-S) % Q
    nc = (S + pad) // Q

    def padded(t):
        t = t.to(f)
        return torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1) \
            if pad else t

    xf, dtf = padded(x), padded(dt)
    dyf = padded(torch.zeros_like(x) if dy is None else dy)
    Bh = padded(Bm.repeat_interleave(rep, dim=2))
    Ch = padded(Cm.repeat_interleave(rep, dim=2))
    Af = A.to(f)
    h0 = (torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
          if init_state is None else init_state.to(f))
    g0 = (torch.zeros_like(h0) if dhf is None else dhf.to(f))
    upper = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dx = torch.zeros_like(xf)
    dB = torch.zeros_like(Bh)
    dC = torch.zeros_like(Ch)
    ddt = torch.zeros_like(dtf)
    dA = torch.zeros_like(Af)
    dh0 = torch.zeros_like(h0)

    def chunk(c):
        sl = slice(c * Q, (c + 1) * Q)
        cum = torch.cumsum(dtf[:, sl] * Af, dim=1)  # (B,Q,H) inclusive
        L = torch.exp((cum[:, :, None] - cum[:, None, :])
                      .masked_fill(upper[None, :, :, None], -torch.inf))
        return sl, cum, cum[:, -1:], L  # L (B,i,j,H), 0 above the diagonal

    for p0 in range(0, P, PT):
        ps = slice(p0, p0 + PT)
        h, hin = h0[:, :, ps], []
        for c in range(nc):  # walk 1: the checkpoints
            sl, cum, last, _ = chunk(c)
            hin.append(h)
            seg = torch.exp(last - cum) * dtf[:, sl]
            h = h * torch.exp(last[:, 0])[..., None, None] + torch.einsum(
                "bjh,bjhp,bjhn->bhpn", seg, xf[:, sl, :, ps], Bh[:, sl])
        Gc = g0[:, :, ps]
        for c in reversed(range(nc)):  # walk 2: the gradients
            sl, cum, last, L = chunk(c)
            X, DY, dtc = xf[:, sl, :, ps], dyf[:, sl, :, ps], dtf[:, sl]
            Bc, Cc, hi = Bh[:, sl], Ch[:, sl], hin[c]
            E, D = torch.exp(cum), torch.exp(last - cum)
            M = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * L
            Z = torch.einsum("bihp,bjhp->bijh", DY, X)  # dy_i . x_j
            T = Z * L
            w = torch.einsum("bhpn,bihn->bihp", Gc, Bc)
            u = torch.einsum("bkih,bkhp->bihp", M, DY) + D[..., None] * w
            dx[:, sl, :, ps] = dtc[..., None] * u
            dB[:, sl] += dtc[..., None] * (
                D[..., None] * torch.einsum("bhpn,bihp->bihn", Gc, X)
                + torch.einsum("bkih,bkhn->bihn", T, Cc))
            dC[:, sl] += torch.einsum("bijh,bjhn->bihn",
                                      T * dtc[:, None], Bc) \
                + E[..., None] * torch.einsum("bhpn,bihp->bihn", hi, DY)
            sig = D * dtc * (X * w).sum(-1)  # (B,Q,H)
            tau = E * (DY * torch.einsum("bhpn,bkhn->bkhp", hi, Cc)).sum(-1)
            Y = M * dtc[:, None] * Z  # (B,k,j,H), k > j counted below
            c1 = torch.exp(last[:, 0]) * (Gc * hi).sum((-1, -2))
            for t in range(Q):
                dl = (c1 + sig[:, :t].sum(1) + tau[:, t:].sum(1)
                      + Y[:, t:, :t].sum((1, 2)))
                ddt[:, c * Q + t] += Af * dl + (X[:, t] * u[:, t]).sum(-1)
                dA += (dtc[:, t] * dl).sum(0)
            Gc = Gc * torch.exp(last[:, 0])[..., None, None] + torch.einsum(
                "bkh,bkhp,bkhn->bhpn", E, DY, Cc)
        dh0[:, :, ps] = Gc
    dB = dB[:, :S].reshape(Bsz, S, G, rep, N).sum(3)
    dC = dC[:, :S].reshape(Bsz, S, G, rep, N).sum(3)
    return (dx[:, :S].to(x.dtype), ddt[:, :S].to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype),
            None if init_state is None else dh0.to(init_state.dtype))


def _chunk_cumsum(a):
    """Inclusive cumsum over the last axis (Q, a multiple of 32) in the
    chunked kernel's warp-scan order: lane l sums its Q/32 tokens in
    order, a Hillis-Steele scan adds the lanes' totals, and each partial
    gets its lane's exclusive prefix."""
    part = a.reshape(*a.shape[:-1], 32, a.shape[-1] // 32)
    sums = [part[..., 0]]
    for k in range(1, part.shape[-1]):
        sums.append(sums[-1] + part[..., k])
    part = torch.stack(sums, dim=-1)
    v = part[..., -1]
    off = 1
    while off < 32:
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
        off *= 2
    excl = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)
    return (excl[..., None] + part).reshape(a.shape)


def _terms(v, dtype, n):
    """The value a float32 operand takes on the tensor cores as a sum of
    ``n`` terms of ``dtype``, each the rest of the ones before rounded to
    it (hi/lo at n = 2); float32 operands stay as they are."""
    if dtype == torch.float32:
        return v
    out = torch.zeros_like(v)
    for _ in range(n):
        out = out + (v - out).to(dtype).float()
    return out


def _round_to_odd(v):
    """v (float64) rounded to float32 to odd: where v lies strictly
    between two float32 values, the one whose last bit is 1 (the chunked
    kernel's ``diag_odd``).  A later rounding to bf16 is then the rounding
    of v itself and not of its float32 rounding."""
    r = v.float()
    step = (r.double() != v) & (r.view(torch.int32) % 2 == 0) & (r != 0)
    toward = torch.where(v > r.double(), torch.inf, -torch.inf).float()
    return torch.where(step, torch.nextafter(r, toward), r)


def ssd_chunk_parallel(x, dt, A, Bm, Cm, *, init_state=None):
    """The chunked Hopper ``ssd`` kernel's three phases restated on the
    CPU, for the tests only (no path runs it): the contract of
    :func:`ssd_ref`, in ``csrc/ssd_scan.cu``'s order, at its chunk length
    (``ssd_scan.CHUNK_Q``) and with its rounding points.

    1. Chunk states, every chunk at once: ``cum`` by :func:`_chunk_cumsum`,
       ``seg_j = e^(cum_Q - cum_j)·dt_j``, ``S_c = (x∘seg)ᵀ B`` and
       ``e^cum_Q``.
    2. The state pass, serial over chunks: the state entering chunk c,
       then ``h = h·e^cum_Q(c) + S_c``.
    3. Chunk outputs, every chunk at once: ``W = C Bᵀ ∘ e^(cum_i - cum_j)
       ∘ dt_j`` for j < i (never exponentiated above the diagonal), ``y =
       W x + e^cum_i (C h_inᵀ)``, then ``W_ii x_i`` added.

    Sums in float32 (the tensor cores' float32 accumulation, in another
    order).  The three float32 operands of the kernel's products take the
    value of their terms in x's type (:func:`_terms`): x∘seg and the
    entering state two (hi/lo), W below the diagonal three; x, B and C
    enter as they are.  The diagonal term ``C_i·B_i dt_i x_i`` is added in
    float64 (the kernel's TwoSum and float32 pairs) and y's sum rounded to
    float32 to odd (:func:`_round_to_odd`) before its rounding to x's
    type."""
    from repro_torch.kernels.ssd_scan import CHUNK_Q as Q

    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    rep = H // G
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # (B, S, ...) -> (B, nc, Q, ...) float32, zeros past S
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    cum = _chunk_cumsum((dtc * A.float()).transpose(2, 3)).transpose(2, 3)
    last = cum[:, :, -1:]  # (B, nc, 1, H)
    # 1. chunk states
    seg = torch.exp(last - cum) * dtc
    xs = _terms(xc * seg[..., None], x.dtype, 2)
    states = torch.einsum("bcjhp,bcjhn->bchpn", xs,
                          bc.repeat_interleave(rep, dim=3))
    decay = torch.exp(last[:, :, 0])  # (B, nc, H)
    # 2. the state pass
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_in = _terms(torch.stack(entering, dim=1), x.dtype, 2)
    # 3. chunk outputs: W below the diagonal, then the diagonal term
    cb = torch.einsum("bcign,bcjgn->bcijg", cc, bc).repeat_interleave(
        rep, dim=4)  # (B, nc, Qi, Qj, H)
    on_or_above = ~torch.ones((Q, Q), dtype=torch.bool,
                              device=x.device).tril(-1)
    L = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(
        on_or_above[None, None, :, :, None], -torch.inf))
    w = _terms(cb * L * dtc[:, :, None], x.dtype, 3)
    rest = torch.einsum("bcijh,bcjhp->bcihp", w, xc) + torch.exp(cum)[
        ..., None] * torch.einsum("bcihn,bchpn->bcihp",
                                  cc.repeat_interleave(rep, dim=3), h_in)
    w_ii = (cc.double() * bc.double()).sum(-1).repeat_interleave(
        rep, dim=3) * dtc.double()  # (B, nc, Q, H)
    y = _round_to_odd(rest.double() + w_ii[..., None] * xc.double())
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_bwd_chunk_parallel(x, dt, A, Bm, Cm, init_state, dy, dhf, *,
                           rounding=True):
    """The chunked Hopper ``ssd`` backward (``csrc/ssd_scan.cu``,
    ``ssd_scan_chunked_bwd``) restated on the CPU, for the tests only: the
    contract of :func:`ssd_bwd_ref`, in the kernels' order, at their chunk
    length (``ssd_scan.CHUNK_Q``) and with their rounding points.

    1-2. The forward's chunk states and state pass
         (:func:`ssd_chunk_parallel`'s phases 1 and 2): the state entering
         each chunk as its hi/lo pair.
    3-4. Their mirrors: ``dS_c = Σ_k E_k dy_kᵀ C_k`` (dy∘E as a hi/lo
         pair), then, chunks last to first from dhf, ``G_{c-1} =
         e^{cum_Q(c)} G_c + dS_c``: G_c (the gradient of the state leaving
         chunk c) as a hi/lo pair, and dh0.
    5. Every chunk's gradients at once: ``u = D∘(B Gᵀ) + Mᵀ dy``, ``dx =
       dt∘u``, ``dB = dt∘(D∘(X G) + Tᵀ C)``, ``dC = (T∘dt_j) B +
       E∘(dy h_in)`` with ``M_ki = (C_k·B_i) e^{cum_k - cum_i}`` and ``T_ki
       = (dy_k·x_i) e^{cum_k - cum_i}`` for k >= i (M, T and T∘dt_j as
       hi/lo pairs), and the decay term ``a_t <dh_t, h_{t-1}>`` as ``c1 +
       Σ_{j<t} (σ_j + Σ_{k>j} Y_kj - Σ_{i<j} Y_ji) + Σ_{k>=t} τ_k``
       (``Y_kj = M_kj dt_j Z_kj``), which gives ddt and dA.
    6. dB and dC summed over each group's heads, dA over chunks and batch
       rows.

    ``cum`` is :func:`_chunk_cumsum`'s.  Sums in float32 for bf16 inputs,
    float64 for float64 inputs.  With ``rounding`` (bf16 inputs) the
    float32 operands of the kernels' products take the value of their
    hi/lo pair in bf16 (:func:`_terms`); without it, or for other inputs,
    they enter as they are, so that float64 inputs give
    :func:`ssd_bwd_ref`'s gradients up to float64 rounding."""
    from repro_torch.kernels.ssd_scan import CHUNK_Q as Q

    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    rd = x.dtype if rounding and x.dtype == torch.bfloat16 else None
    nc = -(-S // Q)
    pad = nc * Q - S

    def terms(v):
        return v if rd is None else _terms(v, rd, 2)

    def chunks(t, heads=False):  # (B, S, ...) -> (B, nc, Q, ...), 0 past S
        t = t.to(ft)
        if heads:
            t = t.repeat_interleave(rep, dim=2)
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xc, dtc, bh, ch = chunks(x), chunks(dt), chunks(Bm, True), chunks(Cm, True)
    dyc = chunks(torch.zeros_like(x) if dy is None else dy)
    Af = A.to(ft)
    cum = _chunk_cumsum((dtc * Af).transpose(2, 3)).transpose(2, 3)
    last = cum[:, :, -1:]  # (B, nc, 1, H)
    E, D = torch.exp(cum), torch.exp(last - cum)
    decay = torch.exp(last[:, :, 0])  # (B, nc, H)
    # 1-2. the forward's phases: the entering states
    seg = D * dtc
    states = torch.einsum("bcjhp,bcjhn->bchpn", terms(xc * seg[..., None]), bh)
    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
         if init_state is None else init_state.to(ft))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_in = terms(torch.stack(entering, dim=1))
    # 3-4. their mirrors: the state's gradient leaving each chunk, and dh0
    dS = torch.einsum("bckhp,bckhn->bchpn", terms(dyc * E[..., None]), ch)
    g = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
         if dhf is None else dhf.to(ft))
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = g
        g = g * decay[:, c, :, None, None] + dS[:, c]
    dh0 = g
    Gc = terms(torch.stack(leaving, dim=1))  # (B, nc, H, P, N)
    # 5. every chunk's gradients; rows k, columns i of the chunk
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(
        ~lower[None, None, :, :, None], -torch.inf))  # (B, nc, Qk, Qi, H)
    M = torch.einsum("bckhn,bcihn->bckih", ch, bh) * L
    Z = torch.einsum("bckhp,bcihp->bckih", dyc, xc)
    T = Z * L
    bg = torch.einsum("bcihn,bchpn->bcihp", bh, Gc) * D[..., None]
    sig = dtc * (xc * bg).sum(-1)
    u = bg + torch.einsum("bckih,bckhp->bcihp", terms(M), dyc)
    dx = dtc[..., None] * u
    dBh = dtc[..., None] * (
        torch.einsum("bcihp,bchpn->bcihn", xc, Gc) * D[..., None]
        + torch.einsum("bckih,bckhn->bcihn", terms(T), ch))
    eh = torch.einsum("bcihp,bchpn->bcihn", dyc, h_in) * E[..., None]
    tau = (ch * eh).sum(-1)
    dCh = eh + torch.einsum("bcijh,bcjhn->bcihn",
                            terms(T * dtc[:, :, None]), bh)
    strict = lower.tril(-1)[None, None, :, :, None]
    Y = torch.where(strict, M * dtc[:, :, None] * Z, 0.0)  # (k, j), k > j
    v = sig + Y.sum(2) - Y.sum(3)  # σ_j + Σ_{k>j} Y_kj - Σ_{i<j} Y_ji
    pre = torch.cat([torch.zeros_like(v[:, :, :1]),
                     torch.cumsum(v, dim=2)[:, :, :-1]], dim=2)
    suf = torch.flip(torch.cumsum(torch.flip(tau, [2]), dim=2), [2])
    c1 = decay * (Gc * h_in).sum((-1, -2))  # (B, nc, H)
    dl = c1[:, :, None] + pre + suf
    ddt = Af * dl + (xc * u).sum(-1)
    dA = (dtc * dl).sum((0, 1, 2))
    # 6. the sums over a group's heads
    def tokens(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]

    dB = tokens(dBh).reshape(Bsz, S, G, rep, N).sum(3)
    dC = tokens(dCh).reshape(Bsz, S, G, rep, N).sum(3)
    return (tokens(dx).to(x.dtype), tokens(ddt).to(dt.dtype),
            dA.to(A.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
            None if init_state is None else dh0.to(init_state.dtype))


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One token of the SSD recurrence (``jnp_impl.py:426``): state
    (B,H,P,N) float32, x (B,H,P), dt (B,H), A (H,), Bm/Cm (B,G,N) ->
    (y (B,H,P) in x's type, new state float32)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])
    state = state * dA[..., None, None] \
        + (dtf[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state


def bf16_ulps(out, ref) -> float:
    """Largest ``|out - ref|`` over the elements in units of bf16's spacing
    at ``|ref| + rms of ref's row`` (the scale of :func:`scaled_err`; a
    row being the last axis): a bf16 ``out`` that is ``ref`` rounded to
    the nearest bf16 is at most 0.5 from a float32 ``ref``, and one bf16
    step off it at most 1."""
    ref = ref.float()
    d = (out.float() - ref).abs()
    scale = ref.abs() + ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    _, e = torch.frexp(scale)                # scale in [2^(e-1), 2^e)
    step = torch.ldexp(torch.ones_like(scale), e - 8)  # 8 bits of mantissa
    ratio = torch.where(scale > 0, d / step, torch.where(d > 0, torch.inf,
                                                         0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


# The rms, as a share of the whole gradient's rms, below which a row of a
# gradient counts as float32 noise (:func:`grad_err`).
GRAD_NOISE_FLOOR = 2.0 ** -7


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


def grad_err(out, ref) -> float:
    """:func:`scaled_err` of a gradient, except that a row whose rms is
    below ``GRAD_NOISE_FLOOR`` times the whole tensor's rms is held to
    that instead: an absolute bound on the rows that hold only float32
    noise.  The dq row of a query that sees one key (with no lse
    cotangent) is scale (P (dP - D)) K with dP = D up to rounding, so both
    versions hold only noise there (~1e-5 of the tensor's rms), which
    :func:`scaled_err` would measure as a ratio of two noises.  Every row
    above the floor is held as :func:`scaled_err` holds it; the smallest
    true rows of the training shapes (dk/dv of the last keys of a causal
    3072-token source, seen by a few queries) lie near the floor, so it
    loosens them by at most about 2x.  A row whose reference is all 0 is
    held to the floor too: rows known to get no gradient (keys no query
    sees, queries that see no key) are checked to be exactly 0 by their
    positions, not by this yardstick."""
    ref = ref.float()
    d = (out.float() - ref).abs()
    row = torch.maximum(ref.pow(2).mean(dim=-1, keepdim=True).sqrt(),
                        GRAD_NOISE_FLOOR * ref.pow(2).mean().sqrt())
    scale = ref.abs() + row
    ratio = torch.where(scale > 0, d / scale.clamp(min=1e-37),
                        torch.where(d > 0, torch.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0
