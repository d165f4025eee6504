"""Mixture-of-Experts with sort-based capacity dispatch
(``repro/models/moe.py``).

Tokens are argsorted by assigned expert, windowed into per-expert
capacity buffers (E, C, D), pushed through the grouped matmul
(:func:`repro_torch.kernels.ops.gmm`: the Hopper kernel on the card, its
plain version on the CPU) and combined back.  Capacity
``C = ceil8(int(capacity_factor * N * k / E))`` (at least 8) is derived from
all N tokens of the forward pass, so a token beyond its expert's C rows is
dropped (its routed output is 0).

Dispatch groups (``MoEConfig.dispatch_groups`` G > 1): the sort, cumsum and
scatter run within G independent token groups with a per-group capacity;
the (G, E, C, D) buffers are folded into (E, G*C, D) for one ``gmm``
launch.  The JAX package derives G from its installed residual sharding
(``sharding/ctx.py::moe_dispatch_plan``), and so does the port
(:func:`repro_torch.sharding.ctx.moe_dispatch_plan`): off-mesh the plan
is ``(x, None)`` and G is the config's; with the batch over n data ranks
the JAX MoE dispatches in n batch groups, of which each rank holds one,
so a rank dispatches its own tokens as one group (the capacity of N / n
tokens), and the load-balance statistics ``me`` and ``ce`` are summed
over the data ranks, so the aux loss stays the global one.

Parity traps kept on purpose:

* top-k takes the lower expert index first on a tie, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` promises no order);
* the dispatch sort is stable, so within an expert earlier tokens win
  capacity;
* a dropped token's buffer index is ``E*C``: its write goes to a trash row
  past the buffers, and its read is masked by ``keep``;
* gates are cast to the buffer dtype before the weighted sum over k, and
  the output to ``x``'s dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import MLP
from repro_torch.models.param import Init, make
from repro_torch.sharding.collectives import sum_over
from repro_torch.sharding.ctx import data_group, moe_dispatch_plan


class MoE(nn.Module):
    """Router (d, E), expert stacks ``wg``/``wi`` (E, d, F) and ``wo``
    (E, F, d), and the optional shared SwiGLU expert ``shared.mlp``: the
    names of the JAX tree, so :mod:`repro_torch.bridge` maps them as they
    are."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, E, Fd = cfg.d_model, m.num_experts, m.expert_d_ff
        kw = dict(device=device, dtype=dtype)
        make(self, "router", (d, E), axes=("embed", "expert"), **kw)
        make(self, "wg", (E, d, Fd), Init(fan_in=d),
             axes=("expert", "embed_ep", "ff"), **kw)
        make(self, "wi", (E, d, Fd), Init(fan_in=d),
             axes=("expert", "embed_ep", "ff"), **kw)
        make(self, "wo", (E, Fd, d), Init(fan_in=Fd),
             axes=("expert", "ff", "embed_ep"), **kw)
        if m.num_shared_experts:
            self.shared = nn.ModuleDict({"mlp": MLP(
                cfg, d_ff=m.num_shared_experts * m.shared_ff(),
                mlp_type="swiglu", **kw)})

    def forward(self, x):
        return apply_moe(self, self.cfg, x)


def _capacity(m, n_tokens: int) -> int:
    c = int(m.capacity_factor * n_tokens * m.top_k / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _top_k(probs, k: int):
    """The k largest probabilities per row and their expert ids, the lower
    id first on a tie (``jax.lax.top_k``'s order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _dispatch(xf, ids, E: int, k: int, C: int):
    """(G, Ng, D) tokens + (G, Ng, k) expert ids -> (G, E, C, D) capacity
    buffers plus the metadata :func:`_combine` needs, each group on its
    own (the reference vmaps a per-group function)."""
    G, Ng, D = xf.shape
    dev = xf.device
    flat_ids = ids.reshape(G, Ng * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(Ng * k, device=dev)[None]
            - torch.gather(starts, 1, sorted_ids))
    keep = rank < C
    buf_idx = torch.where(keep, sorted_ids * C + rank,
                          torch.full_like(rank, E * C))  # E*C: dropped
    token_idx = order // k
    grp = torch.arange(G, device=dev)[:, None]
    buffers = torch.zeros((G, E * C + 1, D), dtype=xf.dtype, device=dev)
    buffers[grp, buf_idx] = xf[grp, token_idx]  # row E*C is the trash row
    return buffers[:, :E * C].reshape(G, E, C, D), (keep, buf_idx, order)


def _combine(y_buf, md, gates, k: int):
    """Inverse of :func:`_dispatch`: (G, E, C, D) expert outputs and (G,
    Ng, k) gates -> (G, Ng, D)."""
    keep, buf_idx, order = md
    G, E, C, D = y_buf.shape
    flat = y_buf.reshape(G, E * C, D)
    grp = torch.arange(G, device=y_buf.device)[:, None]
    y_sorted = flat[grp, buf_idx.clamp(max=E * C - 1)]
    y_sorted = torch.where(keep[..., None], y_sorted,
                           torch.zeros_like(y_sorted))
    inv = torch.empty_like(order)  # argsort of a permutation: its inverse
    inv.scatter_(1, order, torch.arange(order.shape[1],
                                        device=order.device).expand_as(order))
    Ng = gates.shape[1]
    y_k = y_sorted[grp, inv].reshape(G, Ng, k, D)
    return (y_k * gates[..., None].to(y_k.dtype)).sum(dim=2)


def _expert_ffn(p: MoE, buffers):
    """SwiGLU through the per-expert grouped matmul; (G, E, C, D) buffers
    are folded into (E, G*C, D): one kernel launch per product."""
    G, E, C, D = buffers.shape
    x = buffers.transpose(0, 1).reshape(E, G * C, D)
    h = F.silu(ops.gmm(x, p.wg)) * ops.gmm(x, p.wi)
    y = ops.gmm(h, p.wo)
    return y.reshape(E, G, C, -1).transpose(0, 1)


def apply_moe(p: MoE, cfg: ModelConfig, x):
    """x: (B, S, D) -> (y, aux_loss); aux_loss is the Switch-style load
    balance term (float32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    N = B * S
    x, plan = moe_dispatch_plan(x, E)
    group = data_group()
    if plan is not None:
        G, n_data = 1, plan  # this rank's batch group (module docstring)
    elif group is not None:
        raise NotImplementedError(
            "a MoE over a batch split across data ranks without the "
            "dispatch plan (moe_plan_disabled, or experts that do not "
            "divide the model axis) dispatches the global batch as one "
            "group: not ported (ROADMAP Queue 1 step 5.2)")
    else:
        G, n_data = m.dispatch_groups, 1
    if G <= 0 or N % G:
        G = 1
    xf = x.reshape(N, D)

    logits = (xf @ p.router).float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, k)  # (N, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style, global)
    if plan is None:
        me = probs.mean(dim=0)  # (E,)
    else:
        me = sum_over(probs.sum(dim=0), group) / (N * n_data)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, ids.reshape(-1), torch.ones(N * k, device=x.device))
    ce = sum_over(ce, group if plan is not None else None) / (N * n_data * k)
    aux = m.aux_loss_weight * E * torch.sum(me * ce)

    Ng = N // G
    C = _capacity(m, Ng)
    buffers, md = _dispatch(xf.reshape(G, Ng, D), ids.reshape(G, Ng, k),
                            E, k, C)
    y_buf = _expert_ffn(p, buffers)
    y = _combine(y_buf, md, gates.reshape(G, Ng, k), k).reshape(N, D)

    shared: Optional[nn.ModuleDict] = getattr(p, "shared", None)
    if shared is not None:
        y = y + shared["mlp"](xf)
    return y.reshape(B, S, D).to(x.dtype), aux
