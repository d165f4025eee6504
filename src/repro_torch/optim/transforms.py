"""Gradient transforms: clipping and communication compression
(``repro/optim/transforms.py``), over flat name-keyed dicts of tensors.

``compress_grads_bf16`` rounds gradients through bf16 (the cast that halves
all-reduce bytes); ``ErrorFeedbackInt8`` quantizes to int8 with a
per-tensor scale and carries the residual into the next step's gradient.

Under a mesh a rank holds slices of the gradients: ``groups`` names, for
each leaf, the process groups over whose ranks its slices are distinct
(the data group for a fully sharded leaf, the "model" group for a split
one, both, or none for a replicated leaf); the squares are summed over
those ranks, so every rank gets the global norm and a replicated leaf
counts once.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist


def global_norm(tree: Mapping[str, torch.Tensor],
                groups: Optional[Mapping[str, tuple]] = None
                ) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()]
    if not groups:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    buckets: dict = {}  # the leaves' insertion order: the same on every rank
    for name, s in zip(tree, sq):
        buckets.setdefault(tuple(groups.get(name, ())), []).append(s)
    total = None
    for key, parts in buckets.items():
        part = torch.sum(torch.stack(parts))
        for g in key:
            dist.all_reduce(part, group=g)
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        groups: Optional[Mapping[str, tuple]] = None):
    norm = global_norm(grads, groups)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.to(torch.float32) * scale).to(g.dtype)
            for n, g in grads.items()}, norm


def compress_grads_bf16(grads: Mapping[str, torch.Tensor]):
    """Round-trip grads through bf16."""
    return {n: g.to(torch.bfloat16).to(g.dtype) for n, g in grads.items()}


class ErrorFeedbackInt8:
    """q = round(g / s) clipped to [-127, 127] with s = max|g| / 127 per
    tensor; the residual g - q s is carried into the next step."""

    def init(self, grads: Mapping[str, torch.Tensor]) -> dict:
        return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for n, g in grads.items()}

    def compress(self, grads: Mapping[str, torch.Tensor], err: dict):
        qs, ss, es = {}, {}, {}
        for n, g in grads.items():
            gf = g.to(torch.float32) + err[n]
            s = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)
            qs[n], ss[n] = q, s
            es[n] = gf - q.to(torch.float32) * s
        return (qs, ss), es

    def decompress(self, compressed):
        q_tree, s_tree = compressed
        return {n: q.to(torch.float32) * s_tree[n] for n, q in q_tree.items()}
