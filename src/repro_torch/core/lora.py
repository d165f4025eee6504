"""LoRA adapters for the ICAE compressor family (``repro/core/lora.py``;
paper §5.1, Fig. 3a).

Each adapted kernel ``w`` (d_in, d_out) of a port layer gets an
:class:`Adapter` with ``a`` (d_in, r) and ``b`` (r, d_out), and the
effective weight is ``w + (alpha/r) * a @ b``.  :class:`LoRA` mirrors the
adapted parameters' names (``layers.{i}.attn.wq`` -> ``layers.{i}.attn.wq.a``
/ ``.b``), one adapter per layer where the JAX tree stacks a ``period``'s
layers on a leading axis.  :func:`merge_lora` builds the merged weights as
new tensors (the model's own are not written), so autograd reaches ``a``
and ``b`` through them; the model reads them through
``Transformer.forward(params=...)``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from repro_torch.models.param import Init, initialize, make


class Adapter(nn.Module):
    """``a`` ~ d_in^-0.5 N(0, 1), ``b`` = 0, in the adapted weight's type."""

    def __init__(self, d_in: int, d_out: int, rank: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        make(self, "a", (d_in, rank), Init("normal", scale=d_in ** -0.5), **kw)
        make(self, "b", (rank, d_out), Init("zeros"), **kw)


class LoRA(nn.ModuleDict):
    """The adapters of a model, nested along the adapted parameters' names;
    :meth:`adapters` lists them as {adapted parameter name: Adapter}."""

    def adapters(self) -> Dict[str, Adapter]:
        return {name: mod for name, mod in self.named_modules()
                if isinstance(mod, Adapter)}


def _adapted(name: str, p: torch.Tensor, targets: Sequence[str]) -> bool:
    """A leaf named in ``targets`` under an ``attn`` scope, at least 2-D
    (``repro/core/lora.py:35``)."""
    *scope, leaf = name.split(".")
    return leaf in targets and "attn" in scope and p.dim() >= 2


def init_lora(model: nn.Module, targets: Sequence[str], rank: int = 32,
              seed: int = 0) -> LoRA:
    """An adapter for every parameter of ``model`` whose name is in
    ``targets`` (e.g. ("wq", "wk")) under an ``attn`` scope, on the
    parameter's device; ``a`` drawn from ``seed`` (a generator per adapter
    path, see :func:`repro_torch.models.param.initialize`)."""
    lora = LoRA()
    for name, p in model.named_parameters():
        if not _adapted(name, p, targets):
            continue
        node = lora
        *scope, leaf = name.split(".")
        for key in scope:
            if key not in node:
                node[key] = nn.ModuleDict()
            node = node[key]
        node[leaf] = Adapter(p.shape[-2], p.shape[-1], rank, device=p.device,
                             dtype=p.dtype)
    return initialize(lora, seed)


def merge_lora(model: nn.Module, lora: LoRA, alpha: float = 16.0,
               rank: int = 32) -> Dict[str, torch.Tensor]:
    """{adapted parameter name: w + (alpha/rank) * (a @ b) cast to w's type}
    for the parameters of ``model``, new tensors (``repro/core/lora.py:53``).
    The parameters without an adapter are not in the result: they stay as
    they are."""
    params = dict(model.named_parameters())
    scale = alpha / rank
    return {name: params[name] + scale * (ad.a @ ad.b).to(params[name].dtype)
            for name, ad in lora.adapters().items()}
