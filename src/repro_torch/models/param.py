"""Parameter declaration and seeded initialisation (``repro/models/param.py``).

A module declares each parameter with :func:`make`, which allocates it
uninitialised and records how it is drawn; :func:`initialize` fills every
declared parameter of a module tree from a seed.  Each parameter gets its
own ``torch.Generator`` seeded from (seed, dotted parameter path), so a
parameter's values do not depend on what else the tree holds.  Shapes,
kinds and scales follow the JAX ``ParamBuilder``: ``fanin`` draws
``scale * fan_in**-0.5 * N(0, 1)`` with ``fan_in = shape[-2]`` unless
given, ``normal`` draws ``scale * N(0, 1)``, ``uniform`` draws ``scale *
U(-1, 1)``, ``ones``/``zeros`` are constant.  A parameter may keep its own
type inside a model of another (``make(..., dtype=torch.float32)``, as
Mamba2's ``A_log``/``dt_bias``/``D`` do in a bf16 model).  The two frameworks' generators differ, so the same seed gives
other numbers than ``jax.random``; tests carry parameters across with
:mod:`repro_torch.bridge` instead.

Parameters are created with ``requires_grad=False``, so that serving and
compression record no autograd graph; training turns on the phase's
trainable ones (:func:`repro_torch.core.memcom.set_trainable`, or
``requires_grad_`` on a whole model for plain LM training).

Each parameter also records its logical axes (``make(..., axes=)``, the
JAX ``ParamBuilder``'s), which :func:`param_specs` returns by dotted name
and :mod:`repro_torch.sharding.rules` maps to a mesh.  The JAX package
stacks a period's layers and prepends the axis ``"layers"``; the port's
layers are modules of their own, so their axes carry no such entry.
"""

from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn


class Init(NamedTuple):
    kind: str = "fanin"  # fanin | normal | uniform | ones | zeros
    scale: float = 1.0
    fan_in: Optional[int] = None


Axes = Tuple[Optional[str], ...]


def make(module: nn.Module, name: str, shape: Tuple[int, ...],
         init: Init = Init(), *, device, dtype,
         axes: Optional[Axes] = None) -> nn.Parameter:
    if axes is not None and len(axes) != len(shape):
        raise ValueError(f"{name}: axes {axes} for shape {shape}")
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                     requires_grad=False)
    module.register_parameter(name, p)
    if not hasattr(module, "_inits"):
        module._inits = {}
        module._axes = {}
    module._inits[name] = init
    module._axes[name] = axes if axes is not None else (None,) * len(shape)
    return p


def param_specs(root: nn.Module) -> Dict[str, Axes]:
    """``{dotted parameter name: logical axes}`` of every parameter of
    ``root`` (the counterpart of ``repro.models.transformer.param_specs``
    and ``repro.core.memcom.memcom_axes``); a parameter declared without
    axes has ``None`` for each dimension."""
    out = {}
    for mod_name, mod in root.named_modules():
        recorded = getattr(mod, "_axes", {})
        for name, p in mod.named_parameters(recurse=False):
            path = f"{mod_name}.{name}" if mod_name else name
            out[path] = recorded.get(name, (None,) * p.dim())
    return out


def _path_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def draw(init: Init, shape: Tuple[int, ...], path: str, seed: int,
         device) -> torch.Tensor:
    """The float32 values :func:`initialize` gives a parameter of
    ``shape`` at dotted ``path`` (cast to the parameter's type where it
    is stored)."""
    if init.kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init.kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(_path_seed(seed, path))
    kw = dict(generator=g, device=device, dtype=torch.float32)
    if init.kind == "uniform":
        return (2 * torch.rand(shape, **kw) - 1).mul_(init.scale)
    if init.kind == "normal":
        return torch.randn(shape, **kw).mul_(init.scale)
    if init.kind == "fanin":
        fi = init.fan_in if init.fan_in is not None else (
            shape[-2] if len(shape) >= 2 else shape[-1])
        return torch.randn(shape, **kw).mul_(init.scale * fi ** -0.5)
    raise ValueError(f"{path}: unknown init {init.kind!r}")


@torch.no_grad()
def initialize(root: nn.Module, seed: int,
               skip: Tuple[str, ...] = ()) -> nn.Module:
    """Draw every declared parameter of ``root`` except those under the
    submodules named in ``skip``."""
    for mod_name, mod in root.named_modules():
        if any(mod_name == s or mod_name.startswith(s + ".") for s in skip):
            continue
        for name, init in getattr(mod, "_inits", {}).items():
            p = getattr(mod, name)
            if init.kind == "ones":
                p.fill_(1.0)
                continue
            if init.kind == "zeros":
                p.zero_()
                continue
            path = f"{mod_name}.{name}" if mod_name else name
            p.copy_(draw(init, tuple(p.shape), path, seed, p.device))
    return root
