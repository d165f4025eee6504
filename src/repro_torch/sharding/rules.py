"""Logical-axis -> mesh-axis placement rules (``repro/sharding/rules.py``).

Parameters record their logical axes where they are declared
(:func:`repro_torch.models.param.make`); this module turns a logical axis
tuple, a rules table and a mesh into a :class:`PartitionSpec`, and a whole
module into its parameters' :class:`Placement` records.  A dimension that
does not divide the extent of the mesh axes assigned to it drops to
replication (granite's 40 experts or 49155-row vocabulary on a 16-way
model axis), as in the JAX package.

Where the JAX package hands a ``NamedSharding`` to ``jax.device_put`` and
lets GSPMD insert the collectives, the port places explicitly: each rank
of a ``torch.distributed`` mesh holds only its slice of every split
parameter (:func:`shard_module`), and the model issues the collective the
placement implies (:mod:`repro_torch.sharding.serving`).  One deviation
follows from that.  Attention splits by whole heads: a layer's attention
parameters split only where its query and KV head counts both divide the
model axis (the JAX kernels' ``_head_parallel``); elsewhere they
replicate.  ``spec_for`` on a flattened ``(d, heads * head_dim)`` leaf
would cut 3 heads of 32 at the middle of a head on a 2-way axis, which
GSPMD reshards and explicit placement cannot.  The results are the same
either way.

Rule sets, copied from the JAX package:

* BASELINE_RULES: tensor / expert parallel weights over "model",
  replicated over data.
* FSDP_RULES: every kernel's "embed" dim over the data axes as well
  (fully sharded weights); LAYERS_FSDP_RULES shards the stacked-layer dim
  instead; FSDP_EP_EMBED_RULES also shards the expert weights' d_model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

AxisAssignment = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, AxisAssignment]

# "data_axes" is resolved per mesh: ("pod", "data") when a pod axis exists.
BASELINE_RULES: Rules = {
    "vocab": "model",
    "embed": None,
    "embed_ep": None,  # expert weights' d_model: never FSDP-sharded
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert": "model",
    "mamba_inner": "model",
    "mamba_heads": "model",
    "mla_lora": None,
    "layers": None,
}

FSDP_RULES: Rules = dict(BASELINE_RULES, embed="data_axes")
LAYERS_FSDP_RULES: Rules = dict(BASELINE_RULES, layers="data_axes")
FSDP_EP_EMBED_RULES: Rules = dict(FSDP_RULES, embed_ep="data_axes")


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (replicated), a mesh axis name,
    or a tuple of axis names; a one-name tuple reads as the bare name, as
    ``jax.sharding.PartitionSpec`` canonicalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):  # copy / pickle rebuild it entry by entry
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Placement:
    """A tensor's place on a mesh: the counterpart of ``NamedSharding``."""
    mesh: object
    spec: PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: extent}`` of a ``DeviceMesh`` (``mesh_dim_names``) or
    of any object with ``axis_names`` and a ``shape`` mapping (a JAX mesh,
    or a stub of one)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _resolve(assign: AxisAssignment, mesh) -> Tuple[str, ...]:
    if assign is None:
        return ()
    if assign == "data_axes":
        return _data_axes(mesh)
    if isinstance(assign, str):
        return (assign,)
    return tuple(assign)


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def spec_for(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
             mesh, rules: Rules) -> PartitionSpec:
    """Each dimension's mesh axes by its logical name; an axis is consumed
    once a spec, and a dimension its axes do not divide replicates."""
    entries = []
    used = set()
    for dim, name in zip(shape, logical):
        assign = _resolve(rules.get(name), mesh) if name else ()
        assign = tuple(a for a in assign if a not in used)
        if assign and dim % _axes_size(mesh, assign) == 0:
            entries.append(assign if len(assign) > 1 else assign[0])
            used.update(assign)
        else:
            entries.append(None)
    return PartitionSpec(*entries)


def heads_split(num_heads: int, num_kv_heads: int, mesh,
                rules: Rules) -> bool:
    """Does an attention layer of these head counts split by head?  Both
    counts must take the model axis alone (the placement rule counted in
    heads; module docstring)."""
    if _axes_size(mesh, ("model",)) <= 1:
        return False
    return (spec_for((num_heads,), ("heads",), mesh, rules)
            == PartitionSpec("model")
            and spec_for((num_kv_heads,), ("kv_heads",), mesh, rules)
            == PartitionSpec("model"))


def module_specs(model, mesh, rules: Rules) -> Dict[str, PartitionSpec]:
    """``{dotted parameter name: spec}`` of ``model``'s parameters, with
    attention's head axes replicated where the layer's heads do not split
    (module docstring)."""
    from repro_torch.models.param import param_specs

    unsplit = set()
    for prefix, mod in model.named_modules():
        heads = getattr(mod, "head_counts", None)
        if heads is not None and not heads_split(*heads, mesh, rules):
            unsplit.add(f"{prefix}." if prefix else "")
    params = dict(model.named_parameters())
    out = {}
    for name, axes in param_specs(model).items():
        owner = name.rsplit(".", 1)[0] + "." if "." in name else ""
        if owner in unsplit:
            axes = tuple(None if a in ("heads", "kv_heads") else a
                         for a in axes)
        out[name] = spec_for(tuple(params[name].shape), axes, mesh, rules)
    return out


def logical_to_shardings(model, mesh, rules: Rules) -> Dict[str, Placement]:
    """``{dotted parameter name: Placement}`` for ``model`` (the JAX
    function's pytree of ``NamedSharding``, keyed by the port's names)."""
    return {name: Placement(mesh, spec)
            for name, spec in module_specs(model, mesh, rules).items()}


def batch_sharding(mesh, ndim: int = 2, batch_dim: int = 0) -> Placement:
    """The batch dimension over (pod, data); the rest replicated."""
    entries = [None] * ndim
    entries[batch_dim] = _data_axes(mesh)
    return Placement(mesh, PartitionSpec(*entries))


def replicated(mesh) -> Placement:
    return Placement(mesh, PartitionSpec())


def opt_state_shardings(state: Mapping, param_shardings: Mapping[str,
                                                                 Placement],
                        mesh) -> dict:
    """AdamW state entries (``mu`` / ``nu`` / ``master``, keyed by
    parameter name, each of its parameter's shape) take their parameter's
    placement; ``count`` and unknown names replicate."""
    def lookup(kind):
        return {name: param_shardings.get(name, replicated(mesh))
                for name in kind}

    return {"mu": lookup(state["mu"]), "nu": lookup(state["nu"]),
            "master": lookup(state["master"]), "count": replicated(mesh)}
