"""Mesh placement (``repro/sharding/serving.py``): the parameters of a
model placed on a ("data", "model") mesh of ranks, the serving engine's
caches and pools, prefixes, and the agreement check of the ranks'
control planes.

The serving design keeps one invariant: **attention splits by head**.
``k`` / ``v`` (dense ``(slots, L, Hkv, hd)``, paged ``(N, bs, Hkv, hd)``,
a prefix's ``(B, m, Hkv, hd)``) split their head axis over the mesh's
"model" axis and replicate the rest, so block tables, per-slot lengths
and the whole control plane stay plain host values, the same on every
rank.  ``h`` (the compressor's O^i) replicates.

The JAX package places arrays from one controller and lets GSPMD insert
the collectives; its Pallas decode kernels run per shard under
``shard_map``.  The port runs one process per rank: each rank holds only
its slice of every placed parameter and cache leaf (:func:`shard_module`,
:func:`shard_cache`), and the model calls the collective its placement
implies (:mod:`repro_torch.sharding.collectives`, re-exported here:
``matmul_reduce``, ``reduce_model``, ``gather_model``, and for training
``copy_to_model`` and the fully sharded parameters' gathers).  Each
kernel gets plain local tensors, which is what ``shard_map_heads`` gives
the Pallas kernels, so ``constrain_cache``, ``constrain_heads`` and
``shard_map_heads`` have no counterpart here.  Under ``FSDP_RULES`` at a
data axis above 1 every data rank serves the same requests (replicas) and
gathers each fully sharded weight whole for the call that reads it.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding.collectives import (DataShard, ModelShard,
                                              copy_to_model, gather_model,
                                              gather_param, matmul_reduce,
                                              reduce_model, unshard_hooks,
                                              unsharded)
from repro_torch.sharding.rules import (BASELINE_RULES, PartitionSpec,
                                        Placement, Rules, axis_sizes,
                                        module_specs, spec_for)

__all__ = [
    "BASELINE_RULES", "DataShard", "ModelShard", "cache_shardings",
    "check_agreement", "copy_to_model", "dist_rank", "gather_model",
    "gather_param", "leaf_sharding", "leaf_spec", "matmul_reduce",
    "model_axis_size", "model_shard", "placed_specs", "reduce_model",
    "shard_cache", "shard_module", "unsharded",
]

#: trailing logical dims per cache / prefix leaf key; the leading dims
#: (batch or pool, positions) replicate.  The head axis trails in every
#: layout a key appears in: dense cache, paged pool, prefix, store row.
_TRAILING = {
    "k": ("kv_heads", None),
    "v": ("kv_heads", None),
    "ck": ("heads", None),
    "cv": ("heads", None),
    "ckv": (),
    "kr": (),
    "h": (),            # compressor output O^i: (B, m, d_model), replicated
    "conv": ("mamba_inner",),
    "ssm": ("mamba_heads", None, None),
}


def model_axis_size(mesh) -> int:
    """Extent of the tensor-parallel axis (1 with no mesh or no axis)."""
    if mesh is None:
        return 1
    return axis_sizes(mesh).get("model", 1)


def model_shard(mesh) -> Optional[ModelShard]:
    """This rank's :class:`ModelShard` of ``mesh``; None where the model
    axis is 1 (nothing splits, no collective runs)."""
    n = model_axis_size(mesh)
    if n <= 1:
        return None
    return ModelShard(mesh.get_group("model"), n,
                      mesh.get_local_rank("model"))


def dist_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def check_agreement(group, *arrays: np.ndarray) -> None:
    """Raise unless every rank of ``group`` holds the same ``arrays`` (a
    CRC-32 of their bytes, gathered): the serving engine's check that the
    ranks' control planes still agree, which fails at once where a
    diverged rank would hang the next collective."""
    h = zlib.crc32(b"".join(np.ascontiguousarray(a).tobytes()
                            for a in arrays))
    mine = torch.tensor([h], dtype=torch.int64)
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    seen = [int(p[0]) for p in parts]
    if any(v != h for v in seen):
        raise RuntimeError(f"the ranks' control planes diverged: step "
                           f"hashes {seen} (this rank {dist_rank()})")


def _cut(spec: PartitionSpec, mesh):
    """``[(dim, axes, extent, this rank's index)]`` of the dimensions
    ``spec`` places on mesh axes of extent above 1."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    out = []
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = tuple(a for a in axes if sizes[a] > 1)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:  # row-major over the axes, as a mesh lays them out
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        out.append((d, axes, n, idx))
    return out


def _local(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor placed by ``spec``: each
    dimension on mesh axes cut to the rank's equal part ("model" and the
    data axes alike)."""
    cut = _cut(spec, mesh)
    if not cut:
        return x
    for d, _axes, n, idx in cut:
        part = x.shape[d] // n
        x = x.narrow(d, idx * part, part)
    return x.clone(memory_format=torch.contiguous_format)


def _unported(cfg) -> Optional[str]:
    descs = cfg.layout.descriptors()
    for what, hit in (
            ("MoE (expert parallel)", any(d.mlp == "moe" for d in descs)),
            ("Mamba2 (mamba_inner / mamba_heads)",
             any(d.mixer == "mamba" for d in descs)),
            ("MLA", any(d.mixer == "mla" for d in descs)),
            ("an encoder-decoder stack (Whisper)",
             cfg.encoder is not None or any(d.cross_attn for d in descs))):
        if hit:
            return what
    return None


def _unit_of(model, owner_name: str) -> Optional[str]:
    """The module whose calls gather a fully sharded parameter of
    ``owner_name``: its shallowest ancestor below ``model`` (itself
    included) that defines ``forward`` (a transformer block, a ``memx``
    layer, a final norm), else ``model`` where it defines one (the
    embedding table's stack); None where no call encloses the reads (a
    MemCom's memory tokens: ``collectives.unsharded``)."""
    parts = owner_name.split(".") if owner_name else []
    for i in range(1, len(parts) + 1):
        name = ".".join(parts[:i])
        if type(model.get_submodule(name)).forward is not nn.Module.forward:
            return name
    if type(model).forward is not nn.Module.forward:
        return ""
    return None


def _draw(owner, pname: str, path: str, seed: int, device, dtype):
    """A parameter declared on the meta device, drawn whole from ``seed``
    on ``device`` as :func:`repro_torch.models.param.initialize` draws
    it."""
    from repro_torch.models.param import draw

    shape = tuple(owner._parameters[pname].shape)
    return draw(owner._inits[pname], shape, path, seed, device).to(dtype)


@torch.no_grad()
def shard_module(model, mesh, rules: Rules = BASELINE_RULES, *,
                 seed: Optional[int] = None, device=None):
    """Replace each placed parameter of ``model`` in place with this
    rank's slice: the counterpart of ``jax.device_put(params,
    logical_to_shardings(...))``.

    * A dimension on "model" (heads, ff, vocabulary): each module whose
      parameters split records the rank's :class:`ModelShard` as ``tp``
      (attention: its local heads; the MLP: its local ff width; the
      embedding: its vocabulary range from ``vocab_start``; the model
      itself: a split ``lm_head``), which its forward reads to reduce or
      gather.
    * A dimension on the data axes (``FSDP_RULES``' "embed"): the module
      records the cut in ``_fsdp``, and the module whose calls enclose its
      reads (:func:`_unit_of`: the block, the ``memx`` layer, the stack
      for its embedding table) gets the hooks that gather the parameter
      whole for each call (``collectives.unshard_hooks``); autograd
      reduce-scatters its gradient.  A MemCom's memory tokens, read
      outside any call, are gathered where ``core.memcom`` reads them
      (``collectives.unsharded``).

    Each parameter's spec is kept on its module (``_specs``, read by
    :func:`placed_specs`).  Parameters declared on the meta device
    (``init_params(..., mesh=)``) are drawn whole from ``seed`` on
    ``device`` one at a time and cut at once, so a rank never holds more
    than one whole parameter.  Submodules placed already (a MemCom's
    stacks, copies of a placed target) are left as they are.  Returns
    ``model``; a model placed on this mesh and rule set already is
    returned as it is (two engines may share one target).  Raises for a
    family whose tensor-parallel placement is not ported yet, where the
    model axis is above 1."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist_rank()} is not on the mesh "
                         f"{axis_sizes(mesh)}")
    key = (id(mesh), tuple(sorted(rules.items())))
    placed = getattr(model, "_placement_key", None)
    if placed is not None:  # a second engine on the same placed target
        if placed != key:
            raise ValueError("the model is placed on another mesh or rule "
                             "set already; build it again to place it anew")
        return model
    n = model_axis_size(mesh)
    cfg = getattr(model, "cfg", None)
    what = _unported(cfg) if (cfg is not None and n > 1) else None
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism of {what} is not ported yet "
            "(ROADMAP Queue 1 step 5.2); a model axis of 1 runs it, split "
            "over the data axes or whole")
    done = tuple(f"{name}." for name, mod in model.named_modules()
                 if name and getattr(mod, "_placement_key", None) is not None)
    shard = model_shard(mesh)
    specs = module_specs(model, mesh, rules)
    split_owners = {}
    for name, spec in specs.items():
        if name.startswith(done):
            continue
        owner_name, _, pname = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = owner._parameters[pname]
        whole = p.data
        if p.is_meta:
            whole = _draw(owner, pname, name, seed, device, p.dtype)
        cut = _cut(spec, mesh)
        new = _local(whole, spec, mesh)
        if new is not p.data:
            owner._parameters[pname] = torch.nn.Parameter(
                new, requires_grad=p.requires_grad)
        if not hasattr(owner, "_specs"):
            owner._specs = {}
        owner._specs[pname] = spec
        for d, axes, size, idx in cut:
            if "model" in axes:
                split_owners[owner_name] = (owner, pname)
            else:
                if len(axes) != 1:
                    raise NotImplementedError(
                        f"{name}: a dimension over the data axes {axes}; "
                        "the port's data groups span one axis (ROADMAP "
                        "Queue 1 step 5.3)")
                if not hasattr(owner, "_fsdp"):
                    owner._fsdp = {}
                owner._fsdp[pname] = DataShard(
                    d, mesh.get_group(axes[0]), size, idx)
                unit = _unit_of(model, owner_name)
                if unit is not None:
                    unshard_hooks(model.get_submodule(unit),
                                  owner_name[len(unit):].lstrip("."))
        del whole
    for owner_name, (owner, pname) in split_owners.items():
        owner.tp = shard
        if pname == "tokens":  # the vocabulary-split embedding table
            owner.vocab_start = shard.rank * owner._parameters[
                "tokens"].shape[0]
    model._placement_key = key
    return model


def placed_specs(model) -> dict:
    """``{dotted parameter name: PartitionSpec}`` of a model placed by
    :func:`shard_module` (a parameter it did not place reads as
    replicated)."""
    out = {}
    for mod_name, mod in model.named_modules():
        specs = getattr(mod, "_specs", {})
        for pname, p in mod.named_parameters(recurse=False):
            path = f"{mod_name}.{pname}" if mod_name else pname
            out[path] = specs.get(pname, PartitionSpec())
    return out


def leaf_spec(key: Optional[str], ndim: int, shape: Tuple[int, ...],
              mesh, rules: Rules) -> PartitionSpec:
    trailing = _TRAILING.get(key, ())
    if ndim < len(trailing):
        return PartitionSpec()
    logical = (None,) * (ndim - len(trailing)) + trailing
    return spec_for(shape, logical, mesh, rules)


def leaf_sharding(key: Optional[str], x, mesh,
                  rules: Rules = BASELINE_RULES) -> Placement:
    """The Placement of one cache / prefix leaf by its dict key."""
    return Placement(mesh, leaf_spec(key, x.dim(), tuple(x.shape), mesh,
                                     rules))


def _map_leaves(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, key) for v in tree)
    if tree is None:
        return None
    return fn(key, tree)


def cache_shardings(tree, mesh, rules: Rules = BASELINE_RULES):
    """The Placement of every leaf of a per-layer cache / prefix / store
    row tree, keyed by leaf name (``k`` / ``v`` / ``h`` / ...), in the
    tree's own structure: dense and paged layouts alike."""
    return _map_leaves(tree, lambda key, x: leaf_sharding(key, x, mesh,
                                                          rules))


def shard_cache(tree, mesh, rules: Rules = BASELINE_RULES):
    """This rank's slice of a whole cache / prefix tree (the tree itself
    without a mesh, or where the model axis is 1)."""
    if model_axis_size(mesh) <= 1:
        return tree
    return _map_leaves(tree, lambda key, x: _local(
        x, leaf_spec(key, x.dim(), tuple(x.shape), mesh, rules), mesh))
