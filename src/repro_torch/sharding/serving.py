"""Mesh placement for the serving stack (``repro/sharding/serving.py``):
the target's parameters, the engine's caches and pools, prefixes, and the
collectives the placement implies.

The whole serving design keeps one invariant: **attention splits by
head**.  ``k`` / ``v`` (dense ``(slots, L, Hkv, hd)``, paged ``(N, bs,
Hkv, hd)``, a prefix's ``(B, m, Hkv, hd)``) split their head axis over the
mesh's "model" axis and replicate the rest, so block tables, per-slot
lengths and the whole control plane stay plain host values, the same on
every rank.  ``h`` (the compressor's O^i) replicates.

The JAX package places arrays from one controller and lets GSPMD insert
the collectives; its Pallas decode kernels run per shard under
``shard_map``.  The port runs one process per rank: each rank holds only
its slice of every split parameter and cache leaf (:func:`shard_module`,
:func:`shard_cache`), and the model calls the collective its placement
implies: :func:`matmul_reduce` (a product that contracts a split
dimension, attention's and the MLP's ``wo``, summed over the "model"
group in float32), :func:`reduce_model` (the vocabulary-split embedding
lookup), :func:`gather_model`
(the vocabulary-split logits, before the final softcap).  Each kernel
gets plain local tensors, which is what ``shard_map_heads`` gives the
Pallas kernels, so ``constrain_cache``, ``constrain_heads`` and
``shard_map_heads`` have no counterpart here.  Collectives carry no
gradient: this placement serves; training's sharding is a later slice.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import (BASELINE_RULES, PartitionSpec,
                                        Placement, Rules, axis_sizes,
                                        module_specs, spec_for)

__all__ = [
    "BASELINE_RULES", "ModelShard", "cache_shardings", "check_agreement",
    "dist_rank", "gather_model", "leaf_sharding", "leaf_spec",
    "matmul_reduce", "model_axis_size", "model_shard", "reduce_model",
    "shard_cache", "shard_module",
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


class ModelShard:
    """What a rank of the "model" axis needs to run its slice: the
    axis's process group, its extent and the rank's index on it.  A deep
    copy of a model keeps the same record (a process group does not
    copy)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return f"ModelShard(rank {self.rank} of {self.size})"


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


def reduce_model(x: torch.Tensor, shard: Optional[ModelShard]):
    """Sum ``x`` over the ranks of the "model" axis in float32, returned
    in ``x``'s type (the vocabulary-split embedding's rows: one rank's
    row and zeros, an exact sum); the identity without a shard."""
    if shard is None:
        return x
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=shard.group)
    return y.to(x.dtype)


def matmul_reduce(x: torch.Tensor, w: torch.Tensor,
                  shard: Optional[ModelShard]):
    """``x @ w`` where ``w`` is a row slice of the whole weight and ``x``
    the matching column slice of the activations: each rank's partial
    product is formed in float32 (on the card ``torch.mm(...,
    out_dtype=float32)`` where this PyTorch has it, else a float32
    product), summed over the "model" ranks in float32 and rounded once to
    ``x``'s type, as the unsplit bf16 product rounds its float32
    accumulator once.  Rounding each partial to bf16 before the sum would
    add a rounding a layer.  The plain ``x @ w`` without a shard."""
    if shard is None:
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = None
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        try:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        except (TypeError, RuntimeError):  # a PyTorch without out_dtype
            y = None
    if y is None:
        y = x2.float() @ w.float()
    dist.all_reduce(y, group=shard.group)
    return y.to(x.dtype).reshape(*lead, w.shape[-1])


def gather_model(x: torch.Tensor, dim: int, shard: Optional[ModelShard]):
    """Concatenate the ranks' slices of ``x`` along ``dim`` in rank order
    (the list form of ``all_gather``, which gloo takes for CUDA tensors
    too); the identity without a shard."""
    if shard is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts, dim=dim)


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


def _local(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor placed by ``spec``: each
    dimension on "model" cut to the rank's equal part.  Entries on the
    data axes must be of extent 1 (fully sharded weights come with the
    training slice)."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        for a in axes:
            if a != "model" and sizes[a] > 1:
                raise NotImplementedError(
                    f"a dimension placed on {a!r} (extent {sizes[a]}): "
                    "fully sharded weights (FSDP) come with the training-"
                    "sharding slice (ROADMAP Queue 1 step 5)")
        if "model" in axes and sizes["model"] > 1:
            n = sizes["model"]
            part = x.shape[d] // n
            x = x.narrow(d, mesh.get_local_rank("model") * part,
                         part).clone(memory_format=torch.contiguous_format)
    return x


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


@torch.no_grad()
def shard_module(model, mesh, rules: Rules = BASELINE_RULES):
    """Replace each split parameter of ``model`` (a Transformer) in place
    with this rank's slice: the counterpart of ``jax.device_put(params,
    logical_to_shardings(...))``.  Each module whose parameters split
    records the rank's :class:`ModelShard` as ``tp`` (attention: its
    local heads; the MLP: its local ff width; the embedding: its
    vocabulary range from ``vocab_start``; the model itself: a split
    ``lm_head``), which its forward reads to reduce or gather.  Returns
    ``model``; a model placed on this mesh and rule set already is
    returned as it is (two engines may share one target).  Raises for a family whose tensor-parallel placement is
    not ported yet, where the model axis is above 1."""
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
            f"{cfg.name}: tensor-parallel serving of {what} is the next "
            "slice of the port (ROADMAP Queue 1 step 5); a 1x1 mesh runs "
            "it unsplit")
    shard = model_shard(mesh)
    specs = module_specs(model, mesh, rules)
    split_owners = {}
    for name, spec in specs.items():
        owner_name, _, pname = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, pname)
        new = _local(p.data, spec, mesh)
        if new.shape != p.shape:
            setattr(owner, pname, torch.nn.Parameter(
                new, requires_grad=p.requires_grad))
            split_owners[owner_name] = (owner, pname, spec)
    for owner_name, (owner, pname, spec) in split_owners.items():
        owner.tp = shard
        if pname == "tokens":  # the vocabulary-split embedding table
            owner.vocab_start = shard.rank * owner.tokens.shape[0]
    model._placement_key = key
    return model


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
