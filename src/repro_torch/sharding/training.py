"""The placement of a training run on a ("data", "model") mesh: what the
train step and the Trainer need beyond the model's own collectives
(``repro/launch/train.py`` hands GSPMD the same facts as shardings).

* :class:`TrainPlacement`: the mesh, each trained tensor's
  :class:`~repro_torch.sharding.rules.PartitionSpec`, and the residual
  stream's placement.  :meth:`TrainPlacement.running` installs the
  activation context (``sharding.ctx``) and, where the data axis is above
  1, the backward pass's regather of fully sharded weights;
  :meth:`TrainPlacement.sync` sums over the data ranks the gradients that
  autograd did not reduce (leaves replicated over the data axis); and
  :meth:`TrainPlacement.norm_groups` tells ``clip_by_global_norm`` over
  which ranks each leaf's slices are distinct.
* :func:`gather_whole` / :func:`TrainPlacement.local`: a slice to its
  whole tensor on rank 0, and a whole tensor to this rank's slice.
  Checkpoints stay mesh-independent, as the JAX manager's (it saves
  global arrays): the slices are gathered to rank 0, which writes the
  one-rank format, and every rank restores the whole and takes its slice.
  The gathers run on the host over the mesh's gloo control group.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.collectives import regather_saved
from repro_torch.sharding.ctx import act_sharding
from repro_torch.sharding.rules import PartitionSpec, Placement, axis_sizes
from repro_torch.sharding.serving import _cut, _local


class TrainPlacement:
    """A training run's placement (module docstring).  ``specs`` maps each
    trained tensor's name to its spec (``sharding.serving.placed_specs``);
    ``act`` is the residual stream's Placement (``act_sharding_for``)."""

    def __init__(self, mesh, specs: Mapping[str, PartitionSpec],
                 act: Optional[Placement] = None):
        self.mesh, self.specs, self.act = mesh, dict(specs), act
        sizes = axis_sizes(mesh)
        self.sizes = sizes
        self.data_group = (mesh.get_group("data")
                           if sizes.get("data", 1) > 1 else None)
        self.model_group = (mesh.get_group("model")
                            if sizes.get("model", 1) > 1 else None)
        self.control = getattr(mesh, "control_group", None)
        self.lead = all(c == 0 for c in mesh.get_coordinate())

    def _axes(self, name: str) -> set:
        out = set()
        for _d, axes, _n, _i in _cut(self.specs.get(name, PartitionSpec()),
                                     self.mesh):
            out.update(axes)
        return out

    def norm_groups(self) -> Dict[str, tuple]:
        """``{name: groups}`` for ``global_norm``: the data group where a
        leaf is fully sharded, the "model" group where it splits there."""
        out = {}
        for name in self.specs:
            axes = self._axes(name)
            out[name] = tuple(
                g for g, hit in ((self.data_group, "data" in axes),
                                 (self.model_group, "model" in axes))
                if hit and g is not None)
        return out

    def sync(self, grads: Mapping[str, torch.Tensor]) -> dict:
        """Sum over the data ranks (in float32) the gradients of leaves
        replicated over the data axis; a fully sharded leaf's gradient
        was reduce-scattered by autograd already."""
        if self.data_group is None:
            return dict(grads)
        out = {}
        for name, g in grads.items():
            if "data" not in self._axes(name):
                y = g.to(torch.float32, copy=True).contiguous()
                dist.all_reduce(y, group=self.data_group)
                g = y.to(g.dtype)
            out[name] = g
        return out

    @contextlib.contextmanager
    def running(self):
        """The step's forward and backward: the activation context, and
        the regather of saved fully sharded weights at data above 1."""
        regather = (regather_saved() if self.data_group is not None
                    else contextlib.nullcontext())
        with act_sharding(self.act), regather:
            yield

    def broadcast(self, values):
        """Rank 0's python ints / floats, on every rank of the mesh (the
        Trainer's stop decisions); the values themselves on one rank."""
        if self.control is None:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.control)
        return t.tolist()

    def barrier(self) -> None:
        if self.control is not None:
            dist.barrier(group=self.control)

    def local(self, whole: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the whole tensor ``name``."""
        return _local(whole, self.specs.get(name, PartitionSpec()),
                      self.mesh)

    def whole(self, t: torch.Tensor, name: str) -> Optional[torch.Tensor]:
        """The whole tensor ``name`` from the ranks' slices, on the host:
        on rank 0 (None elsewhere)."""
        return gather_whole(t, self.specs.get(name, PartitionSpec()),
                            self.mesh)


def gather_whole(t: torch.Tensor, spec: PartitionSpec,
                 mesh) -> Optional[torch.Tensor]:
    """The whole tensor placed by ``spec`` from every rank's slice ``t``,
    assembled on the host of the mesh's first rank (None on the other
    ranks; a host copy of ``t`` where the mesh is one rank).  Every
    rank of the mesh calls it; the slices travel over the gloo control
    group."""
    host = t.detach().to("cpu", copy=True).contiguous()
    group = getattr(mesh, "control_group", None)
    if group is None:
        return host
    n = dist.get_world_size(group)
    lead = dist.get_rank() == dist.get_global_rank(group, 0)
    parts = [torch.empty_like(host) for _ in range(n)] if lead else None
    dist.gather(host, parts, dst=dist.get_global_rank(group, 0), group=group)
    if not lead:
        return None
    sizes = axis_sizes(mesh)
    names = list(sizes)
    layout = mesh.mesh.reshape(-1).tolist()  # global rank of each position
    shape = list(host.shape)
    cut = _cut(spec, mesh)
    for d, _axes, k, _i in cut:
        shape[d] *= k
    whole = torch.empty(shape, dtype=host.dtype)
    for pos, grank in enumerate(layout):
        coord, rest = {}, pos
        for a in reversed(names):
            coord[a] = rest % sizes[a]
            rest //= sizes[a]
        view = whole
        for d, axes, _k, _i in cut:
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + coord[a]
            view = view.narrow(d, idx * host.shape[d], host.shape[d])
        view.copy_(parts[dist.get_group_rank(group, grank)])
    return whole
