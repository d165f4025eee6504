"""The collectives of the port's explicit placement, with their gradients:
the port's counterpart of what GSPMD inserts around a placed JAX program.

Tensor parallelism over the "model" axis (Megatron's pair):

* :func:`copy_to_model` (f): the identity forward; the backward sums the
  input gradient over the "model" ranks.  Every replicated activation
  entering a split block goes through it before ``wq`` / ``wk`` / ``wv``
  and ``wg`` / ``wi``: each rank's input gradient is the part of its own
  heads or ff columns, and the sum is the whole.
* :func:`matmul_reduce` (g): a product that contracts a split dimension
  (attention's and the MLP's ``wo``), its float32 partials summed over the
  ranks and rounded once; the backward is each rank's local product.
* :func:`reduce_model`: the vocabulary-split embedding's rows summed over
  the ranks; the backward is the identity.
* :func:`gather_model`: the vocabulary-split logits concatenated; the
  backward takes the rank's slice.

Data parallelism over the data axes:

* :func:`sum_over`: a sum over a group whose backward is the identity
  (the loss's numerator and the MoE's load statistics: each rank
  differentiates its own share, and the parameters' gradients are summed
  over the data ranks).
* :func:`gather_param`: a fully sharded (FSDP) parameter all-gathered over
  the data group before it is used; its gradient is reduce-scattered back
  to the rank's slice in float32.  The gathered tensor is tagged, and
  :func:`regather_saved` makes autograd keep a handle in its place and
  gather it again in the backward pass, so that no gathered weight stays
  alive between the passes.
* Where the gathers happen (FSDP's unshard and reshard): ``shard_module``
  registers :func:`unshard_hooks` on one module of each group of fully
  sharded parameters (a transformer block, a ``memx`` layer, the stack
  itself for its embedding table), which install the gathered tensors as
  the owners' attributes for the call and drop them after it, so model
  code reads ``p.wq`` as it does unsharded.  Code that reads a module's
  parameters outside a call of it says so with :func:`unsharded`.

Under ``torch.no_grad`` (serving) every function takes the plain path it
took before training's sharding came: no extra collective, no autograd
node.  gloo, which shares one card between ranks, takes CUDA tensors for
``all_reduce``, ``broadcast``, the list form of ``all_gather`` and
``reduce_scatter``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd import Function

__all__ = [
    "DataShard", "ModelShard", "copy_to_model", "gather_model",
    "gather_param", "matmul_reduce", "reduce_model", "regather_saved",
    "sum_over", "unshard_hooks", "unsharded",
]


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


@dataclass(frozen=True, eq=False)
class DataShard:
    """A fully sharded parameter's cut: dimension ``dim`` split into
    ``size`` equal parts over the data ``group``, this rank holding part
    ``rank``.  A deep copy keeps the same record."""
    dim: int
    group: object
    size: int
    rank: int

    def __deepcopy__(self, memo):
        return self


def _needs_graph(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in xs)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, summed in float32 and returned in
    ``x``'s type (a new tensor)."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Tensor parallelism ("model")
# ---------------------------------------------------------------------------


class _CopyToModel(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]):
    """Megatron's f: ``x`` itself; in the backward pass the gradient is
    summed over the "model" ranks.  The identity without a shard or a
    graph."""
    if shard is None or not _needs_graph(x):
        return x
    return _CopyToModel.apply(x, shard.group)


class _SumIdentityBwd(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_model(x: torch.Tensor, shard: Optional[ModelShard]):
    """Sum ``x`` over the ranks of the "model" axis in float32, returned
    in ``x``'s type (the vocabulary-split embedding's rows: one rank's
    row and zeros, an exact sum); the backward is the identity.  The
    identity without a shard."""
    if shard is None:
        return x
    if _needs_graph(x):
        return _SumIdentityBwd.apply(x, shard.group)
    return _all_reduce_f32(x, shard.group)


def sum_over(x: torch.Tensor, group):
    """``x`` summed over ``group`` (in float32, returned in ``x``'s
    type); the backward is the identity, so each rank differentiates its
    own share of the sum.  ``x`` itself where ``group`` is None."""
    if group is None:
        return x
    if _needs_graph(x):
        return _SumIdentityBwd.apply(x, group)
    return _all_reduce_f32(x, group)


def _partial_product(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x2 @ w`` in float32: on the card ``torch.mm(...,
    out_dtype=float32)`` where this PyTorch has it (bf16 operands,
    float32 accumulator), else the float32 product of the widened
    operands."""
    if x2.is_cuda and x2.dtype in (torch.bfloat16, torch.float16):
        try:
            return torch.mm(x2, w, out_dtype=torch.float32)
        except (TypeError, RuntimeError):  # a PyTorch without out_dtype
            pass
    return x2.float() @ w.float()


class _MatmulReduce(Function):
    @staticmethod
    def forward(ctx, x2, w, group):
        ctx.save_for_backward(x2, w)
        y = _partial_product(x2, w)
        dist.all_reduce(y, group=group)
        return y.to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = x2.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gw, None


def matmul_reduce(x: torch.Tensor, w: torch.Tensor,
                  shard: Optional[ModelShard]):
    """``x @ w`` where ``w`` is a row slice of the whole weight and ``x``
    the matching column slice of the activations: each rank's partial
    product is formed in float32, summed over the "model" ranks in
    float32 and rounded once to ``x``'s type, as the unsplit bf16 product
    rounds its float32 accumulator once.  Rounding each partial to bf16
    before the sum would add a rounding a layer.  The backward is each
    rank's local product: the gradient of its column slice of ``x`` and of
    its row slice of ``w``, as the unsplit product's backward forms them.
    The plain ``x @ w`` without a shard."""
    if shard is None:
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _needs_graph(x2, w):
        y = _MatmulReduce.apply(x2, w, shard.group)
    else:
        y = _partial_product(x2, w)
        dist.all_reduce(y, group=shard.group)
        y = y.to(x.dtype)
    return y.reshape(*lead, w.shape[-1])


#: gloo stages a CUDA tensor through the host; a gather of more bytes than
#: this goes as that many-byte pieces in flight together, so that one
#: piece's copies overlap another's transfer (PERF.md, section 6)
GLOO_PIECE_BYTES = 32 << 20


def _gather_cat(x: torch.Tensor, dim: int, size: int, group):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    n = x.numel()
    step = max(GLOO_PIECE_BYTES // x.element_size(), 1)
    if n <= step or dist.get_backend(group) != "gloo":
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)
    flat = x.view(-1)
    out = torch.empty((size, n), dtype=x.dtype, device=x.device)
    works = [dist.all_gather([out[r, i:i + step] for r in range(size)],
                             flat[i:i + step], group=group, async_op=True)
             for i in range(0, n, step)]
    for w in works:
        w.wait()
    return torch.cat([out[r].view(x.shape) for r in range(size)], dim=dim)


class _GatherModel(Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard, ctx.part = dim, shard, x.shape[dim]
        return _gather_cat(x, dim, shard.size, shard.group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.shard.rank * ctx.part,
                        ctx.part), None, None


def gather_model(x: torch.Tensor, dim: int, shard: Optional[ModelShard]):
    """Concatenate the ranks' slices of ``x`` along ``dim`` in rank order
    (the list form of ``all_gather``, which gloo takes for CUDA tensors
    too); the backward takes the rank's slice of the gradient.  The
    identity without a shard."""
    if shard is None:
        return x
    if _needs_graph(x):
        return _GatherModel.apply(x, dim, shard)
    return _gather_cat(x, dim, shard.size, shard.group)


# ---------------------------------------------------------------------------
# Fully sharded parameters (data axes)
# ---------------------------------------------------------------------------


def _reduce_scatter_f32(g: torch.Tensor, cut: DataShard) -> torch.Tensor:
    """The rank's slice of ``g`` summed over the data group, in float32,
    returned in ``g``'s type."""
    parts = [p.contiguous() for p in g.to(torch.float32).chunk(cut.size,
                                                               cut.dim)]
    out = torch.empty_like(parts[cut.rank])
    dist.reduce_scatter(out, parts, group=cut.group)
    return out.to(g.dtype)


class _GatherParam(Function):
    @staticmethod
    def forward(ctx, shard, cut):
        ctx.cut = cut
        return _gather_cat(shard, cut.dim, cut.size, cut.group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_f32(g, ctx.cut), None


def gather_param(shard: torch.Tensor, cut: DataShard) -> torch.Tensor:
    """The whole parameter from the data ranks' slices (all-gathered
    along ``cut.dim``); where the slice is trained, its gradient is the
    whole gradient reduce-scattered back over the data group.  The result
    is tagged for :func:`regather_saved`."""
    if _needs_graph(shard):
        whole = _GatherParam.apply(shard, cut)
    else:
        whole = _gather_cat(shard.detach(), cut.dim, cut.size, cut.group)
    whole._fsdp_source = (shard, cut)
    return whole


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    src = getattr(base, "_fsdp_source", None)
    if src is None:
        return t
    return (_Regather, src, t.size(), t.stride(), t.storage_offset())


def _unpack(x):
    if isinstance(x, tuple) and x and x[0] is _Regather:
        _, (shard, cut), size, stride, offset = x
        whole = _gather_cat(shard.detach(), cut.dim, cut.size, cut.group)
        return whole.as_strided(size, stride, offset)
    return x


class _Regather:
    """The marker of a saved gathered parameter (:func:`regather_saved`)."""


@contextlib.contextmanager
def regather_saved():
    """While active, a gathered parameter (or a view of one) that autograd
    saves for the backward pass is kept as its slice and gathered again
    when the backward pass reads it: the fully sharded step holds only
    its slices between the passes."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


def _install(owner) -> tuple:
    """Gather ``owner``'s own fully sharded parameters (its ``_fsdp``) and
    set each whole tensor in the module's ``__dict__``, where attribute
    lookup finds it before the slice in ``_parameters``; returns the names
    set.  A name set already (by an enclosing call) is left to it."""
    cuts = owner.__dict__.get("_fsdp")
    if not cuts:
        return ()
    names = tuple(n for n in cuts if n not in owner.__dict__)
    for n in names:
        owner.__dict__[n] = gather_param(owner._parameters[n], cuts[n])
    return names


def _release(owner, names) -> None:
    for n in names:
        owner.__dict__.pop(n, None)


@contextlib.contextmanager
def unsharded(*modules):
    """While active, the fully sharded parameters that ``modules`` hold
    themselves (not their submodules') read as the whole tensors,
    gathered over the data ranks on entry: FSDP's explicit unshard, for
    code that reads a module's parameters outside a call of it.  Nothing
    is gathered for a module without such parameters (every module off a
    data mesh)."""
    done = [(m, _install(m)) for m in modules]
    try:
        yield
    finally:
        for m, names in done:
            _release(m, names)


def _unshard_pre(module, args):
    module._fsdp_live.append([(path, _install(module.get_submodule(path)))
                              for path in module._fsdp_units])


def _unshard_post(module, args, output):
    for path, names in module._fsdp_live.pop():
        _release(module.get_submodule(path), names)


def unshard_hooks(unit, path: str) -> None:
    """Make each call of ``unit`` read the fully sharded parameters of its
    submodule ``path`` ("" for itself) whole: gathered by a forward-pre
    hook, dropped by a forward hook that runs whether the call returns or
    raises.  The hooks find the owners by path from the module they are
    called on, so a deep copy of ``unit`` gathers its own slices."""
    units = unit.__dict__.get("_fsdp_units")
    if units is None:
        unit._fsdp_units, unit._fsdp_live = (), []
        unit.register_forward_pre_hook(_unshard_pre)
        unit.register_forward_hook(_unshard_post, always_call=True)
        units = ()
    if path not in units:
        unit._fsdp_units = units + (path,)
