"""Pipeline parallelism over a stacked layer dimension
(``repro/sharding/pipeline.py``).

The period-stacked parameters (leading ``repeats`` dimension R) are split
across the ranks of the pipeline axis (``pod``): stage p holds layers
[p·R/P, (p+1)·R/P) (:func:`stage_slice` cuts them).  The batch is split
into M microbatches and a GPipe schedule runs T = M + P − 1 ticks: at
tick t stage p runs microbatch t − p, if there is one, and hands its
output to stage p + 1.

The hop is a point-to-point send / recv written as ``autograd.Function``
s, so the gradient rides the reverse ring: the receiving stage's backward
sends the input gradient back, the sending stage's backward receives it.
gloo does not send CUDA tensors, so every hop is staged through the host
explicitly (a copy to the host, the send, a copy back to the card).
Sends are non-blocking (``isend``) and waited at the end of the pass that
posted them, so no two stages wait on each other's order.  The last
stage banks the finished microbatches; every stage leaves with the full
output, the last stage's copy summed with the others' zeros over the
pipeline group, as the JAX version's masked ``psum`` gives, with an
identity backward (every rank's loss on the replicated output feeds the
last stage's chain once).

The JAX version runs the schedule as one ``lax.scan`` inside
``shard_map``; here each rank runs its own ticks and computes only where
it holds a microbatch.  Nothing in the training path calls it (as in the
JAX package, where only its test does).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.autograd import Function

from repro_torch.sharding.collectives import sum_over

_PENDING: list = []  # (work, host buffer) of sends not yet waited


def _wait_pending() -> None:
    while _PENDING:
        work, _buf = _PENDING.pop()
        work.wait()


def _isend(x: torch.Tensor, dst: int, tag: int) -> None:
    buf = x.detach().to("cpu", copy=True).contiguous()
    _PENDING.append((dist.isend(buf, dst, tag=tag), buf))


def _recv(shape, dtype, device, src: int, tag: int) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype)
    dist.recv(buf, src, tag=tag)
    return buf.to(device)


class _Send(Function):
    """Forward: post ``x`` to stage ``dst``; returns a zero scalar that
    the caller adds into its output, so the backward reaches this node.
    Backward: receive the gradient of ``x`` from ``dst``."""

    @staticmethod
    def forward(ctx, x, dst, tag):
        ctx.meta = (x.shape, x.dtype, x.device, dst, tag)
        _isend(x, dst, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        shape, dtype, device, dst, tag = ctx.meta
        return _recv(shape, dtype, device, dst, tag), None, None


class _Recv(Function):
    """Forward: receive a tensor from stage ``src``.  Backward: send its
    gradient back.  The ``anchors`` (the stage's parameters and input)
    tie the node to every gradient a caller may ask for, so that autograd
    never prunes it and leaves the sender waiting."""

    @staticmethod
    def forward(ctx, meta, *anchors):
        shape, dtype, device, src, tag = meta
        ctx.src, ctx.tag, ctx.n = src, tag, len(anchors)
        return _recv(shape, dtype, device, src, tag)

    @staticmethod
    def backward(ctx, g):
        _isend(g, ctx.src, ctx.tag)
        torch.autograd.Variable._execution_engine.queue_callback(
            _wait_pending)
        return (None,) + (None,) * ctx.n


def stage_slice(period_params: Dict[str, torch.Tensor], mesh,
                axis: str = "pod") -> Dict[str, torch.Tensor]:
    """This stage's layers of every stacked leaf (R, ...) -> (R/P, ...)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    out = {}
    for k, v in period_params.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: {v.shape[0]} layers over {n} stages")
        part = v.shape[0] // n
        out[k] = v.narrow(0, idx * part, part)
    return out


def pipeline_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                   h: torch.Tensor, *, mesh, axis: str = "pod",
                   microbatches: int = 4) -> torch.Tensor:
    """Run this stage's layers (``stage_params``, its slice of the stack)
    as one of the P stages of a pipeline over ``axis``: semantically
    ``stage_fn`` over all R layers in order.  ``h`` (B, ...) is the whole
    input on every stage (stage 0 reads it); B must divide by
    ``microbatches``.  Returns the whole output on every stage."""
    group = mesh.get_group(axis)
    P = dist.get_world_size(group)
    idx = mesh.get_local_rank(axis)
    B = h.shape[0]
    M = microbatches
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = B // M
    q = h.reshape(M, mb, *h.shape[1:])
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) if idx < P - 1 else None
    anchors = [h, *stage_params.values()]
    tokens, banked = [], [None] * M
    for t in range(M + P - 1):
        m = t - idx  # the microbatch this stage holds at tick t
        if not 0 <= m < M:
            continue
        if prev is None:
            x = q[m]
        else:
            x = _Recv.apply((q.shape[1:], h.dtype, h.device, prev, m),
                            *anchors)
        y = stage_fn(stage_params, x)
        if nxt is not None:
            tokens.append(_Send.apply(y, nxt, m))
        else:
            banked[m] = y
    _wait_pending()
    if nxt is None:
        out = torch.stack(banked).reshape(h.shape)
    else:
        out = torch.zeros_like(h)
    for tok in tokens:
        out = out + tok
    return sum_over(out, group)


def stage_scan(apply_layer: Callable):
    """Lift a per-layer body ``apply_layer(layer_params, h) -> h`` into a
    stage function over this stage's (R/P, ...) slice: the body the
    sequential model loops over."""

    def stage_fn(params_slice, h):
        n = next(iter(params_slice.values())).shape[0]
        for i in range(n):
            h = apply_layer({k: v[i] for k, v in params_slice.items()}, h)
        return h

    return stage_fn
