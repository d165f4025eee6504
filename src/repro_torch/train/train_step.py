"""Train-step builder (``repro/train/train_step.py``): gradients + optional
microbatch accumulation + optional bf16 gradient rounding + clip +
optimizer step.

``params`` is a flat name-keyed dict of the tensors to train (leaves of
live modules: ``loss_fn`` reads them through the modules).  The returned
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
updates ``params`` and the state in place and returns them.  Gradients
are formed for the tensors that require one; a trained tensor the loss
does not reach gets a zero gradient, as JAX gives it.

Under a mesh (``placement``, a :class:`~repro_torch.sharding.training.
TrainPlacement`) ``params`` are this rank's slices and the loss is the
global one on every rank (``next_token_loss`` sums over the data ranks):
the forward and backward run inside ``placement.running()``, the
gradients of leaves replicated over the data axis are summed over it
(the fully sharded ones were reduce-scattered by autograd), ``grad_bf16``
rounds the reduced gradient, as the JAX step's ``value_and_grad`` returns
it reduced, and the clip's norm sums each leaf's squares over the ranks
that hold distinct slices of it.  AdamW runs on the slices unchanged.
"""

from __future__ import annotations

from typing import Callable

import contextlib

import torch

from repro_torch.optim import clip_by_global_norm, compress_grads_bf16


def build_train_step(loss_fn: Callable, optimizer, *, clip: float = 1.0,
                     accum: int = 1, grad_bf16: bool = False,
                     placement=None):
    """loss_fn(params, batch) -> (loss, aux_dict); batch a dict of tensors
    whose leading axis is the batch (split into ``accum`` microbatches).
    The returned step's ``grads(params, batch)`` gives (loss, aux,
    gradients) as the step forms them, reduced over the mesh; the step
    calls it through that attribute, so a caller may wrap it to see each
    step's gradients."""
    running = (placement.running if placement is not None
               else contextlib.nullcontext)
    norm_groups = placement.norm_groups() if placement is not None else None

    def grads_of(params, batch):
        names = [n for n, p in params.items() if p.requires_grad]
        with running():
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(names, grads))
        if placement is not None:
            grads = placement.sync(grads)
        return loss.detach(), aux, grads

    def train_step(params, opt_state, batch):
        if accum > 1:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items() if p.requires_grad}
            loss = None
            for i in range(accum):
                mb = {k: torch.chunk(x, accum)[i] if torch.is_tensor(x) else x
                      for k, x in batch.items()}
                l_i, _aux, grads = train_step.grads(params, mb)
                for n, g in grads.items():
                    gsum[n] = gsum[n] + g.to(torch.float32) / accum
                loss = (torch.zeros((), dtype=torch.float32, device=l_i.device)
                        if loss is None else loss) + l_i / accum
            grads, aux = gsum, {}
        else:
            loss, aux, grads = train_step.grads(params, batch)
        if grad_bf16:
            grads = compress_grads_bf16(grads)
        grads, gnorm = clip_by_global_norm(grads, clip, norm_groups)
        opt_state = optimizer.step(params, grads, opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm}
        for k, v in (aux or {}).items():
            metrics[k] = v.detach() if torch.is_tensor(v) else v
        return params, opt_state, metrics

    train_step.grads = grads_of
    train_step.placement = placement
    return train_step
