"""Train-step builder (``repro/train/train_step.py``): gradients + optional
microbatch accumulation + optional bf16 gradient rounding + clip +
optimizer step.

``params`` is a flat name-keyed dict of the tensors to train (leaves of
live modules: ``loss_fn`` reads them through the modules).  The returned
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
updates ``params`` and the state in place and returns them.  Gradients
are formed for the tensors that require one; a trained tensor the loss
does not reach gets a zero gradient, as JAX gives it.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim import clip_by_global_norm, compress_grads_bf16


def build_train_step(loss_fn: Callable, optimizer, *, clip: float = 1.0,
                     accum: int = 1, grad_bf16: bool = False):
    """loss_fn(params, batch) -> (loss, aux_dict); batch a dict of tensors
    whose leading axis is the batch (split into ``accum`` microbatches)."""

    def grads_of(params, batch):
        names = [n for n, p in params.items() if p.requires_grad]
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), aux, dict(zip(names, grads))

    def train_step(params, opt_state, batch):
        if accum > 1:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items() if p.requires_grad}
            loss = None
            for i in range(accum):
                mb = {k: torch.chunk(x, accum)[i] if torch.is_tensor(x) else x
                      for k, x in batch.items()}
                l_i, _aux, grads = grads_of(params, mb)
                for n, g in grads.items():
                    gsum[n] = gsum[n] + g.to(torch.float32) / accum
                loss = (torch.zeros((), dtype=torch.float32, device=l_i.device)
                        if loss is None else loss) + l_i / accum
            grads, aux = gsum, {}
        else:
            loss, aux, grads = grads_of(params, batch)
        if grad_bf16:
            grads = compress_grads_bf16(grads)
        grads, gnorm = clip_by_global_norm(grads, clip)
        opt_state = optimizer.step(params, grads, opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm}
        for k, v in (aux or {}).items():
            metrics[k] = v.detach() if torch.is_tensor(v) else v
        return params, opt_state, metrics

    return train_step
