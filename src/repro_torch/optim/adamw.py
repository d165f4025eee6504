"""AdamW with float32 master weights (``repro/optim/adamw.py``).

Parameters are a flat name-keyed dict of the tensors that are trained
(``core.memcom.set_trainable`` gives it), and the state holds an entry for
each of them and for nothing else, so frozen parameters (the target in
both MemCom phases, the two LLM stacks in Phase 1) cost no optimizer
memory::

    {"mu": {name: f32}, "nu": {name: f32}, "master": {name: f32},
     "count": int32 scalar}

``master`` holds a float32 copy of each trainable parameter stored in a
narrower type.  Unlike the JAX optimizer, :meth:`AdamW.step` updates the
parameters and the state in place (the memory of a second copy of every
trained tensor is saved) and returns the state; the arithmetic is the
reference's, in float32, element for element.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch


class AdamW:
    def __init__(self, lr: Callable | float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr = lr if callable(lr) else (lambda _: torch.tensor(
            lr, dtype=torch.float32))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    @torch.no_grad()
    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        names = list(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        first = next(iter(params.values()))
        return {"mu": {n: zeros(params[n]) for n in names},
                "nu": {n: zeros(params[n]) for n in names},
                "master": {n: params[n].detach().float().clone()
                           for n in names
                           if params[n].dtype != torch.float32},
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor], state: dict) -> dict:
        """One update of every parameter, in place; returns the state
        (also updated in place)."""
        count = state["count"] + 1
        f32 = dict(dtype=torch.float32, device=count.device)
        lr = torch.as_tensor(self.lr(count), **f32)
        b1, b2 = self.b1, self.b2  # python floats, as the reference's
        cf = count.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        wd = self.weight_decay
        mu, nu, master = state["mu"], state["nu"], state["master"]
        for n, p in params.items():
            g32 = grads[n].to(torch.float32)
            mu[n] = b1 * mu[n] + (1 - b1) * g32
            nu[n] = b2 * nu[n] + (1 - b2) * (g32 * g32)
            p32 = master.get(n, p.to(torch.float32))
            upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + self.eps)
            p32 = p32 - lr * (upd + wd * p32)
            if n in master:
                master[n] = p32
            p.copy_(p32.to(p.dtype))
        state["count"] = count
        return state
