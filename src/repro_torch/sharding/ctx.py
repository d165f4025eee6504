"""The activation-placement context (``repro/sharding/ctx.py``).

The JAX launcher installs a residual-stream constraint (batch over the
data axes, sequence over "model") that GSPMD keeps at every block
boundary, and the MoE reads it to group its dispatch by batch shard.
The port places explicitly: a rank's residual stream already is its
batch shard, with its own heads inside a split attention.  So
:func:`constrain` and :func:`head_sharded` return their input, and the
installed :class:`~repro_torch.sharding.rules.Placement` is read for two
things only:

* :func:`moe_dispatch_plan`: the dispatch group count the JAX MoE takes
  under the same placement (one group a data rank: each rank dispatches
  its own batch);
* :func:`data_group`: the process group over which the loss's numerator
  and denominator and the MoE's load statistics are summed (the JAX
  package's global sums over a sharded batch).

The sequence split over "model" that ``act_sharding_for`` names is not
taken: each rank keeps its batch shard's captured hiddens whole over
"model" (ROADMAP deviations).  Use :func:`act_sharding` as a context
manager so that a placement cannot leak::

    with act_sharding(act_sharding_for(mesh, cfg, batch, seq)):
        ...
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

from repro_torch.sharding.rules import Placement, axis_sizes

_ACT: Optional[Placement] = None
_MOE_PLAN = True


def set_act_sharding(sharding: Optional[Placement]) -> None:
    global _ACT
    _ACT = sharding


@contextlib.contextmanager
def act_sharding(sharding: Optional[Placement]):
    global _ACT
    prev = _ACT
    _ACT = sharding
    try:
        yield
    finally:
        _ACT = prev


def constrain(h):
    """The JAX function applies the (B, S, D) constraint; under explicit
    placement ``h`` already is the rank's batch shard, so it returns
    ``h``."""
    return h


def head_sharded(x):
    """``x`` itself: a rank's attention operands already hold its heads
    (the JAX function constrains heads over "model")."""
    return x


@contextlib.contextmanager
def moe_plan_disabled():
    """Ablation switch: the MoE dispatches without the batch-shard plan."""
    global _MOE_PLAN
    prev = _MOE_PLAN
    _MOE_PLAN = False
    try:
        yield
    finally:
        _MOE_PLAN = prev


def _batch_axes(sharding: Placement):
    b = sharding.spec[0] if len(sharding.spec) else None
    if b is None:
        return ()
    return (b,) if isinstance(b, str) else tuple(b)


def _data_extent(sharding: Placement) -> int:
    sizes = axis_sizes(sharding.mesh)
    return math.prod(sizes[a] for a in _batch_axes(sharding))


def moe_dispatch_plan(x, num_experts: int = 0):
    """``(x, dispatch group count)``: the JAX function's count for the
    global batch under the installed placement.  With the batch over data
    axes of extent n > 1 and experts that divide "model", the JAX MoE
    dispatches in n batch groups; here each data rank holds one of them
    (its batch shard), so the MoE dispatches its own tokens as one group.
    ``(x, None)`` off-mesh, under :func:`moe_plan_disabled`, for a tensor
    of another rank than the placement's, or where the experts do not
    divide "model".  ``x`` is returned as it is (the JAX function's
    batch-only reshard is the rank's own batch here)."""
    if not _MOE_PLAN or _ACT is None or x.dim() != len(_ACT.spec):
        return x, None
    if num_experts and num_experts % axis_sizes(_ACT.mesh).get("model", 1):
        return x, None
    n = _data_extent(_ACT)
    if n <= 1:
        return x, None
    return x, n


def data_group():
    """The process group of the installed placement's batch axes (the
    data ranks that hold the other batch shards), or None off-mesh and
    where that extent is 1."""
    if _ACT is None:
        return None
    axes = _batch_axes(_ACT)
    if _data_extent(_ACT) <= 1:
        return None
    if len(axes) != 1:
        raise NotImplementedError(
            f"a batch over the axes {axes}: the port's data groups span "
            "one axis (ROADMAP Queue 1 step 5.3)")
    return _ACT.mesh.get_group(axes[0])
