"""``repro_torch.sharding.ctx`` against ``repro.sharding.ctx``: the JAX
``tests/test_ctx.py`` cases that run on one CPU device, each on both
packages, and the group count of ``moe_dispatch_plan``.

Under explicit placement a rank's residual stream already is its batch
shard, so the port's ``constrain`` and ``head_sharded`` return their
input on and off a mesh (the JAX functions add a constraint GSPMD keeps);
the installed placement decides the MoE's dispatch groups and the data
group of the loss's sums.  The group counts are read on stub meshes (the
plan reads only axis names and extents): the JAX function's count for
the global batch, of which each data rank holds one group."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.sharding import ctx as jctx
from repro_torch.sharding import ctx
from repro_torch.sharding.rules import PartitionSpec, Placement


class _StubMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


def _both(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_constrain_noop_without_context(rng):
    jx, tx = _both(rng, (2, 4, 8))
    assert jctx.constrain(jx) is jx
    assert ctx.constrain(tx) is tx
    assert ctx.head_sharded(torch.zeros(1, 2, 4, 8)) is not None
    assert ctx._ACT is None and ctx.data_group() is None


def test_moe_plan_noop_without_context(rng):
    jx, tx = _both(rng, (2, 4, 8))
    out, groups = jctx.moe_dispatch_plan(jx)
    assert out is jx and groups is None
    out, groups = ctx.moe_dispatch_plan(tx)
    assert out is tx and groups is None


def test_moe_plan_disabled_switch():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    pmesh = _StubMesh(data=2, model=1)
    x = torch.zeros((4, 4, 8))
    with jctx.act_sharding(NamedSharding(jmesh, P("data", "model", None))):
        with jctx.moe_plan_disabled():
            assert jctx.moe_dispatch_plan(jnp.zeros((4, 4, 8)))[1] is None
    with ctx.act_sharding(Placement(pmesh, PartitionSpec("data", "model",
                                                         None))):
        assert ctx.moe_dispatch_plan(x) == (x, 2)
        with ctx.moe_plan_disabled():
            out, groups = ctx.moe_dispatch_plan(x)
            assert out is x and groups is None
        assert ctx.moe_dispatch_plan(x)[1] == 2  # switch restored
    out, groups = ctx.moe_dispatch_plan(x)  # context restored
    assert out is x and groups is None


def test_act_sharding_context_restores():
    sh = Placement(_StubMesh(data=1, model=1), PartitionSpec("data", None,
                                                             None))
    x = torch.zeros((2, 4, 8))
    with ctx.act_sharding(sh):
        assert ctx._ACT is sh
        assert ctx.constrain(x) is x  # the rank's shard already
        with ctx.act_sharding(None):
            assert ctx._ACT is None
        assert ctx._ACT is sh
    assert ctx._ACT is None
    ctx.set_act_sharding(sh)
    try:
        assert ctx._ACT is sh
    finally:
        ctx.set_act_sharding(None)


def test_constrain_skips_mismatched_rank():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jctx.act_sharding(NamedSharding(jmesh, P("data", None, None))):
        x2d = jnp.zeros((2, 4))
        assert jctx.constrain(x2d) is x2d
    with ctx.act_sharding(Placement(_StubMesh(data=2, model=1),
                                    PartitionSpec("data", None, None))):
        x2d = torch.zeros((2, 4))
        assert ctx.constrain(x2d) is x2d
        assert ctx.moe_dispatch_plan(x2d) == (x2d, None)


@pytest.mark.parametrize("data,model,experts,batch_axis,want", [
    (1, 1, 8, "data", None),     # one data rank: no plan (JAX: n <= 1)
    (2, 1, 5, "data", 2),        # granite-smoke's 5 experts, model 1
    (4, 2, 8, "data", 4),        # experts divide "model"
    (4, 2, 5, "data", None),     # they do not: no plan
    (2, 2, 0, "data", 2),        # expert count not given
    (2, 1, 8, None, None),       # batch not placed on the data axis
    (8, 1, 40, ("data",), 8),    # a one-axis tuple reads as the axis
])
def test_moe_dispatch_plan_group_count(data, model, experts, batch_axis,
                                       want):
    mesh = _StubMesh(data=data, model=model)
    x = torch.zeros((data * 2, 4, 8))  # the global batch divides the axis
    with ctx.act_sharding(Placement(mesh, PartitionSpec(batch_axis, "model",
                                                        None))):
        out, groups = ctx.moe_dispatch_plan(x, experts)
    assert out is x and groups == want


def test_one_device_group_count_matches_jax():
    """On a 1x1 mesh both packages plan no groups (the JAX function's
    only mesh that runs here)."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jctx.act_sharding(NamedSharding(jmesh, P("data", "model", None))):
        want = jctx.moe_dispatch_plan(jnp.zeros((4, 4, 8)), 8)[1]
    with ctx.act_sharding(Placement(_StubMesh(data=1, model=1),
                                    PartitionSpec("data", "model", None))):
        got = ctx.moe_dispatch_plan(torch.zeros((4, 4, 8)), 8)[1]
    assert got == want is None
