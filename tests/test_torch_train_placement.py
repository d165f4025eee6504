"""The port's sharded step helpers (``repro_torch.launch.steps``) against
the JAX package's, on a 4x2 stub mesh (the device-free stub of
``tests/test_data_and_sharding.py``: the helpers read only axis names and
extents).

The JAX helpers wrap each spec in a ``NamedSharding`` or a
``ShapeDtypeStruct``, which a stub mesh cannot carry, so the tests stand
a recorder in for those two and compare specs entry for entry:
``param_shardings`` and ``memcom_shardings`` (every parameter of
gemma2-2b, smollm-135m and granite-moe-3b-a800m at full width, built on
the meta device; the JAX stack's leading "layers" axis aside, and with
the port's placement rule counted in heads: attention replicates over
"model" where a layer's heads do not split, and memx always does),
``opt_shardings`` (each AdamW entry its parameter's), ``act_sharding_for``,
``_batch_spec``, ``input_specs(mesh=)`` and ``default_rules_for``."""

import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import memcom as jmc
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.sharding import rules as jrules
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.launch import steps
from repro_torch.optim import AdamW
from repro_torch.sharding import rules


class _StubMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


class _Rec:
    """What a recorded ``NamedSharding`` / ``ShapeDtypeStruct`` holds (not
    a pytree node, so a tree of them flattens to them)."""

    def __init__(self, spec, shape=None, dtype=None):
        self.spec, self.shape, self.dtype = spec, shape, dtype


MESH = _StubMesh(data=4, model=2)
ARCHS = ["gemma2-2b", "smollm-135m", "granite-moe-3b-a800m"]


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(jrules, "NamedSharding", lambda m, s: _Rec(s))
    monkeypatch.setattr(jsteps, "NamedSharding", lambda m, s: _Rec(s))
    monkeypatch.setattr(jsteps, "_sds", lambda shape, dtype, sharding=None:
                        _Rec(getattr(sharding, "spec", None), shape, dtype))


def _same(a, b):
    return tuple(a) == tuple(b)


def _unsplit_heads(port_model, name):
    """Whether ``name``'s owner is an attention (or memx) whose heads do
    not split on the mesh (the port's placement rule)."""
    owner = port_model.get_submodule(name.rsplit(".", 1)[0]) \
        if "." in name else port_model
    heads = getattr(owner, "head_counts", None)
    return heads is not None and not rules.heads_split(*heads, MESH,
                                                       rules.FSDP_RULES)


def _check_against_jax(pcfg, got, abstract, jshard, jleaves, jaxes, kind):
    jflat = dict(tree_flatten_with_names(jshard))
    lflat = dict(tree_flatten_with_names(jleaves))
    names = dict(abstract.named_parameters())
    assert set(got) == set(names)
    for name, placement in got.items():
        path = bridge.jax_path(pcfg, kind, name)
        leaf, spec = lflat[path], jflat[path].spec
        shape, axes = tuple(leaf.shape), jaxes[path]
        if len(shape) == names[name].dim() + 1:  # a stacked period leaf
            shape, axes, spec = shape[1:], axes[1:], tuple(spec)[1:]
        assert shape == tuple(names[name].shape), name
        if _unsplit_heads(abstract, name):
            axes = tuple(None if a in ("heads", "kv_heads") else a
                         for a in axes)
            spec = jrules.spec_for(shape, axes, MESH, jrules.FSDP_RULES)
        assert placement.mesh is MESH
        assert _same(placement.spec, tuple(spec) + (None,) * (
            len(shape) - len(tuple(spec)))), (name, placement.spec, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_jax(recorded, arch):
    got, abstract = steps.param_shardings(port_config(arch), MESH)
    assert all(p.is_meta for p in abstract.parameters())
    jsh, jabs = jsteps.param_shardings(get_config(arch), MESH)
    jaxes = jrules._flatten_axes(jtfm.param_specs(get_config(arch)))
    _check_against_jax(port_config(arch), got, abstract, jsh, jabs, jaxes,
                       "transformer")


@pytest.mark.parametrize("arch", ARCHS)
def test_memcom_shardings_match_jax(recorded, arch):
    got, abstract = steps.memcom_shardings(port_config(arch), MESH)
    jsh, jabs = jsteps.memcom_shardings(get_config(arch), MESH)
    jaxes = jrules._flatten_axes(jmc.memcom_axes(get_config(arch)))
    _check_against_jax(port_config(arch), got, abstract, jsh, jabs, jaxes,
                       "memcom")
    # memx: d_model over the data axes, replicated over "model"
    assert _same(got["memx.0.wq"].spec, ("data", None))
    assert _same(got["mem_tokens"].spec, (None, "data"))


def test_opt_shardings_follow_their_parameters():
    cfg = port_config("gemma2-2b")
    psh, abstract = steps.memcom_shardings(cfg, MESH)
    params = {n: p for n, p in abstract.named_parameters()
              if n.startswith(("memx.0.", "mem_tokens"))}
    state = AdamW(lr=0.0).init(params)
    osh = steps.opt_shardings(state, psh, MESH)
    for kind in ("mu", "nu", "master"):
        assert set(osh[kind]) == set(state[kind])
        for n in state[kind]:
            assert osh[kind][n] == psh[n]
    assert _same(osh["count"].spec, ())


@pytest.mark.parametrize("batch,seq", [(8, 64), (6, 64), (8, 1), (4, 33)])
def test_act_and_batch_specs_match_jax(recorded, batch, seq):
    cfg = port_config("gemma2-2b")
    got = steps.act_sharding_for(MESH, cfg, batch, seq)
    want = jsteps.act_sharding_for(MESH, get_config("gemma2-2b"), batch, seq)
    assert _same(got.spec, want.spec) and got.mesh is MESH
    for ndim in (2, 3):
        assert _same(steps._batch_spec(MESH, batch, ndim).spec,
                     jsteps._batch_spec(MESH, batch, ndim).spec)


@pytest.mark.parametrize("arch,shape", [
    ("gemma2-2b", "train_4k"), ("gemma2-2b", "decode_32k"),
    ("gemma2-2b", "prefill_32k"), ("mamba2-370m", "long_500k"),
    ("whisper-medium", "train_4k"), ("mamba2-370m", "train_4k")])
def test_input_specs_with_a_mesh_match_jax(recorded, arch, shape):
    got = steps.input_specs(arch, shape, mesh=MESH)
    want = jsteps.input_specs(arch, shape, MESH)
    assert set(got) == set(want)
    for k, spec in got.items():
        assert tuple(spec.shape) == tuple(want[k].shape), k
        w = want[k].spec
        if w is None:
            assert spec.sharding is None, k
        else:
            assert _same(spec.sharding.spec, w), (k, spec.sharding.spec, w)
    plain = steps.input_specs(arch, shape)  # no mesh: no placement
    assert all(s.sharding is None for s in plain.values())


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("model", [1, 2, 16])
def test_default_rules_match_jax(arch, model):
    mesh = _StubMesh(data=4, model=model)
    got = steps.default_rules_for(port_config(arch), mesh)
    want = jsteps.default_rules_for(get_config(arch), mesh)
    assert got == want
