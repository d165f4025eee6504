"""The port's placement rules against the JAX package's, on the CPU.

``spec_for`` reads only a mesh's axis names and extents, so stub meshes
stand in for the 1x2, 1x4, 2x2, 16x16 and 2x16x16 meshes
(``tests/test_data_and_sharding.py``'s device-free stub): under each of
the four rule sets the port's ``spec_for`` (every parameter leaf of every
arch at full width), ``leaf_spec`` / ``cache_shardings`` (every cache and
prefix leaf key, divisible and not) and ``batch_sharding`` equal the JAX
functions' entry for entry.  ``param_specs`` of the port's modules, built
on the ``meta`` device (a 236B model allocates nothing), equals
``repro.models.transformer.param_specs`` and ``repro.core.memcom.
memcom_axes`` through ``bridge.jax_path``, the JAX stack's leading
``"layers"`` axis aside.  The placement rule counted in heads
(``module_specs``) replicates a layer's attention where its heads do not
split, and only there.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.sharding import rules as jrules
from repro.sharding import serving as jserving
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.models import transformer as tfm
from repro_torch.models.param import param_specs
from repro_torch.sharding import rules, serving

RULE_SETS = {"baseline": "BASELINE_RULES", "fsdp": "FSDP_RULES",
             "layers_fsdp": "LAYERS_FSDP_RULES",
             "fsdp_ep_embed": "FSDP_EP_EMBED_RULES"}


class _StubMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {"1x2": _StubMesh(data=1, model=2), "1x4": _StubMesh(data=1, model=4),
          "2x2": _StubMesh(data=2, model=2),
          "16x16": _StubMesh(data=16, model=16),
          "2x16x16": _StubMesh(pod=2, data=16, model=16)}
CASES = [(m, r) for m in MESHES for r in RULE_SETS]


def _rules(name):
    return getattr(rules, RULE_SETS[name]), getattr(jrules, RULE_SETS[name])


def _same(port_spec, jax_spec):
    return tuple(port_spec) == tuple(jax_spec)


def test_rule_tables_are_the_reference_tables():
    for name in RULE_SETS:
        port, ref = _rules(name)
        assert port == ref


_LEAVES = {}


def _jax_leaves():
    """(shape, logical axes) of every parameter leaf of every arch at full
    width (abstract: nothing allocated), memcom's memx too."""
    if not _LEAVES:
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            axes = jrules._flatten_axes(jtfm.param_specs(cfg))
            for name, leaf in tree_flatten_with_names(
                    jtfm.abstract_params(cfg)):
                _LEAVES[(tuple(leaf.shape), axes[name])] = None
            if cfg.memcom is not None:
                maxes = jrules._flatten_axes(jmc.memcom_axes(cfg)["memx"])
                mc = jmc.init_memcom(cfg, jtfm.abstract_params(cfg),
                                     abstract=True)
                for name, leaf in tree_flatten_with_names(mc["memx"]):
                    _LEAVES[(tuple(leaf.shape), maxes[name])] = None
        # dims that do not divide (granite's 49155-row vocabulary and 40
        # experts) and an axis wanted twice
        for extra in (((49155, 1536), ("vocab", "embed")),
                      ((40, 1536, 512), ("expert", "embed", "ff")),
                      ((32, 32), ("heads", "ff")), ((17, 64), (None, None)),
                      ((3, 96), ("embed", "heads"))):
            _LEAVES[extra] = None
    return list(_LEAVES)


@pytest.mark.parametrize("mesh,rule", CASES)
def test_spec_for_matches_jax(mesh, rule):
    port_rules, jax_rules = _rules(rule)
    m = MESHES[mesh]
    leaves = _jax_leaves()
    assert len(leaves) > 100
    for shape, axes in leaves:
        got = rules.spec_for(shape, axes, m, port_rules)
        want = jrules.spec_for(shape, axes, m, jax_rules)
        assert _same(got, want), (shape, axes, got, want)


# cache / prefix / store-row leaves: (key, shape) with the head axis
# trailing, divisible and not by 2, 4 and 16
CACHE_LEAVES = [
    ("k", (4, 64, 8, 16)), ("v", (4, 64, 8, 16)), ("k", (4, 64, 3, 16)),
    ("k", (33, 16, 4, 256)), ("v", (33, 16, 2, 128)), ("k", (512, 4, 16)),
    ("ck", (2, 1500, 16, 64)), ("cv", (2, 1500, 6, 64)),
    ("ckv", (4, 64, 512)), ("kr", (4, 64, 64)), ("h", (1, 512, 2304)),
    ("conv", (4, 3, 1536)), ("conv", (4, 3, 100)),
    ("ssm", (4, 32, 64, 128)), ("ssm", (4, 6, 64, 128)),
    ("other", (4, 8)), ("k", (16,)), (None, (4, 8, 16))]


@pytest.mark.parametrize("mesh,rule", CASES)
def test_leaf_spec_matches_jax(mesh, rule):
    port_rules, jax_rules = _rules(rule)
    m = MESHES[mesh]
    for key, shape in CACHE_LEAVES:
        got = serving.leaf_spec(key, len(shape), shape, m, port_rules)
        want = jserving.leaf_spec(key, len(shape), shape, m, jax_rules)
        assert _same(got, want), (key, shape, got, want)


@pytest.mark.parametrize("mesh,rule", CASES)
def test_cache_shardings_match_jax(mesh, rule):
    """The port's per-layer list tree against the JAX tree of the same
    leaves (the JAX function reads only ``ndim`` / ``shape``)."""
    port_rules, jax_rules = _rules(rule)
    m = MESHES[mesh]
    keys = [key for key, _ in CACHE_LEAVES if key is not None]
    shapes = [shape for key, shape in CACHE_LEAVES if key is not None]
    port_tree = [{key: torch.empty(shape, device="meta")}
                 for key, shape in zip(keys, shapes)]
    jax_tree = {"prefix": [{key: jax.ShapeDtypeStruct(shape, np.float32)}
                           for key, shape in zip(keys, shapes)]}
    got = serving.cache_shardings(port_tree, m, port_rules)
    want = jserving.cache_shardings(jax_tree, m, jax_rules)
    for g, w, key in zip(got, want["prefix"], keys):
        assert _same(g[key].spec, w[key].spec), key


@pytest.fixture(autouse=True)
def _named_sharding(monkeypatch):
    """The JAX ``cache_shardings`` / ``batch_sharding`` wrap each spec in a
    ``NamedSharding``, which wants real devices: record the spec alone."""
    class Named:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec

    monkeypatch.setattr(jserving, "NamedSharding", Named)
    monkeypatch.setattr(jrules, "NamedSharding", Named)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_matches_jax(mesh):
    m = MESHES[mesh]
    for ndim, batch_dim in ((1, 0), (2, 0), (3, 0), (3, 1), (4, 2)):
        got = rules.batch_sharding(m, ndim, batch_dim)
        want = jrules.batch_sharding(m, ndim, batch_dim)
        assert _same(got.spec, want.spec), (ndim, batch_dim)
        assert got.mesh is m
    assert _same(rules.replicated(m).spec, jrules.replicated(m).spec)


def _strip_layers(port_axes, jax_axes):
    """The JAX stack's leading "layers" entry (period and encoder layers
    are stacked there, one module a layer here)."""
    if len(jax_axes) == len(port_axes) + 1 and jax_axes[0] == "layers":
        return jax_axes[1:]
    return jax_axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch):
    cfg = get_config(arch)
    pcfg = port_config(arch)
    target = tfm.Transformer(pcfg, device="meta", dtype=torch.float32)
    want = jrules._flatten_axes(jtfm.param_specs(cfg))
    got = param_specs(target)
    assert len(got) >= len(want)
    for name, axes in got.items():
        jpath = bridge.jax_path(pcfg, "transformer", name)
        assert axes == _strip_layers(axes, want[jpath]), name
    if cfg.memcom is None:
        return
    mc = memcom.MemCom(pcfg, target, tfm.Transformer(
        pcfg, device="meta", dtype=torch.float32))
    want = jrules._flatten_axes(jmc.memcom_axes(cfg))
    for name, axes in param_specs(mc).items():
        jpath = bridge.jax_path(pcfg, "memcom", name)
        assert axes == _strip_layers(axes, want[jpath]), name


@pytest.mark.parametrize("arch,n,attn_split", [
    ("smollm-135m", 2, False),     # 3/3 heads
    ("qwen2-vl-2b", 2, True),      # 4/2 heads
    ("qwen2-vl-2b", 4, False),
    ("gemma2-2b", 2, True),        # 4/2 heads
    ("gemma2-2b", 4, False),
    ("mistral-7b", 2, True),       # 4/2 heads
])
def test_placement_rule_counts_heads(arch, n, attn_split):
    """``module_specs`` splits a layer's attention only where its query and
    KV heads both divide the model axis; its other leaves follow
    ``spec_for``.  The JAX rule would split 3 heads of 32 on 2 ranks at
    the middle of a head (the flattened 96 divides 2)."""
    cfg = port_smoke_config(arch)
    model = tfm.Transformer(cfg, device="meta", dtype=torch.float32)
    mesh = _StubMesh(data=1, model=n)
    specs = rules.module_specs(model, mesh, rules.BASELINE_RULES)
    axes = param_specs(model)
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        if ".attn." in name:
            split = any(e == "model" for e in spec)
            assert split == attn_split, name
        else:
            assert _same(spec, rules.spec_for(
                tuple(params[name].shape), axes[name], mesh,
                rules.BASELINE_RULES)), name
    wq = rules.spec_for(tuple(params["layers.0.attn.wq"].shape),
                        axes["layers.0.attn.wq"], mesh, rules.BASELINE_RULES)
    if arch == "smollm-135m":
        assert wq == rules.PartitionSpec(None, "model")  # mid-head on JAX
    placements = rules.logical_to_shardings(model, mesh,
                                            rules.BASELINE_RULES)
    assert set(placements) == set(specs)
    assert all(p.mesh is mesh for p in placements.values())


def test_opt_state_shardings_follow_their_parameters():
    mesh = MESHES["1x2"]
    ps = {"a": rules.Placement(mesh, rules.PartitionSpec(None, "model"))}
    state = {"mu": {"a": 0, "b": 0}, "nu": {"a": 0}, "master": {"a": 0},
             "count": 0}
    out = rules.opt_state_shardings(state, ps, mesh)
    assert out["mu"]["a"] is ps["a"] and out["nu"]["a"] is ps["a"]
    assert out["mu"]["b"].spec == rules.PartitionSpec()
    assert out["count"].spec == rules.PartitionSpec()


def test_model_axis_size():
    assert serving.model_axis_size(None) == 1
    assert serving.model_axis_size(MESHES["2x16x16"]) == 16
    assert serving.model_axis_size(_StubMesh(data=4)) == 1


def test_partition_spec_canonicalises_singletons_as_jax():
    assert tuple(rules.PartitionSpec(("data",), None)) == ("data", None)
    assert tuple(rules.PartitionSpec(("pod", "data"))) == (("pod", "data"),)
