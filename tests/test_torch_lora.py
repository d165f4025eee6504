"""The port's LoRA adapters (``repro_torch.core.lora``) against the JAX
package's (``repro.core.lora``), on the CPU with smoke configs, parameters
carried across by ``repro_torch.bridge`` and inputs made with numpy.

Tolerances: the merged weights 1e-6 (float32, one rank-r product and an
add), the gradients of ``a`` and ``b`` through the merge 1e-5 of their
largest magnitude, the bridge bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import icae as jicae
from repro.core.lora import init_lora as jinit_lora
from repro.core.lora import merge_lora as jmerge_lora
from repro.models import transformer as jtfm
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import icae, lora

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
ARCH = "smollm-135m"
TARGETS = [("wq", "wk"), ("wq", "wk", "wv", "wo")]


def _setup(targets, rank=4, seed=1):
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    jl = jinit_lora(params, targets, rank=rank, seed=seed)
    pcfg = port_smoke_config(ARCH)
    model = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, jl, pcfg, model


def _perturb_b(tree, rng):
    """Every adapter's ``b`` drawn off zero (at init every gradient of
    ``a`` is exactly 0)."""
    def f(path, x):
        return (jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
                if path[-1].key == "b" else x)
    return jax.tree_util.tree_map_with_path(f, tree)


def _port_lora(pcfg, model, jl, targets, rank):
    """A port LoRA on ``model`` holding the JAX adapters ``jl``."""
    pl = lora.init_lora(model, targets, rank=rank)
    names = bridge._transformer_names(pcfg, jax.tree.map(np.asarray, jl))
    return bridge._load(pl, names)


@pytest.mark.parametrize("targets", TARGETS)
def test_adapters_only_on_the_named_attention_kernels(targets):
    """The same adapted leaves as the JAX tree
    (``tests/test_lora_and_pipelineops.py:13``): named in ``targets``,
    under ``attn``, ``a`` (d_in, r) and ``b`` (r, d_out) in the weight's
    type, one adapter a layer."""
    cfg, _, jl, pcfg, model = _setup(targets)
    pl = lora.init_lora(model, targets, rank=4)
    names = [n for n, _ in pl.named_parameters()]
    assert names and all(".attn." in n for n in names)
    assert all(n.endswith((".a", ".b")) for n in names)
    assert {n.split(".")[-2] for n in names} == set(targets)
    assert len(pl.adapters()) == cfg.num_layers * len(targets)
    want = {n: x.shape for n, x in tree_flatten_with_names(jl)}
    got = {}
    for n, p in pl.named_parameters():
        path = bridge.jax_path(pcfg, "transformer", n)
        got.setdefault(path, []).append(tuple(p.shape))
    assert set(got) == set(want)
    for path, shapes in got.items():
        assert (len(shapes),) + shapes[0] == tuple(want[path])
    params = dict(model.named_parameters())
    for name, ad in pl.adapters().items():
        w = params[name]
        assert ad.a.shape == (w.shape[0], 4) and ad.b.shape == (4, w.shape[1])
        assert ad.a.dtype == ad.b.dtype == w.dtype
        assert not ad.b.any() and ad.a.std() > 0
    assert not lora.init_lora(model, ("w_gate",), rank=4).adapters()


def test_a_is_drawn_at_d_in_scale_from_the_seed():
    _, _, _, pcfg, model = _setup(("wq",))
    big = lora.init_lora(model, ("wq",), rank=32, seed=3)
    again = lora.init_lora(model, ("wq",), rank=32, seed=3)
    other = lora.init_lora(model, ("wq",), rank=32, seed=4)
    a = torch.cat([ad.a.flatten() for ad in big.adapters().values()])
    np.testing.assert_allclose(float(a.std()), pcfg.d_model ** -0.5, rtol=0.1)
    for x, y, z in zip(big.parameters(), again.parameters(),
                       other.parameters()):
        assert torch.equal(x, y)
        assert not x.any() or not torch.equal(x, z)


@pytest.mark.parametrize("targets", TARGETS)
def test_zero_b_merge_is_the_input_bit_for_bit(targets):
    _, _, _, _, model = _setup(targets)
    pl = lora.init_lora(model, targets, rank=4)
    params = dict(model.named_parameters())
    merged = lora.merge_lora(model, pl, rank=4)
    assert set(merged) == set(pl.adapters())
    for name, w in merged.items():
        assert torch.equal(w, params[name]), name


@pytest.mark.parametrize("targets", TARGETS)
def test_merge_matches_jax(rng, targets):
    cfg, params, jl, pcfg, model = _setup(targets)
    jl = _perturb_b(jl, rng)
    pl = _port_lora(pcfg, model, jl, targets, 4)
    want = dict(tree_flatten_with_names(jmerge_lora(params, jl, rank=4)))
    merged = lora.merge_lora(model, pl, rank=4)
    by_path = {}
    for name, w in merged.items():
        assert not torch.equal(w, dict(model.named_parameters())[name])
        by_path.setdefault(bridge.jax_path(pcfg, "transformer", name),
                           []).append(w.detach().numpy())
    for path, ws in by_path.items():
        np.testing.assert_allclose(np.stack(ws), np.asarray(want[path]),
                                   rtol=0, atol=1e-6, err_msg=path)


def test_merge_grads_of_a_and_b_match_jax(rng):
    """d/d(a, b) of a loss read through the merged weights, against
    ``jax.grad`` of the same loss through ``repro.core.lora.merge_lora``."""
    targets = TARGETS[1]
    cfg, params, jl, pcfg, model = _setup(targets)
    jl = _perturb_b(jl, rng)
    pl = _port_lora(pcfg, model, jl, targets, 4)
    probes = {path: rng.standard_normal(x.shape).astype(np.float32)
              for path, x in tree_flatten_with_names(params)
              if path.split("/")[-1] in targets}

    def jloss(lo):
        flat = dict(tree_flatten_with_names(jmerge_lora(params, lo, rank=4)))
        return sum(jnp.sum(jnp.sin(flat[p]) * w) for p, w in probes.items())

    want = dict(tree_flatten_with_names(jax.grad(jloss)(jl)))
    pl.requires_grad_(True)
    merged = lora.merge_lora(model, pl, rank=4)
    loss = 0
    for name, w in merged.items():
        path = bridge.jax_path(pcfg, "transformer", name)
        r = int(name.split(".")[1]) // len(pcfg.layout.period)
        loss = loss + torch.sum(torch.sin(w) * torch.from_numpy(
            probes[path][r]))
    loss.backward()
    got = {}
    for n, p in pl.named_parameters():
        got.setdefault(bridge.jax_path(pcfg, "transformer", n), []).append(
            p.grad.numpy())
    assert set(got) == set(want)
    for path, gs in got.items():
        w = np.asarray(want[path])
        big = float(np.abs(w).max())
        assert big > 1e-3, path
        np.testing.assert_allclose(np.stack(gs), w, rtol=0, atol=1e-5 * big,
                                   err_msg=path)
    for p in model.parameters():
        assert p.grad is None


@pytest.mark.parametrize("variant", ["icae", "icae+", "icae++"])
def test_bridge_round_trips_an_icae_tree_bit_for_bit(rng, variant):
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    ic = jicae.init_icae(cfg, params, variant=variant, seed=1)
    ic["lora"] = _perturb_b(ic["lora"], rng)
    tree = jax.tree.map(np.asarray, ic)
    pic = bridge.from_jax_icae(port_smoke_config(ARCH), tree, variant,
                               device="cpu")
    assert pic.variant == variant
    back = bridge.to_numpy(pic)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        bridge.from_jax_icae(port_smoke_config(ARCH), tree,
                             "icae" if variant == "icae++" else "icae++",
                             device="cpu")
    with pytest.raises(ValueError):
        icae.init_icae(port_smoke_config(ARCH), pic.compressor, "icae+++")
