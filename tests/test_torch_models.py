"""The port's model against the JAX package's on the smoke configs of the
paper's two targets and of the dense smollm-360m (3 query heads on 1 KV
head), stablelm-1.6b (layernorm, MHA, untied head) and mistral-nemo-12b
(head dim given in the config; its smoke config's 4 x 32 equals d_model,
so the decoupled head dim of the full width, 32 x 128 against 5120, is
not exercised), with the parameters carried across
by ``repro_torch.bridge`` and the inputs made with numpy from a seed.

Tolerances: logits 1e-4 (float32 on the CPU; the two frameworks sum in
different orders), layers 2e-5, parameter round trip bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.models import layers
from repro_torch.models import transformer as tfm

ARCHS = ["gemma2-2b", "mistral-7b", "smollm-360m", "stablelm-1.6b",
         "mistral-nemo-12b"]
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = get_smoke_config(request.param)
    params = jtfm.init_params(cfg, 0)
    pcfg = port_smoke_config(request.param)
    model = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, pcfg, model


def _tokens(cfg, rng, B, S):
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_port_configs_are_copies_of_the_jax_ones():
    from repro.configs import get_config

    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs import get_config as port_config
    assert set(ARCHS) < set(ARCH_IDS)
    for arch in ARCH_IDS:
        for a, b in ((get_config(arch), port_config(arch)),
                     (get_smoke_config(arch), port_smoke_config(arch))):
            assert a.to_json() == b.to_json()
            assert a.param_count() == b.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_bit_for_bit(arch):
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(arch)
    for tree, load in ((params, bridge.from_jax_params),
                       (mc, bridge.from_jax_memcom)):
        tree = jax.tree.map(np.asarray, tree)
        back = bridge.to_numpy(load(pcfg, tree, device="cpu"))
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bridge_rejects_a_tree_of_another_shape():
    cfg = get_smoke_config("gemma2-2b")
    tree = jax.tree.map(np.asarray, jtfm.init_params(cfg, 0))
    with pytest.raises(ValueError):
        bridge.from_jax_params(port_smoke_config("mistral-7b"), tree,
                               device="cpu")


def test_layerwise_values_convert_both_ways(pair):
    cfg, _, _, _ = pair
    rng = np.random.default_rng(3)
    lw = {"period": {"l0": {"k": rng.standard_normal(
        (cfg.layout.repeats, 2, 5)).astype(np.float32)}}}
    as_list = bridge.layerwise_to_list(cfg, lw)
    assert len(as_list) == cfg.num_layers
    np.testing.assert_array_equal(as_list[1]["k"], lw["period"]["l0"]["k"][1])
    back = bridge.list_to_layerwise(cfg, as_list)
    np.testing.assert_array_equal(back["period"]["l0"]["k"],
                                  lw["period"]["l0"]["k"])


def test_forward_logits_and_hiddens_match(pair, rng):
    cfg, params, _, model = pair
    toks = _tokens(cfg, rng, 2, 24)
    want, jaux = jtfm.forward(params, cfg, tokens=jnp.asarray(toks),
                              capture_hiddens=True)
    got, aux = model(tokens=torch.as_tensor(toks, dtype=torch.long),
                     capture_hiddens=True)
    _close(got, want)
    for h, jh in zip(aux["hiddens"],
                     bridge.layerwise_to_list(cfg, jaux["hiddens"])):
        _close(h, jh)


def test_prefill_continuation_and_per_slot_decode_match(pair, rng):
    """prefill 8 tokens, continue 4 behind them (static offset), then one
    decode step per slot at ragged lengths — logits match the JAX model at
    every stage."""
    cfg, params, pcfg, model = pair
    B = 2
    toks = _tokens(cfg, rng, B, 13)
    jcache = jtfm.init_cache(cfg, B, 24)
    cache = tfm.init_cache(pcfg, B, 24, device="cpu")
    stages = [dict(tokens=toks[:, :8], cache_index=0),
              dict(tokens=toks[:, 8:12], cache_index=8, mask_offset=8)]
    for kw in stages:
        want, jaux = jtfm.forward(params, cfg, cache=jcache,
                                  **{**kw, "tokens": jnp.asarray(kw["tokens"])})
        jcache = jaux["cache"]
        got, _ = model(cache=cache, **{**kw, "tokens": torch.as_tensor(
            kw["tokens"], dtype=torch.long)})
        _close(got, want)
    lengths = np.asarray([12, 9], np.int32)  # slot 1 rewinds 3 positions
    want, _ = jtfm.forward(params, cfg, tokens=jnp.asarray(toks[:, 12:13]),
                           cache=jcache, cache_index=jnp.asarray(lengths),
                           decode=True)
    got, _ = model(tokens=torch.as_tensor(toks[:, 12:13], dtype=torch.long),
                   cache=cache, cache_index=torch.as_tensor(lengths),
                   decode=True)
    _close(got, want)
    # static-offset decode on the same cache matches the full forward
    full, _ = jtfm.forward(params, cfg, tokens=jnp.asarray(toks))
    cache = tfm.init_cache(pcfg, B, 24, device="cpu")
    model(tokens=torch.as_tensor(toks[:, :12], dtype=torch.long), cache=cache,
          cache_index=0)
    dec, _ = model(tokens=torch.as_tensor(toks[:, 12:13], dtype=torch.long),
                   cache=cache, cache_index=12, decode=True)
    _close(dec[:, 0], np.asarray(full)[:, 12])


@pytest.mark.parametrize("starts", [[0, 4, 9], [7, 0, 3]])
def test_scatter_rows_matches_jax(rng, starts):
    """Per-slot cache writes at each slot's own offset; a window that
    overruns the end (slot 2 of the first case) is clamped back."""
    from repro.models import attention as jattn

    from repro_torch.models import attention
    cache = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    starts = np.asarray(starts, np.int32)
    want = jattn.scatter_rows(jnp.asarray(cache), jnp.asarray(new),
                              jnp.asarray(starts))
    got = attention.scatter_rows(
        torch.from_numpy(cache.copy()), torch.from_numpy(new),
        torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layers_match(rng):
    cfg = get_smoke_config("gemma2-2b")
    x = rng.standard_normal((2, 5, 3, 24)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 2e-5)
    # M-RoPE (ported with qwen2-vl-2b): three distinct position streams
    pos3 = np.stack([pos, rng.integers(0, 50, (2, 5)),
                     rng.integers(0, 50, (2, 5))]).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e4, (4, 4, 4)),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1e4,
                              (4, 4, 4)), 2e-5)
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(layers.softcap(torch.from_numpy(h * 40), 30.0),
           jlayers.softcap(jnp.asarray(h * 40), 30.0), 2e-5)
    # GeGLU uses the tanh GELU, as jax.nn.gelu does by default
    _close(layers._gelu(torch.from_numpy(h)), jax.nn.gelu(jnp.asarray(h)),
           2e-5)
