"""The port's compress → materialize → serve path against the JAX
package's on the smoke configs of the paper's two targets, parameters
carried across by ``repro_torch.bridge``, inputs made with numpy.

Every layer's O^i and the materialized K/V match within 1e-4 (float32 on
the CPU).  The engine is held to the JAX ``ServingEngine``
(dense layout, greedy, no stop token) with two compressed tasks over four
slots and ragged prompts, through ``serve`` with requests naming their
task and through ``generate`` behind an engine-wide context: greedy
tokens must be identical and label scoring must pick the same label.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import Request
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.models import transformer as tfm
from repro_torch.serving import Request as PortRequest
from repro_torch.serving import (ServingEngine, materialize_prefix,
                                 write_prefix_to_cache)

SLOTS, MAX_NEW = 4, 6
TOL = 1e-4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


@pytest.fixture(scope="module", params=["gemma2-2b", "mistral-7b"])
def engines(request):
    cfg = get_smoke_config(request.param)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(request.param)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    compressor = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                        device="cpu")
    rng = np.random.default_rng(11)
    src = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    m = cfg.memcom.num_memory_tokens
    jax_engine = JaxEngine(cfg, params, slots=SLOTS, max_len=m + 32)
    engine = ServingEngine(pcfg, target, slots=SLOTS, max_len=m + 32,
                           device="cpu")

    compressed, jkvs = [], []  # per task: JAX and port (prefix, materialized)
    for t in range(2):
        jprefix, _ = jmc.compress(mc, cfg, jnp.asarray(src[t:t + 1]))
        prefix, _ = memcom.compress(
            compressor, pcfg, torch.as_tensor(src[t:t + 1], dtype=torch.long))
        jkv = jmaterialize(params, cfg, jprefix)
        kv = materialize_prefix(target, pcfg, prefix)
        jax_engine.add_prefix(f"task{t}", jkv)
        engine.add_prefix(f"task{t}", kv)
        jkvs.append(jkv)
        compressed.append(dict(jprefix=bridge.layerwise_to_list(cfg, jprefix),
                               jkv=bridge.layerwise_to_list(cfg, jkv),
                               prefix=prefix, kv=kv))
    # the engine-wide context: slot b holds task b % 2 (the smoke layouts
    # are all `period`, batch on axis 1 of the stacked JAX leaves)
    jkv = jax.tree.map(lambda a, b: jnp.concatenate([a, b, a, b], axis=1),
                       *jkvs)
    kv = [{key: torch.cat([a[key], b[key], a[key], b[key]]) for key in a}
          for a, b in zip(compressed[0]["kv"], compressed[1]["kv"])]
    prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 9, 12, 6)]
    return dict(jax=jax_engine, port=engine, compat=(jkv, kv),
                prompts=prompts, cfg=cfg, pcfg=pcfg, target=target,
                compressed=compressed)


def test_compress_matches_every_layer(engines):
    cfg = engines["cfg"]
    for task in engines["compressed"]:
        assert len(task["prefix"]) == cfg.num_layers
        for got, want in zip(task["prefix"], task["jprefix"]):
            assert tuple(got["h"].shape) == (1, cfg.memcom.num_memory_tokens,
                                             cfg.d_model)
            np.testing.assert_allclose(got["h"].numpy(), want["h"],
                                       atol=TOL, rtol=TOL)


def test_materialized_kv_matches(engines):
    for task in engines["compressed"]:
        for got, want in zip(task["kv"], task["jkv"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(), want[key],
                                           atol=TOL, rtol=TOL)


def test_prefix_as_hiddens_equals_prefix_as_kv(engines):
    """The target attending to {"h": O^i} (K/V derived in the layer) and to
    the materialized {"k", "v"} gives the same logits, and so does a cache
    with the prefix written at [0, m) continued at a static offset."""
    pcfg, target = engines["pcfg"], engines["target"]
    task = engines["compressed"][1]
    m = pcfg.memcom.num_memory_tokens
    toks = torch.as_tensor(engines["prompts"][2][None], dtype=torch.long)
    a, _ = target(tokens=toks, prefix=task["prefix"], mask_offset=m)
    b, _ = target(tokens=toks, prefix=task["kv"], mask_offset=m)
    cache = write_prefix_to_cache(
        pcfg, tfm.init_cache(pcfg, 1, m + 16, device="cpu"), task["kv"])
    c, _ = target(tokens=toks, cache=cache, cache_index=m, mask_offset=m)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(c.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_generate_named_prefixes_token_identical(engines):
    """Each slot seated on its task (the launcher's path): both engines
    serve Requests naming the prefix, with equal uids."""
    names = [f"task{i % 2}" for i in range(SLOTS)]
    reqs = [dict(tokens=p, max_new=MAX_NEW, prefix=n, uid=900 + i)
            for i, (p, n) in enumerate(zip(engines["prompts"], names))]
    want = engines["jax"].serve([Request(**r) for r in reqs])
    got = engines["port"].serve([PortRequest(**r) for r in reqs])
    assert sorted(got) == sorted(want)
    for uid, toks in want.items():
        assert got[uid].dtype == np.int32
        np.testing.assert_array_equal(got[uid], toks)
    assert engines["port"].trace == engines["jax"].trace


def test_generate_behind_seat_compressed_token_identical(engines):
    """``generate(prompts, max_new)`` behind an engine-wide context, the
    JAX ``generate`` semantics: a slot a named prefix displaced gets the
    engine-wide row back."""
    jkv, kv = engines["compat"]
    engines["jax"].seat_compressed(jkv)
    engines["port"].seat_compressed(kv)
    engines["jax"].seat_prefix(1, "task0")
    engines["port"].seat_prefix(1, "task0")
    want = engines["jax"].generate(engines["prompts"], MAX_NEW)
    got = engines["port"].generate(engines["prompts"], MAX_NEW)
    np.testing.assert_array_equal(got, want)
    assert engines["port"].generate(engines["prompts"], 0).shape == (SLOTS, 0)


@pytest.mark.parametrize("task", ["task0", "task1"])
def test_score_labels_same_label(engines, task):
    labels = np.arange(10, 40)
    query = engines["prompts"][1]
    engines["jax"].seat_prefix(0, task)
    engines["port"].seat_prefix(0, task)
    want = engines["jax"].score_labels(np.empty((0,), np.int32), query,
                                       labels)
    got = engines["port"].score_labels(np.empty((0,), np.int32), query,
                                       labels)
    assert got == want
