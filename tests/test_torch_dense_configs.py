"""The dense configs smollm-360m (3 query heads on 1 KV head at smoke
width) and stablelm-1.6b (layernorm, MHA, an untied head) through the
port's compress → materialize → serve path against the JAX package's, on
their smoke configs, parameters carried across by ``repro_torch.bridge``,
inputs made with numpy.

Every layer's O^i within 1e-4 (float32 on the CPU); a dense serve and a
paged serve (block size 4, stop tokens, slots refilled) give the JAX
engine's tokens, trace and request log exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import VirtualClock as JClock
from repro.serving import materialize_prefix as jmaterialize
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.serving import Request, ServingEngine, VirtualClock
from repro_torch.serving import materialize_prefix

TOL = 1e-4
SLOTS = 4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


@pytest.fixture(scope="module", params=["smollm-360m", "stablelm-1.6b"])
def setup(request):
    cfg = get_smoke_config(request.param)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(request.param)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    compressor = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                        device="cpu")
    rng = np.random.default_rng(29)
    src = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tasks = []
    for t in range(2):
        jprefix, _ = jmc.compress(mc, cfg, jnp.asarray(src[t:t + 1]))
        prefix, _ = memcom.compress(
            compressor, pcfg, torch.as_tensor(src[t:t + 1], dtype=torch.long))
        tasks.append(dict(jprefix=bridge.layerwise_to_list(cfg, jprefix),
                          prefix=prefix,
                          jkv=jmaterialize(params, cfg, jprefix),
                          kv=materialize_prefix(target, pcfg, prefix)))
    return dict(cfg=cfg, params=params, pcfg=pcfg, target=target, tasks=tasks)


def _engines(setup, **kw):
    m = setup["cfg"].memcom.num_memory_tokens
    kw = dict(slots=SLOTS, max_len=m + 24, **kw)
    j = JaxEngine(setup["cfg"], setup["params"], clock=JClock(), **kw)
    p = ServingEngine(setup["pcfg"], setup["target"], device="cpu",
                      clock=VirtualClock(), **kw)
    for t, task in enumerate(setup["tasks"]):
        j.add_prefix(f"task{t}", task["jkv"])
        p.add_prefix(f"task{t}", task["kv"])
    return j, p


def _requests(cfg, seed, n, stops):
    rng = np.random.default_rng(seed)
    jr, pr = [], []
    for i in range(n):
        args = dict(tokens=rng.integers(4, cfg.vocab_size, int(
            rng.integers(3, 10))).astype(np.int32),
            max_new=int(rng.integers(2, 7)), prefix=f"task{i % 2}",
            uid=29_000 + 100 * seed + i)
        if stops and i % 3 == 0:
            args["stop_token"] = int(rng.integers(4, cfg.vocab_size))
        jr.append(JRequest(**args))
        pr.append(Request(**args))
    return jr, pr


def test_compress_matches_every_layer(setup):
    cfg = setup["cfg"]
    for task in setup["tasks"]:
        assert len(task["prefix"]) == cfg.num_layers
        for got, want in zip(task["prefix"], task["jprefix"]):
            np.testing.assert_allclose(got["h"].numpy(), want["h"], atol=TOL,
                                       rtol=TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_gives_the_jax_engines_tokens(setup, layout):
    """Ten requests over four slots and the two tasks (the paged engine in
    blocks of 4, stop tokens on some, so slots refill mid-decode)."""
    kw = dict(kv_layout="paged", block_size=4) if layout == "paged" else {}
    j, p = _engines(setup, **kw)
    jr, pr = _requests(setup["cfg"], 1 + (layout == "paged"), 10,
                       stops=layout == "paged")
    want = j.serve(jr)
    got = p.serve(pr)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace
    assert p.request_log == j.request_log
    if layout == "paged":
        assert p.alloc.snapshot() == j.alloc.snapshot()
        np.testing.assert_array_equal(p.tables, j.tables)
