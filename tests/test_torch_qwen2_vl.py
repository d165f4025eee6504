"""The port's qwen2-vl-2b (M-RoPE: the head's frequency slots cut into
(temporal, height, width) sections, each turned by its own position
stream; qkv bias; 4 query heads on 2 KV heads of 32 at the smoke width)
against the JAX package's, on qwen2-vl-smoke (float32) on the CPU.

Both packages run in one process on inputs made with numpy from a seed,
the port on parameters carried across by ``repro_torch.bridge``.  Text
positions make the three streams equal, which is plain RoPE, so the
M-RoPE cases draw three distinct streams: a wrong section map would
pass with equal ones.  Tolerances: 1e-4 (float32; the frameworks sum in
different orders), gradients within 1e-4 of their own largest value,
tokens identical.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.core import memcom as jmc
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix)

ARCH = "qwen2-vl-2b"
TOL = 1e-4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


@functools.lru_cache(maxsize=None)
def _jax_side():
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    return cfg, params, mc


@pytest.fixture(scope="module")
def setup():
    cfg, params, mc = _jax_side()
    pcfg = port_smoke_config(ARCH)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    comp = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                  device="cpu")
    return dict(cfg=cfg, pcfg=pcfg, params=params, mc=mc, target=target,
                comp=comp, m=cfg.memcom.num_memory_tokens)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _streams(rng, B, S, start=0):
    """Three distinct (t, h, w) position streams, (3, B, S) int32."""
    t = start + np.arange(S)
    return np.stack([np.broadcast_to(t, (B, S)),
                     rng.integers(0, 40, (B, S)),
                     rng.integers(0, 40, (B, S))]).astype(np.int32)


def test_config_is_a_copy():
    for a, b in ((get_config(ARCH), port_config(ARCH)),
                 (get_smoke_config(ARCH), port_smoke_config(ARCH))):
        assert a.to_json() == b.to_json()
        assert a.mrope_sections and sum(a.mrope_sections) == a.hd // 2


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((4, 6, 6), 32),
                                         ((1, 2, 5), 16)])
def test_apply_rope_with_three_streams(rng, sections, hd):
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = _streams(rng, 2, 7, start=5)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sections)
    _close(got, want, 2e-5)
    # equal streams are plain RoPE; distinct ones are not
    plain_rope = layers.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(pos[0]), 1e6)
    same = layers.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(np.stack([pos[0]] * 3)), 1e6,
                             sections)
    _close(same, plain_rope, 1e-6)
    assert float((got - plain_rope).abs().max()) > 1e-2
    with pytest.raises(ValueError):
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)


def test_forward_with_explicit_and_default_positions(setup, rng):
    """Explicit distinct 3-D positions match the JAX forward; diagonal
    (equal) streams give the default positions' logits exactly."""
    s = setup
    toks = rng.integers(0, s["cfg"].vocab_size, (2, 10)).astype(np.int32)
    pos = _streams(rng, 2, 10)
    want, _ = jtfm.forward(s["params"], s["cfg"], tokens=jnp.asarray(toks),
                           positions=jnp.asarray(pos))
    got, _ = s["target"](tokens=torch.as_tensor(toks, dtype=torch.long),
                         positions=torch.from_numpy(pos))
    _close(got, want)
    default, _ = s["target"](tokens=torch.as_tensor(toks, dtype=torch.long))
    diag = np.broadcast_to(np.arange(10, dtype=np.int32), (3, 2, 10))
    same, _ = s["target"](tokens=torch.as_tensor(toks, dtype=torch.long),
                          positions=torch.from_numpy(diag.copy()))
    assert torch.equal(default, same)
    jdefault, _ = jtfm.forward(s["params"], s["cfg"],
                               tokens=jnp.asarray(toks))
    _close(default, jdefault)
    assert float((got - default).abs().max()) > 1e-3


def test_prefill_then_decode_equals_the_full_forward(setup, rng):
    """prefill 12, then one decode step per slot at its own length; each
    matches the JAX model and the full forward over 13 tokens."""
    s = setup
    B, S = 2, 12
    toks = rng.integers(0, s["cfg"].vocab_size, (B, S + 1)).astype(np.int32)
    t = torch.as_tensor(toks, dtype=torch.long)
    full, _ = s["target"](tokens=t)
    cache = tfm.init_cache(s["pcfg"], B, S + 8, device="cpu")
    pre, _ = s["target"](tokens=t[:, :S], cache=cache, cache_index=0)
    dec, _ = s["target"](tokens=t[:, S:], cache=cache,
                         cache_index=torch.tensor([S, S], dtype=torch.int32),
                         decode=True)
    _close(pre, full[:, :S])
    _close(dec[:, 0], full[:, S])
    jfull, _ = jtfm.forward(s["params"], s["cfg"], tokens=jnp.asarray(toks))
    _close(full, jfull)


def test_compress_and_materialize_prefix(setup, rng):
    """O^i, the materialized K/V (M-RoPE at positions 0..m-1 on three equal
    streams) and the target's logits behind the prefix; the chunked
    compress lands on the one-shot."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    src = rng.integers(4, cfg.vocab_size, (1, 40)).astype(np.int32)
    jp, _ = jmc.compress(s["mc"], cfg, jnp.asarray(src))
    pp, info = memcom.compress(s["comp"], pcfg, torch.as_tensor(src))
    assert info["encoder_out"] is None
    for a, b in zip(pp, bridge.layerwise_to_list(cfg, jp)):
        _close(a["h"], b["h"])
    jkv = bridge.layerwise_to_list(cfg, jmaterialize(s["params"], cfg, jp))
    kv = materialize_prefix(s["target"], pcfg, pp)
    for a, b in zip(kv, jkv):
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])
    prompt = rng.integers(4, cfg.vocab_size, (1, 6)).astype(np.int32)
    want, _ = jtfm.forward(s["params"], cfg, tokens=jnp.asarray(prompt),
                           prefix=jp, mask_offset=s["m"])
    got, _ = s["target"](tokens=torch.as_tensor(prompt, dtype=torch.long),
                         prefix=kv, mask_offset=s["m"])
    _close(got, want)
    chunked, _ = memcom.compress_chunked(s["comp"], pcfg,
                                         torch.as_tensor(src), chunk_size=16)
    for a, b in zip(chunked, pp):
        _close(a["h"], b["h"])


def test_memcom_loss_and_phase1_grads_match_jax(setup):
    s = setup
    cfg, params, mc = _jax_side()
    rng = np.random.default_rng(7)
    batch = {
        "source": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
        "target": rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32),
        "target_mask": (rng.random((2, 12)) > 0.2).astype(np.float32)}
    jloss, jgrads = jax.value_and_grad(
        lambda mc_: jmc.memcom_loss(mc_, params, cfg,
                                    jax.tree.map(jnp.asarray, batch))[0])(mc)
    jgrads = {p: np.asarray(g) for p, g in tree_flatten_with_names(jgrads)}
    pcfg = s["pcfg"]
    pmc = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                 device="cpu")
    trained = memcom.set_trainable(pmc, 1)
    loss, _ = memcom.memcom_loss(pmc, s["target"], pcfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(trained.values()))
    _close(float(loss.detach()), float(jloss))
    per = {}
    for n, g in zip(trained, grads):
        per.setdefault(bridge.jax_path(pcfg, "memcom", n), []).append(
            g.numpy())
    assert per and all(p.startswith(("memx", "mem_tokens")) for p in per)
    for path, lst in per.items():
        want = jgrads[path]
        got = np.stack(lst) if want.ndim == lst[0].ndim + 1 else lst[0]
        big = float(np.abs(want).max())
        assert big >= 1e-6, path
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * big,
                                   err_msg=path)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_jax(setup, layout):
    """Two compressed tasks over two slots with refills: identical tokens,
    trace and request log on a virtual clock (explicit uids)."""
    s = setup
    cfg = s["cfg"]
    kw = dict(slots=2, max_len=s["m"] + 24, kv_layout=layout)
    if layout == "paged":
        kw["block_size"] = 4
    j = JaxEngine(cfg, s["params"], clock=JClock(), **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), **kw)
    rng = np.random.default_rng(11)
    for t in range(2):
        src = rng.integers(4, cfg.vocab_size, (1, 32)).astype(np.int32)
        jp, _ = jmc.compress(s["mc"], cfg, jnp.asarray(src))
        pp, _ = memcom.compress(s["comp"], s["pcfg"], torch.as_tensor(src))
        j.add_prefix(f"task{t}", jmaterialize(s["params"], cfg, jp))
        p.add_prefix(f"task{t}", materialize_prefix(s["target"], s["pcfg"],
                                                    pp))
    specs = [dict(tokens=rng.integers(4, cfg.vocab_size, n).astype(np.int32),
                  max_new=mn, prefix=f"task{i % 2}", uid=500 + i)
             for i, (n, mn) in enumerate(((6, 3), (9, 5), (4, 4), (12, 2)))]
    want = j.serve([JRequest(**x) for x in specs])
    got = p.serve([Request(**x) for x in specs])
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace and p.request_log == j.request_log


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_launcher_matches_jax(monkeypatch, layout):
    """The launcher on the smoke arch emits the JAX launcher's tokens (its
    requests carry the launcher's own uids on both sides)."""
    from repro.launch import serve as jserve
    from repro_torch.data import SyntheticVocab
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--tasks", "2",
            "--slots", "2", "--max-new", "4", "--context-tokens", "48"]
    if layout == "paged":
        argv += ["--kv-layout", "paged", "--block-size", "4"]
    jcfg = get_smoke_config(ARCH).replace(vocab_size=SyntheticVocab().size)
    params = jtfm.init_params(jcfg, 0)
    mc = jmc.init_memcom(jcfg, params, 1)
    monkeypatch.setattr(serve.tfm, "init_params",
                        lambda cfg, seed, device: bridge.from_jax_params(
                            cfg, jax.tree.map(np.asarray, params),
                            device=device))
    monkeypatch.setattr(serve.memcom, "init_memcom",
                        lambda cfg, target, seed: bridge.from_jax_memcom(
                            cfg, jax.tree.map(np.asarray, mc),
                            device=target.device))
    want = []
    real = JaxEngine.serve

    def spy(self, requests, **kw):
        requests = list(requests)
        out = real(self, requests, **kw)
        want.extend(out[r.uid].tolist() for r in requests)
        return out

    monkeypatch.setattr(JaxEngine, "serve", spy)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    metrics = serve.main(argv + ["--device", "cpu"])
    assert metrics["tokens"] == want and len(want) == 3
