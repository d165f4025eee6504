"""The port's hybrid MemCom (Jamba: Mamba2 + attention layers, MoE every
other layer) against the JAX package's, on jamba-smoke (two periods of
mamba / mamba+MoE / attention / mamba+MoE; float32), on the CPU.

In a hybrid stack only the attention layers get a cross-attention and an
O^i; a Mamba2 layer hands the target the Source-LLM's exact final SSM
state, which seeds the target's recurrence (``init_state``).  Both
packages run in one process on inputs made with numpy from a seed, the
port on parameters carried across by ``repro_torch.bridge``:

* ``Mamba`` with an ``init_state`` (and one given beside a cache, which it
  overrides) — 1e-4;
* compress (``{"ssm"}`` and ``{"h"}`` entries), ``materialize_prefix``
  (the state passes through) and the target's logits — 1e-4; the
  ``memx`` holes and the bridge's round trip, bit for bit;
* chunked compress against one-shot with a ragged last chunk (MoE layers
  swapped for dense MLPs, as the reference's test does) — 1e-4;
* the engine against the JAX engine, dense and paged: a slot refilled on
  another task, ``seat_compressed`` context surviving a re-serve,
  identical tokens, ``trace`` and ``request_log`` on a ``VirtualClock``;
* the tiers' demote → spill → promote round trip (the state rides the
  row), bit exact, and online compilation, against the JAX engine;
* the launcher on the smoke arch against the JAX launcher.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import mamba2 as jmamba
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.models import transformer as tfm
from repro_torch.models.mamba2 import init_mamba_cache
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix, take_prefix_row)

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4
torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(ARCH)
    target = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    comp = bridge.from_jax_memcom(pcfg, jax.tree.map(np.asarray, mc),
                                  device="cpu")
    rng = np.random.default_rng(33)
    shots = [rng.integers(4, cfg.vocab_size, 24).astype(np.int32)
             for _ in range(2)]
    kvs, prefixes = [], []
    for src in shots:
        jp, _ = jmc.compress(mc, cfg, jnp.asarray(src[None]))
        pp, _ = memcom.compress(comp, pcfg, torch.as_tensor(src[None]))
        prefixes.append((jp, pp))
        kvs.append((jmaterialize(params, cfg, jp),
                    materialize_prefix(target, pcfg, pp)))
    return dict(cfg=cfg, pcfg=pcfg, params=params, mc=mc, target=target,
                comp=comp, shots=shots, prefixes=prefixes, kvs=kvs,
                m=cfg.memcom.num_memory_tokens)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


# ---------------------------------------------------------------------------
# Mamba2 with a handed-off state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_init_state_matches_jax(setup, rng, with_cache):
    """A prefill seeded by ``init_state``; beside a cache the given state
    wins over the cache's (the conv window still comes from the cache),
    and the cache ends with the final state."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    p = jax.tree.map(lambda x: x[0], s["params"]["period"]["l0"]["mamba"])
    mod = s["target"].layers[0].mamba
    mb = cfg.mamba
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((B, mb.nheads(cfg.d_model), mb.headdim,
                              mb.d_state)).astype(np.float32)
    cache = None
    if with_cache:
        cache = {k: np.asarray(v) for k, v in jmamba.init_mamba_cache(
            cfg, B, jnp.float32).items()}
        cache["conv"] = rng.standard_normal(cache["conv"].shape).astype(
            np.float32)
        cache["ssm"] = rng.standard_normal(cache["ssm"].shape).astype(
            np.float32)
    want, wc = jmamba.apply_mamba(
        p, cfg, jnp.asarray(x), init_state=jnp.asarray(h0),
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    pc = None if cache is None else {k: _t(v) for k, v in cache.items()}
    got = mod(_t(x), init_state=_t(h0), cache=pc)
    _close(got, want)
    if with_cache:
        for key in ("conv", "ssm"):
            _close(pc[key], wc[key])


# ---------------------------------------------------------------------------
# compress -> materialize -> target
# ---------------------------------------------------------------------------


def test_compress_materialize_and_target_match_jax(setup, rng):
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    jp, pp = s["prefixes"][0]
    descs = pcfg.layout.descriptors()
    assert [sorted(e) for e in pp] == [
        ["h"] if d.mixer == "attn" else ["ssm"] for d in descs]
    jl = bridge.layerwise_to_list(cfg, jax.tree.map(np.asarray, jp))
    for a, b in zip(jl, pp):
        assert sorted(a) == sorted(b)
        for key in a:
            _close(b[key], a[key])
    jkv, kv = s["kvs"][0]
    for a, b, d in zip(bridge.layerwise_to_list(
            cfg, jax.tree.map(np.asarray, jkv)), kv, descs):
        assert sorted(b) == (["k", "v"] if d.mixer == "attn" else ["ssm"])
        for key in b:
            _close(b[key], a[key])
    tok = rng.integers(4, cfg.vocab_size, (1, 6)).astype(np.int32)
    m = s["m"]
    want, _ = jtfm.forward(s["params"], cfg, tokens=jnp.asarray(tok),
                           prefix=jkv, mask_offset=m)
    with torch.no_grad():
        got, _ = s["target"](tokens=torch.as_tensor(tok, dtype=torch.long),
                             prefix=kv, mask_offset=m)
    _close(got, want)


def test_memx_holes_and_bridge_round_trip(setup):
    """Only the attention layers hold a cross-attention; the JAX tree's
    ``None`` entries and stacked period keys come back bit for bit."""
    s = setup
    descs = s["pcfg"].layout.descriptors()
    holes = [x is None for x in memcom.memx_list(s["comp"].memx)]
    assert holes == [d.mixer == "mamba" for d in descs]
    names = {n.split(".")[1] for n, _ in s["comp"].named_parameters()
             if n.startswith("memx.")}
    assert names == {str(i) for i, d in enumerate(descs) if d.mixer == "attn"}
    for tree, mod in ((s["params"], s["target"]), (s["mc"], s["comp"])):
        tree = jax.tree.map(np.asarray, tree)
        back = bridge.to_numpy(mod)
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    fresh = memcom.init_memcom(s["pcfg"], s["target"], 1)
    assert set(dict(fresh.named_parameters())) == set(
        dict(s["comp"].named_parameters()))


def test_chunked_compress_matches_one_shot(setup):
    """The recurrent state and the attention K/V carried across chunk
    boundaries (40 = 16 + 16 + 8) land on the one-shot prefix."""
    pcfg = port_smoke_config(ARCH)
    pcfg = pcfg.replace(layout=dataclasses.replace(pcfg.layout, period=tuple(
        dataclasses.replace(d, mlp="dense") for d in pcfg.layout.period)))
    comp = memcom.init_memcom(pcfg, tfm.init_params(pcfg, 0, device="cpu"),
                              1)
    src = torch.as_tensor(np.random.default_rng(3).integers(
        4, pcfg.vocab_size, (1, 40)))
    one, _ = memcom.compress(comp, pcfg, src)
    chk, _ = memcom.compress_chunked(comp, pcfg, src, chunk_size=16)
    for a, b in zip(one, chk):
        assert sorted(a) == sorted(b)
        for key in a:
            _close(b[key], a[key])


def test_one_shot_compress_keeps_only_the_state(setup):
    """The one-shot compress's Source-LLM cache holds Mamba2 state alone
    (no K/V is allocated for the attention layers)."""
    s = setup
    cache = memcom._mamba_only_cache(s["pcfg"], 2, s["comp"])
    for c, d in zip(cache, s["pcfg"].layout.descriptors()):
        if d.mixer == "mamba":
            want = init_mamba_cache(s["pcfg"], 2, torch.float32, "cpu")
            assert {k: v.shape for k, v in c.items()} == \
                {k: v.shape for k, v in want.items()}
        else:
            assert c == {}


# ---------------------------------------------------------------------------
# Serving against the JAX engine
# ---------------------------------------------------------------------------


def _serve_both(j, p, specs):
    want = j.serve([JRequest(**x) for x in specs])
    got = p.serve([Request(**x) for x in specs])
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert p.trace == j.trace
    assert p.request_log == j.request_log
    if p.paged:
        assert p.alloc.snapshot() == j.alloc.snapshot()
        np.testing.assert_array_equal(p.tables, j.tables)
    return got


def _engines(s, **kw):
    if kw.get("kv_layout") == "paged":
        kw.setdefault("block_size", 4)
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(), **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), **kw)
    return j, p


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_refill_seats_the_state_again_like_jax(setup, layout):
    """Three requests of one prompt on tasks A, B, A over two slots: the
    third refills a slot whose state B's request advanced, and its tokens
    equal the first's (the handed-off state is seated again)."""
    s = setup
    j, p = _engines(s, slots=2, max_len=s["m"] + 24, kv_layout=layout)
    for t, (jkv, kv) in enumerate(s["kvs"]):
        j.add_prefix("AB"[t], jkv)
        p.add_prefix("AB"[t], kv)
    prompt = np.random.default_rng(8).integers(
        4, s["cfg"].vocab_size, 6).astype(np.int32)
    out = _serve_both(j, p, [dict(tokens=prompt, max_new=3, prefix=x,
                                  uid=10 + i)
                             for i, x in enumerate("ABA")])
    np.testing.assert_array_equal(out[10], out[12])
    # a request without a prefix after them runs context-free
    _serve_both(j, p, [dict(tokens=prompt[:4], max_new=4, uid=13)])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_seat_compressed_survives_re_serve_like_jax(setup, layout):
    """``seat_compressed`` context (one task per slot) is restored for a
    later serve although the first generation advanced the slots'
    recurrent state."""
    s = setup
    jkv = jmaterialize(s["params"], s["cfg"], jmc.compress(
        s["mc"], s["cfg"], jnp.asarray(np.stack(s["shots"])))[0])
    kv = materialize_prefix(s["target"], s["pcfg"], memcom.compress(
        s["comp"], s["pcfg"], torch.as_tensor(np.stack(s["shots"])))[0])
    j, p = _engines(s, slots=2, max_len=s["m"] + 24, kv_layout=layout)
    j.seat_compressed(jkv)
    p.seat_compressed(kv)
    prompts = np.random.default_rng(9).integers(
        4, s["cfg"].vocab_size, (2, 5)).astype(np.int32)
    first = p.generate(prompts, max_new=4)
    second = p.generate(prompts, max_new=4)
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, j.generate(prompts, max_new=4))


def _rows_bit_exact(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert sorted(ea) == sorted(eb)
        for key in ea:
            assert ea[key].dtype == eb[key].dtype
            assert torch.equal(ea[key], eb[key]), key


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tier_round_trip_bit_exact(setup, layout, tmp_path):
    """K/V and the Mamba2 layers' states survive demote → spill → promote
    byte for byte (paged: the state beside the pool blocks) and serve the
    JAX engine's tokens."""
    s = setup
    ref = take_prefix_row(s["kvs"][0][1], 0)
    kw = dict(slots=2, max_len=s["m"] + 24, kv_layout=layout,
              host_capacity=4, promote_layer_budget=1)
    if layout == "paged":
        kw["block_size"] = 4
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(),
                  disk_dir=str(tmp_path / "jax"), **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), disk_dir=str(tmp_path / "port"),
                      **kw)
    j.add_prefix("t", s["kvs"][0][0])
    p.add_prefix("t", s["kvs"][0][1])
    prompt = np.arange(4, 9, dtype=np.int32)
    warm = _serve_both(j, p, [dict(tokens=prompt, max_new=4, prefix="t",
                                   uid=1)])[1]
    _serve_both(j, p, [dict(tokens=prompt, max_new=1, uid=2)])
    for e in (j, p):
        e.store.demote("t")
    _rows_bit_exact(ref, p.store._host["t"])
    for e in (j, p):
        e.store.spill("t")
    assert p.store.tier_of("t") == j.store.tier_of("t") == "disk"
    out = _serve_both(j, p, [dict(tokens=prompt, max_new=4, prefix="t",
                                  uid=3)])
    np.testing.assert_array_equal(out[3], warm)
    assert p.stats()["prefix_tiers"] == j.stats()["prefix_tiers"]
    _serve_both(j, p, [dict(tokens=prompt, max_new=1, uid=4)])
    for e in (j, p):
        e.store.demote("t")
    _rows_bit_exact(ref, p.store._host["t"])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_online_compile_matches_jax(setup, layout):
    """A raw-shots request compiles on the serving path in 16-token chunks
    (the state carried across them) and emits the JAX engine's tokens."""
    s = setup
    kw = dict(slots=1, max_len=s["m"] + 24, kv_layout=layout,
              compile_token_budget=16)
    if layout == "paged":
        kw["block_size"] = 4
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(), compressor=s["mc"],
                  **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), compressor=s["comp"], **kw)
    prompt = np.arange(4, 9, dtype=np.int32)
    shots = np.concatenate([s["shots"][1], s["shots"][0][:16]])  # 40
    _serve_both(j, p, [dict(tokens=prompt, max_new=4, prefix="task",
                            raw_shots=shots, uid=7)])
    assert p.stats()["compiler"] == j.stats()["compiler"]


def test_launcher_matches_jax(monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.data import SyntheticVocab
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--requests", "4", "--tasks", "2",
            "--slots", "2", "--max-new", "4", "--context-tokens", "48"]
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
    assert metrics["tokens"] == want and len(want) == 4
