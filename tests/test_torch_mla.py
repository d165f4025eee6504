"""The port's Multi-head Latent Attention (DeepSeek-V2) against the JAX
package's, on deepseek-v2-smoke (a dense-FFN MLA prefix layer, two
MLA + MoE period layers; float32), on the CPU.

Both packages run in one process on inputs made with numpy from a seed,
the port on parameters carried across by ``repro_torch.bridge``, each on
its plain kernels (the JAX package's streaming backend):

* the MLA layer: causal prefill, the prefix derived from O^i, prefill
  continuation over seated latents (dense and paged), the absorbed decode
  per slot (dense, paged, fused lanes) and at a static start — 1e-4;
* compress (O^i), ``materialize_prefix`` (``{"ckv", "kr"}``) and the
  target's logits behind the prefix — 1e-4;
* the engine against the JAX engine, dense and paged: identical tokens,
  ``trace`` and ``request_log`` on a ``VirtualClock``;
* chunked compress against one-shot with a ragged last chunk (the MoE
  layers swapped for dense MLPs, as the reference's test does: a router
  tie turns 1e-7 of attention-order noise into a 1e-3 jump) — 1e-4;
* the tiers' demote → spill → promote round trip, bit exact, and online
  compilation, against the JAX engine;
* the launcher on the smoke arch against the JAX launcher;
* the flash and paged wrappers' routing at Dv != D, and the flash
  backward's refusal, with the launches stood in for (no card here).
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
from repro.kernels import ops as jops
from repro.models import mla as jmla
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import mla
from repro_torch.models import transformer as tfm
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix, take_prefix_row)

ARCH = "deepseek-v2-236b"
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
    rng = np.random.default_rng(30)
    shots = [rng.integers(4, cfg.vocab_size, 40).astype(np.int32)
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
# The MLA layer
# ---------------------------------------------------------------------------


def _layer(s, li=1):
    """(JAX params, port module) of MLA layer ``li`` (1: period l0, r 0)."""
    p = (s["params"]["prefix_0"]["attn"] if li == 0 else jax.tree.map(
        lambda x: x[li - 1], s["params"]["period"]["l0"]["attn"]))
    return p, s["target"].layers[li].attn


def _x(s, rng, B, S):
    return rng.standard_normal((B, S, s["cfg"].d_model)).astype(np.float32)


def _pos(B, S, start=0):
    return np.broadcast_to(start + np.arange(S, dtype=np.int32), (B, S))


@pytest.mark.parametrize("li", [0, 1])
def test_mla_prefill_and_prefix_match_jax(setup, rng, li):
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    p, mod = _layer(s, li)
    B, S, m = 2, 7, s["m"]
    x = _x(s, rng, B, S)
    want, _ = jmla.apply_mla(p, cfg, jnp.asarray(x), positions=_pos(B, S))
    got, _ = mla.apply_mla(mod, pcfg, _t(x), positions=_t(_pos(B, S),
                                                           torch.int32))
    _close(got, want)
    h = _x(s, rng, B, m)  # the prefix from O^i, and its materialized form
    kw = dict(positions=_pos(B, S, m), mask_offset=m)
    want, _ = jmla.apply_mla(p, cfg, jnp.asarray(x),
                             prefix={"h": jnp.asarray(h)}, **kw)
    pkw = dict(positions=_t(_pos(B, S, m), torch.int32), mask_offset=m)
    got, _ = mla.apply_mla(mod, pcfg, _t(x), prefix={"h": _t(h)}, **pkw)
    _close(got, want)
    ckv, kr = mla.latent(mod, pcfg, _t(h), _t(_pos(B, m), torch.int32))
    got2, _ = mla.apply_mla(mod, pcfg, _t(x), prefix={"ckv": ckv, "kr": kr},
                            **pkw)
    _close(got2, want)


def _latents(s, rng, shape):
    m = s["cfg"].mla
    return (rng.standard_normal((*shape, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((*shape, m.qk_rope_head_dim))
            .astype(np.float32))


def _paged(B, L, bs, rng):
    """Shuffled tables over a pool of 1 + B * L / bs blocks (block 0 the
    trash block)."""
    nb = L // bs
    order = rng.permutation(B * nb) + 1
    return order.reshape(B, nb).astype(np.int32), 1 + B * nb


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mla_prefill_continuation_matches_jax(setup, rng, layout):
    """A prompt behind seated latent rows [0, base): the cache is read as
    a prefix (paged: gathered through the tables) and written behind."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    p, mod = _layer(s)
    B, S, base, L, bs = 2, 5, 9, 24, 4
    x = _x(s, rng, B, S)
    if layout == "dense":
        ckv, kr = _latents(s, rng, (B, L))
        tables = None
    else:
        tables, N = _paged(B, L, bs, rng)
        ckv, kr = _latents(s, rng, (N, bs))
    jcache = {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)}
    pcache = {"ckv": _t(ckv), "kr": _t(kr)}
    kw = dict(positions=_pos(B, S, base), mask_offset=base, cache_index=base)
    want, wc = jmla.apply_mla(p, cfg, jnp.asarray(x), cache=jcache,
                              block_tables=None if tables is None
                              else jnp.asarray(tables), **kw)
    got, gc = mla.apply_mla(
        mod, pcfg, _t(x), cache=pcache,
        block_tables=None if tables is None else _t(tables, torch.int32),
        **dict(kw, positions=_t(kw["positions"], torch.int32)))
    _close(got, want)
    for key in ("ckv", "kr"):
        _close(gc[key], wc[key])


@pytest.mark.parametrize("kind", ["dense", "paged", "fused_dense",
                                  "fused_paged", "static"])
def test_mla_absorbed_decode_matches_jax(setup, rng, kind):
    """The absorbed decode: one lane a slot (dense / paged), four lanes
    with ragged ``lane_valid`` (the fused step), and a static start."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    p, mod = _layer(s)
    B, L, bs = 3, 24, 4
    S = 4 if kind.startswith("fused") else 1
    x = _x(s, rng, B, S)
    paged = kind.endswith("paged")
    if paged:
        tables, N = _paged(B, L, bs, rng)
        ckv, kr = _latents(s, rng, (N, bs))
    else:
        tables = None
        ckv, kr = _latents(s, rng, (B, L))
    if kind == "static":
        idx = 11
        positions = _pos(B, S, idx)
        jidx, pidx = idx, idx
    else:
        lens = np.array([3, 17, 9], np.int32)
        positions = lens[:, None] + np.arange(S, dtype=np.int32)[None]
        jidx, pidx = jnp.asarray(lens), _t(lens, torch.int32)
    lane_valid = np.array([4, 1, 2], np.int32) if S > 1 else None
    want, wc = jmla.apply_mla(
        p, cfg, jnp.asarray(x), positions=positions,
        cache={"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)},
        cache_index=jidx, decode=True,
        block_tables=None if tables is None else jnp.asarray(tables),
        lane_valid=None if lane_valid is None else jnp.asarray(lane_valid))
    got, gc = mla.apply_mla(
        mod, pcfg, _t(x), positions=_t(positions, torch.int32),
        cache={"ckv": _t(ckv), "kr": _t(kr)}, cache_index=pidx, decode=True,
        block_tables=None if tables is None else _t(tables, torch.int32),
        lane_valid=None if lane_valid is None else _t(lane_valid,
                                                      torch.int32))
    if lane_valid is None:
        _close(got, want)
    else:  # the valid lanes: the others are geometry padding
        for b, n in enumerate(lane_valid):
            _close(got[b, :n], want[b, :n])
    for key in ("ckv", "kr"):
        _close(gc[key], wc[key])


def test_mla_caches_match_jax(setup):
    s = setup
    for got, want in (
            (tfm.init_cache(s["pcfg"], 2, 20, device="cpu"),
             jtfm.init_cache(s["cfg"], 2, 20)),
            (tfm.init_paged_cache(s["pcfg"], 9, 4, 2, device="cpu"),
             jtfm.init_paged_cache(s["cfg"], 9, 4, 2))):
        want = bridge.layerwise_to_list(s["cfg"], want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["ckv", "kr"]
            for key in g:
                assert tuple(g[key].shape) == w[key].shape


# ---------------------------------------------------------------------------
# compress -> materialize -> target
# ---------------------------------------------------------------------------


def test_compress_materialize_and_target_match_jax(setup, rng):
    s = setup
    cfg = s["cfg"]
    jp, pp = s["prefixes"][0]
    jl = bridge.layerwise_to_list(cfg, jax.tree.map(np.asarray, jp))
    assert [sorted(e) for e in pp] == [["h"]] * cfg.num_layers
    for a, b in zip(jl, pp):
        _close(b["h"], a["h"])
    jkv, kv = s["kvs"][0]
    for a, b in zip(bridge.layerwise_to_list(cfg, jax.tree.map(np.asarray,
                                                               jkv)), kv):
        assert sorted(b) == ["ckv", "kr"]
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


def test_bridge_round_trips_bit_for_bit(setup):
    s = setup
    for tree, mod in ((s["params"], s["target"]), (s["mc"], s["comp"])):
        tree = jax.tree.map(np.asarray, tree)
        back = bridge.to_numpy(mod)
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_chunked_compress_matches_one_shot(setup):
    """MLA latents carried across chunk boundaries (40 = 16 + 16 + 8) land
    on the one-shot O^i (the JAX one-shot's, through ``setup``)."""
    pcfg = port_smoke_config(ARCH)
    pcfg = pcfg.replace(layout=dataclasses.replace(pcfg.layout, period=tuple(
        dataclasses.replace(d, mlp="dense") for d in pcfg.layout.period)))
    comp = memcom.init_memcom(pcfg, tfm.init_params(pcfg, 0, device="cpu"),
                              1)
    src = torch.as_tensor(setup["shots"][0][None])
    one, _ = memcom.compress(comp, pcfg, src)
    chk, _ = memcom.compress_chunked(comp, pcfg, src, chunk_size=16)
    for a, b in zip(one, chk):
        _close(b["h"], a["h"])


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
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(), **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), **kw)
    return j, p


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_jax(setup, layout):
    """Two tasks over two slots with refills, then requests without a
    prefix (the reference's paged-vs-dense MLA parity case), on the
    latent stripes or the latent pool."""
    s = setup
    kw = dict(slots=2, max_len=s["m"] + 24, kv_layout=layout)
    if layout == "paged":
        kw["block_size"] = 4
    j, p = _engines(s, **kw)
    for t, (jkv, kv) in enumerate(s["kvs"]):
        j.add_prefix(f"task{t}", jkv)
        p.add_prefix(f"task{t}", kv)
    rng = np.random.default_rng(5)
    specs = [dict(tokens=rng.integers(4, s["cfg"].vocab_size, n)
                  .astype(np.int32), max_new=mn, prefix=f"task{i % 2}",
                  uid=100 + i)
             for i, (n, mn) in enumerate(((6, 3), (9, 5), (4, 4), (12, 2)))]
    _serve_both(j, p, specs)
    _serve_both(j, p, [dict(tokens=rng.integers(4, s["cfg"].vocab_size, n)
                            .astype(np.int32), max_new=3, uid=200 + n)
                       for n in (4, 9)])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_step_matches_jax(setup, layout):
    """The fused step's ragged lanes through the absorbed decode."""
    s = setup
    kw = dict(slots=2, max_len=s["m"] + 40, kv_layout=layout,
              fused_step=True, fused_chunk_tokens=8)
    if layout == "paged":
        kw["block_size"] = 4
    j, p = _engines(s, **kw)
    j.add_prefix("task0", s["kvs"][0][0])
    p.add_prefix("task0", s["kvs"][0][1])
    rng = np.random.default_rng(6)
    _serve_both(j, p, [dict(tokens=rng.integers(4, s["cfg"].vocab_size, n)
                            .astype(np.int32), max_new=4, prefix="task0",
                            uid=300 + i)
                       for i, n in enumerate((5, 11, 3))])


def _rows_bit_exact(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert sorted(ea) == sorted(eb)
        for key in ea:
            assert ea[key].dtype == eb[key].dtype
            assert torch.equal(ea[key], eb[key]), key


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tier_round_trip_bit_exact(setup, layout, tmp_path):
    """Latents (prefix and period layers) survive demote → spill → promote
    byte for byte and serve the JAX engine's tokens."""
    s = setup
    ref = take_prefix_row(s["kvs"][0][1], 0)
    kw = dict(slots=2, max_len=s["m"] + 24, kv_layout=layout,
              host_capacity=4, promote_layer_budget=1)
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
    """A raw-shots request compiles on the serving path (16-token chunks)
    and emits the JAX engine's tokens."""
    s = setup
    kw = dict(slots=1, max_len=s["m"] + 24, kv_layout=layout,
              compile_token_budget=16)
    j = JaxEngine(s["cfg"], s["params"], clock=JClock(), compressor=s["mc"],
                  **kw)
    p = ServingEngine(s["pcfg"], s["target"], device="cpu",
                      clock=VirtualClock(), compressor=s["comp"], **kw)
    prompt = np.arange(4, 9, dtype=np.int32)
    _serve_both(j, p, [dict(tokens=prompt, max_new=4, prefix="task",
                            raw_shots=s["shots"][1], uid=7)])
    assert p.stats()["compiler"] == j.stats()["compiler"]


def test_launcher_matches_jax(monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.data import SyntheticVocab
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--requests", "4", "--tasks", "2",
            "--slots", "2", "--max-new", "4", "--context-tokens", "48",
            "--kv-layout", "paged", "--block-size", "4"]
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


# ---------------------------------------------------------------------------
# Dv != D in the kernel wrappers (routing only: no card here)
# ---------------------------------------------------------------------------


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA branch
    without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(t, grad=False):
    return torch.Tensor._make_subclass(_LooksCuda, t, grad)


class _Guard:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 0


@pytest.fixture
def launches(monkeypatch):
    """The ctypes kernels, the device guard and the stream stood in for;
    returns the list of (kernel, D, Dv, dtype code) launched."""
    calls = []

    def flash(*a):  # (8 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("flash", a[13], a[14], a[19]))
        return 0

    def wgmma(*a):  # (7 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("wgmma", a[12], a[13], 1))
        return 0

    def bwd(*a):  # (13 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ..., dtype)
        calls.append(("bwd", a[18], a[19], a[23]))
        return 0

    def bwd_wgmma(*a):  # (14 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("bwd_wgmma", a[19], a[20], 1))
        return 0

    def paged(*a):  # (6 pointers, B, S, Hq, Hkv, D, Dv, tD, tDv, ...)
        calls.append(("paged", a[10], a[11], a[19]))
        return 0

    monkeypatch.setattr(fa, "_kernel", lambda: (flash, None, wgmma))
    monkeypatch.setattr(fa, "_bwd_kernel",
                        lambda: (bwd, bwd_wgmma, lambda *a: 64))
    monkeypatch.setattr(fa, "_splits", lambda *a: 1)
    monkeypatch.setattr(fa, "_sms", lambda i: 132)
    monkeypatch.setattr(pa, "_kernel", lambda: paged)
    monkeypatch.setattr(pa, "_sms", lambda i: 132)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


def _qkv(B, S, L, Hq, Hkv, D, Dv, dtype, grad=False):
    g = torch.Generator().manual_seed(0)
    q = _fake(torch.randn(B, S, Hq, D, generator=g).to(dtype), grad)
    k = _fake(torch.randn(B, L, Hkv, D, generator=g).to(dtype))
    v = _fake(torch.randn(B, L, Hkv, Dv, generator=g).to(dtype))
    pos = _fake(torch.arange(L, dtype=torch.int32)[None].expand(B, L)
                .contiguous())
    return q, k, v, _fake(pos[:, L - S:].contiguous()), pos


@pytest.mark.parametrize("D,Dv,dtype,ok", [
    (192, 128, torch.bfloat16, True), (576, 512, torch.bfloat16, True),
    (192, 128, torch.float32, True), (576, 512, torch.float32, False),
    (264, 128, torch.bfloat16, False), (36, 16, torch.float32, False)])
def test_flash_dv_routing(launches, D, Dv, dtype, ok):
    """The pairs MLA needs go to the kernels with both widths and give a
    (.., Dv) output: bf16 (192, 128) to the wgmma variant (the mma.sync
    one when forced), (576, 512) to mma.sync (a forced wgmma variant
    raises there), float32 (192, 128) to the CUDA cores; pairs that no
    kernel takes, padded or not (past 256, no multiple of 8, (576, 512)
    in float32), raise."""
    q, k, v, q_pos, kv_pos = _qkv(2, 3, 40, 8, 1, D, Dv, dtype)
    if not ok:
        with pytest.raises(NotImplementedError):
            fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
        assert launches == []
        return
    before = fa.launches, fa.wgmma_launches
    out = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert tuple(out.shape) == (2, 3, 8, Dv)
    code = 1 if dtype == torch.bfloat16 else 0
    wg = code == 1 and (D, Dv) == (192, 128)
    assert launches == [("wgmma", D, Dv, 1) if wg else ("flash", D, Dv, code)]
    assert (fa.launches, fa.wgmma_launches) == (before[0] + 1,
                                                before[1] + wg)
    assert fa.variant_for(dtype, D, 40, 1, Dv) == (
        "wgmma" if wg else "mma_sync" if code else "float32")
    if wg:
        fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                           variant="mma_sync")
        assert launches[-1] == ("flash", D, Dv, 1)
    elif code:
        with pytest.raises(NotImplementedError):
            fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               variant="wgmma")


def test_flash_dv_refuses_a_gradient(launches):
    """A gradient-needing bf16 call at (192, 128) (MLA's non-absorbed
    prefill) goes through ``FlashAttention``: the wgmma forward, then the
    wgmma backward with both widths; at (576, 512) (the absorbed decode,
    which serves only) such a call raises before any launch, and so does
    its backward."""
    q, k, v, q_pos, kv_pos = _qkv(1, 4, 16, 4, 4, 192, 128, torch.bfloat16,
                                  grad=True)
    before = fa.bwd_launches, fa.bwd_wgmma_launches
    out = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert tuple(out.shape) == (1, 4, 4, 128) and out.requires_grad
    assert launches == [("wgmma", 192, 128, 1)]
    out.float().sum().backward()
    assert launches[1:] == [("bwd_wgmma", 192, 128, 1)]
    assert (fa.bwd_launches, fa.bwd_wgmma_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert tuple(q.grad.shape) == (1, 4, 4, 192)
    del launches[:]
    q, k, v, q_pos, kv_pos = _qkv(1, 4, 16, 4, 1, 576, 512, torch.bfloat16,
                                  grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert launches == []
    out = torch.zeros(1, 4, 4, 512, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 4)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention_bwd(q.detach(), k, v, _fake(out), _fake(lse),
                               _fake(out), q_pos=q_pos, kv_pos=kv_pos)
    assert launches == []
    with torch.no_grad():  # without a gradient the forward launches
        fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert launches == [("flash", 576, 512, 1)]


@pytest.mark.parametrize("D,Dv,dtype,want", [
    (192, 128, torch.bfloat16, ("bwd_wgmma", 192, 128, 1)),
    (192, 128, torch.float32, ("bwd", 192, 128, 0)),
    (576, 512, torch.bfloat16, None), (264, 128, torch.bfloat16, None),
    (256, 132, torch.float32, None)])
def test_flash_dv_backward_routing(launches, D, Dv, dtype, want):
    """``flash_attention_bwd`` at Dv != D: (192, 128) launches the bf16
    wgmma backward or the float32 one with both widths, out and dout
    checked at (.., Dv); a forced mma.sync variant raises there (it needs
    Dv == D), as does every pair no kernel takes, padded or not, before
    any launch."""
    q, k, v, q_pos, kv_pos = _qkv(1, 4, 16, 4, 4, D, Dv, dtype)
    out = _fake(torch.zeros(1, 4, 4, Dv, dtype=dtype))
    lse = _fake(torch.zeros(1, 4, 4))
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, scale=D ** -0.5)
    if want is None:
        with pytest.raises(NotImplementedError, match="backward"):
            fa.flash_attention_bwd(q, k, v, out, lse, out, **kw)
        assert launches == []
        return
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out, **kw)
    assert launches == [want]
    assert [tuple(t.shape) for t in (dq, dk, dv)] == [
        (1, 4, 4, D), (1, 16, 4, D), (1, 16, 4, Dv)]
    with pytest.raises(ValueError):  # out at the key width
        wide = _fake(torch.zeros(1, 4, 4, D, dtype=dtype))
        fa.flash_attention_bwd(q, k, v, wide, lse, wide, **kw)
    if dtype == torch.bfloat16:
        with pytest.raises(NotImplementedError, match="Dv == D"):
            fa.flash_attention_bwd(q, k, v, out, lse, out,
                                   variant="mma_sync", **kw)
    assert len(launches) == 1


@pytest.mark.parametrize("D,Dv,dtype,ok", [
    (576, 512, torch.bfloat16, True), (192, 128, torch.float32, True),
    (576, 512, torch.float32, False), (264, 128, torch.bfloat16, False)])
def test_paged_dv_routing(launches, D, Dv, dtype, ok):
    g = torch.Generator().manual_seed(1)
    q = _fake(torch.randn(2, 1, 16, D, generator=g).to(dtype))
    kp = _fake(torch.randn(9, 4, 1, D, generator=g).to(dtype))
    vp = _fake(torch.randn(9, 4, 1, Dv, generator=g).to(dtype))
    tables = _fake(torch.arange(1, 9, dtype=torch.int32).reshape(2, 4))
    lens = _fake(torch.tensor([5, 16], dtype=torch.int32))
    kw = dict(block_tables=tables, lengths=lens, scale=192 ** -0.5)
    if not ok:
        with pytest.raises(NotImplementedError):
            pa.paged_flash_decode(q, kp, vp, **kw)
        assert launches == []
        return
    before = pa.launches
    out = pa.paged_flash_decode(q, kp, vp, **kw)
    assert tuple(out.shape) == (2, 1, 16, Dv) and pa.launches == before + 1
    assert launches == [("paged", D, Dv, 1 if dtype == torch.bfloat16
                         else 0)]


def test_plain_ops_take_mla_widths(rng):
    """On the CPU the wrappers are the plain versions, whose Dv != D the
    JAX package's oracles hold (jnp_impl, decode through block tables)."""
    q = rng.standard_normal((2, 1, 8, 24)).astype(np.float32)
    k = rng.standard_normal((2, 10, 1, 24)).astype(np.float32)
    v = rng.standard_normal((2, 10, 1, 16)).astype(np.float32)
    lens = np.array([4, 10], np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), lengths=jnp.asarray(lens),
                                 scale=0.2)
    from repro_torch.kernels import ops

    got = ops.decode_attention(_t(q), _t(k), _t(v),
                               lengths=_t(lens, torch.int32), scale=0.2)
    assert tuple(got.shape) == (2, 1, 8, 16)
    _close(got, want)
