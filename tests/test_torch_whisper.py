"""The port's whisper-medium (enc-dec: an encoder over precomputed frame
embeddings with sinusoidal positions, decoder blocks that cross-attend to
its output, learned decoder positions, layernorm and gelu MLPs) against
the JAX package's, on whisper-medium-smoke (float32) on the CPU.

Both packages run in one process on inputs made with numpy from a seed,
the port on parameters carried across by ``repro_torch.bridge``.  The
cross block has three paths, as in the JAX package: to the encoder's
output where given, to the cache's cross entries where it has them, and
with neither the fall-through of ``models/attention.py`` (a causal
self-attention with the cross weights).  Without frames the one-shot
compress runs the fall-through and the chunked one the zero cross
entries of its Source-LLM cache, so the two prefixes differ: the port
gives the JAX package's answer on each, and the tests require that they
differ as the JAX package's do.  Tolerances: 1e-4 (float32; the
frameworks sum in different orders), gradients within 1e-4 of their own
largest value, parameters bit for bit, tokens identical.
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
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.serving import ServingEngine as JaxEngine
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serving import ServingEngine
from repro_torch.serving.prefix_store import write_prefix_to_cache

ARCH = "whisper-medium"
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
    np_params = jax.tree.map(np.asarray, params)
    np_mc = jax.tree.map(np.asarray, mc)
    target = bridge.from_jax_params(pcfg, np_params, device="cpu")
    comp = bridge.from_jax_memcom(pcfg, np_mc, device="cpu")
    rng = np.random.default_rng(21)
    frames = (rng.standard_normal((2, cfg.encoder.num_frames, cfg.d_model))
              * 0.1).astype(np.float32)
    return dict(cfg=cfg, pcfg=pcfg, params=params, mc=mc, target=target,
                comp=comp, np_params=np_params, np_mc=np_mc, frames=frames,
                m=cfg.memcom.num_memory_tokens)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _tok(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.long)


def test_config_is_a_copy():
    for a, b in ((get_config(ARCH), port_config(ARCH)),
                 (get_smoke_config(ARCH), port_smoke_config(ARCH))):
        assert a.to_json() == b.to_json()
        assert a.encoder is not None and a.pos_embed == "learned"


def test_bridge_round_trips_bit_for_bit(setup):
    """The stacked encoder (``encoder/period/l0``), ``embed/pos``,
    ``xattn_enc`` and ``norm_x``, both ways, for a transformer and a
    compressor."""
    s = setup
    for tree, module in ((s["np_params"], s["target"]),
                         (s["np_mc"], s["comp"])):
        back = bridge.to_numpy(module)
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    names = dict(s["target"].named_parameters())
    assert tuple(names["embed.pos"].shape) == (s["cfg"].max_seq,
                                               s["cfg"].d_model)
    assert len(s["target"].encoder.layers) == s["cfg"].encoder.num_layers
    assert "layers.1.xattn_enc.wq" in names and "layers.1.norm_x.bias" in names
    assert (bridge.jax_path(s["pcfg"], "transformer",
                            "encoder.layers.1.attn.wk")
            == "encoder/period/l0/attn/wk")


def test_sinusoidal_positions_and_encode_match_jax(setup):
    from repro.models import layers as jlayers

    s = setup
    _close(layers.sinusoidal_pos_embed(37, 64),
           jlayers.sinusoidal_pos_embed(37, 64), 1e-5)
    want = jtfm.encode(s["params"]["encoder"], s["cfg"],
                       jnp.asarray(s["frames"]))
    got = s["target"].encoder(_t(s["frames"]))
    _close(got, want)


def test_forward_with_frames_matches_jax(setup, rng):
    s = setup
    toks = rng.integers(0, s["cfg"].vocab_size, (2, 12)).astype(np.int32)
    want, jaux = jtfm.forward(s["params"], s["cfg"], tokens=jnp.asarray(toks),
                              encoder_frames=jnp.asarray(s["frames"]))
    got, aux = s["target"](tokens=_tok(toks), encoder_frames=_t(s["frames"]))
    _close(got, want)
    _close(aux["encoder_out"], jaux["encoder_out"])
    # without frames the cross blocks fall through, as the JAX ones do
    want0, _ = jtfm.forward(s["params"], s["cfg"], tokens=jnp.asarray(toks))
    got0, aux0 = s["target"](tokens=_tok(toks))
    _close(got0, want0)
    assert aux0["encoder_out"] is None
    assert float((got0 - got).abs().max()) > 1e-3


@pytest.mark.parametrize("with_out,n_frames", [(True, 8), (False, 24),
                                              (False, 8)])
def test_prefill_with_frames_then_decode_from_the_cross_cache(
        setup, rng, with_out, n_frames):
    """The reference's prefill / decode parity case: prefill 12 tokens
    with frames (the cross entries are written: in place at the config's
    24 frames, rebound to 8 frames as the JAX cache takes their length),
    then one decode step, with the encoder output passed again
    (``with_out``) or read back from the cross cache alone
    (``build_decode_step``); both match the full forward and the JAX
    model."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    B, S = 2, 12
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    fr = s["frames"][:, :n_frames]
    jfull, _ = jtfm.forward(s["params"], cfg, tokens=jnp.asarray(toks),
                            encoder_frames=jnp.asarray(fr))
    full, _ = s["target"](tokens=_tok(toks), encoder_frames=_t(fr))
    _close(full, jfull)
    pre, cache = steps.build_prefill_step(pcfg, S + 8)(
        s["target"], {"source": _tok(toks[:, :S]), "frames": _t(fr)})
    _close(pre[:, 0], full[:, S - 1])
    jpre, jcache = jsteps.build_prefill_step(cfg, S + 8)(
        s["params"], {"source": jnp.asarray(toks[:, :S]),
                      "frames": jnp.asarray(fr)})
    _close(pre, jpre)
    jck = bridge.layerwise_to_list(cfg, jcache)
    for c, jc in zip(cache, jck):
        assert c["ck"].shape[1] == n_frames
        _close(c["ck"], jc["ck"])
        _close(c["k"], jc["k"])
    if with_out:
        enc = s["target"].encoder(_t(fr))
        dec, _ = s["target"](tokens=_tok(toks[:, S:]), cache=cache,
                             cache_index=S, decode=True, encoder_out=enc)
    else:
        dec, _ = steps.build_decode_step(pcfg)(
            s["target"], cache, {"tokens": _tok(toks[:, S:]),
                                 "cache_index": torch.tensor(
                                     [S, S], dtype=torch.int32)})
    _close(dec[:, 0], full[:, S])
    jdec, _ = jsteps.build_decode_step(cfg, impl="auto")(
        s["params"], jcache, {"tokens": jnp.asarray(toks[:, S:]),
                              "cache_index": S})
    _close(dec[:, 0], jdec[:, 0])


def test_compress_with_frames_one_shot_and_chunked(setup, rng):
    """O^i with 24 frames through the Source-LLM's encoder (its output
    threaded to the Memory-LLM), one-shot and in 16-token slices; the
    materialized cache and the encoder output of ``build_compress_step``
    against the JAX step's; the target behind it with the frames."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    src = rng.integers(4, cfg.vocab_size, (1, 40)).astype(np.int32)
    fr = s["frames"][:1]
    jp, jinfo = jmc.compress(s["mc"], cfg, jnp.asarray(src),
                             encoder_frames=jnp.asarray(fr))
    jl = bridge.layerwise_to_list(cfg, jp)
    pp, info = memcom.compress(s["comp"], pcfg, _t(src),
                               encoder_frames=_t(fr))
    _close(info["encoder_out"], jinfo["encoder_out"])
    for a, b in zip(pp, jl):
        _close(a["h"], b["h"])
    jc, _ = jmc.compress_chunked(s["mc"], cfg, jnp.asarray(src),
                                 chunk_size=16, encoder_frames=jnp.asarray(fr))
    pc, cinfo = memcom.compress_chunked(s["comp"], pcfg, _t(src),
                                        chunk_size=16, encoder_frames=_t(fr))
    for a, b, one in zip(pc, bridge.layerwise_to_list(cfg, jc), pp):
        _close(a["h"], b["h"])
        _close(a["h"], one["h"])
    _close(cinfo["encoder_out"], info["encoder_out"])
    jkv, jenc = jsteps.build_compress_step(cfg)(
        s["mc"], s["params"], {"source": jnp.asarray(src),
                               "frames": jnp.asarray(fr)})
    kv, enc = steps.build_compress_step(pcfg)(
        s["comp"], s["target"], {"source": _t(src), "frames": _t(fr)})
    _close(enc, jenc)
    for a, b in zip(kv, bridge.layerwise_to_list(cfg, jkv)):
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])
    prompt = rng.integers(4, cfg.vocab_size, (1, 6)).astype(np.int32)
    want, _ = jtfm.forward(s["params"], cfg, tokens=jnp.asarray(prompt),
                           prefix=jkv, mask_offset=s["m"],
                           encoder_out=jenc)
    got, _ = s["target"](tokens=_tok(prompt), prefix=kv, mask_offset=s["m"],
                         encoder_out=enc)
    _close(got, want)


def test_compress_without_frames_on_both_paths(setup, rng):
    """Without frames each path gives the JAX package's prefix: the
    one-shot compress's cross blocks fall through (causal self-attention
    with the cross weights), the chunked one's attend to their zero cross
    entries, so the two differ, in both packages alike."""
    s = setup
    cfg, pcfg = s["cfg"], s["pcfg"]
    src = rng.integers(4, cfg.vocab_size, (1, 40)).astype(np.int32)
    jp, _ = jmc.compress(s["mc"], cfg, jnp.asarray(src))
    jc, _ = jmc.compress_chunked(s["mc"], cfg, jnp.asarray(src),
                                 chunk_size=16)
    pp, info = memcom.compress(s["comp"], pcfg, _t(src))
    pc, _ = memcom.compress_chunked(s["comp"], pcfg, _t(src), chunk_size=16)
    assert info["encoder_out"] is None
    jl, jcl = (bridge.layerwise_to_list(cfg, x) for x in (jp, jc))
    for a, b in zip(pp, jl):
        _close(a["h"], b["h"])
    for a, b in zip(pc, jcl):
        _close(a["h"], b["h"])
    apart = max(float((a["h"] - b["h"]).abs().max()) for a, b in zip(pp, pc))
    japart = max(float(np.abs(a["h"] - b["h"]).max())
                 for a, b in zip(jl, jcl))
    assert apart > 1e-2 and abs(apart - japart) <= TOL * max(1.0, japart)


def test_memcom_loss_with_frames_and_phase1_grads_match_jax(setup):
    cfg, params, mc = _jax_side()
    s = setup
    rng = np.random.default_rng(7)
    batch = {
        "source": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
        "target": rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32),
        "target_mask": (rng.random((2, 12)) > 0.2).astype(np.float32),
        "frames": s["frames"]}
    jloss, jgrads = jax.value_and_grad(
        lambda mc_: jmc.memcom_loss(mc_, params, cfg,
                                    jax.tree.map(jnp.asarray, batch))[0])(mc)
    jgrads = {p: np.asarray(g) for p, g in tree_flatten_with_names(jgrads)}
    pcfg = s["pcfg"]
    pmc = bridge.from_jax_memcom(pcfg, s["np_mc"], device="cpu")
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


def test_caches_carry_per_slot_cross_entries(setup):
    """Both layouts keep each decoder block's ``ck`` / ``cv`` per slot
    beside its K/V stripes or pools; a prefix seats no cross entry."""
    pcfg = setup["pcfg"]
    F_, H, hd = pcfg.encoder.num_frames, pcfg.num_heads, pcfg.hd
    dense = tfm.init_cache(pcfg, 3, 40, device="cpu")
    paged = tfm.init_paged_cache(pcfg, num_blocks=9, block_size=4, slots=3,
                                 device="cpu")
    for c, p in zip(dense, paged):
        assert set(c) == set(p) == {"k", "v", "ck", "cv"}
        assert tuple(c["ck"].shape) == tuple(p["ck"].shape) == (3, F_, H, hd)
        assert tuple(p["k"].shape) == (9, 4, pcfg.num_kv_heads, hd)
    prefix = [{"k": torch.ones(3, 8, pcfg.num_kv_heads, hd),
               "v": torch.ones(3, 8, pcfg.num_kv_heads, hd)}
              for _ in dense]
    write_prefix_to_cache(pcfg, dense, prefix)
    assert all(float(c["ck"].abs().max()) == 0.0 for c in dense)


def test_fused_step_refused_as_jax_refuses_it(setup):
    s = setup
    kw = dict(slots=2, max_len=s["m"] + 24, fused_step=True)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(s["cfg"], s["params"], **kw)
    with pytest.raises(ValueError) as perr:
        ServingEngine(s["pcfg"], s["target"], device="cpu", **kw)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("mode", ["dense", "paged", "raw"])
def test_launcher_matches_jax(monkeypatch, mode):
    """The launcher (no frames, as in the JAX one) emits the JAX
    launcher's tokens: compressed tasks on the dense and paged layouts,
    and raw shots compiled online in chunks."""
    from repro.launch import serve as jserve
    from repro_torch.data import SyntheticVocab
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--tasks", "2",
            "--slots", "2", "--max-new", "4", "--context-tokens", "48"]
    argv += {"dense": [], "raw": ["--raw-shots"],
             "paged": ["--kv-layout", "paged", "--block-size", "4"]}[mode]
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
