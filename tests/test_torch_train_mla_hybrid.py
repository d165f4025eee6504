"""The port's MemCom training path for MLA (deepseek-v2-236b) and the hybrid
Mamba2 / attention stack (jamba-1.5-large-398b) against the JAX package's,
on the CPU with smoke configs, parameters carried across by
``repro_torch.bridge`` and inputs made with numpy: ``memcom_loss`` and
every Phase-1 and Phase-2 gradient, the trainable masks, one Trainer step
and an exact restart; and the wgmma flash backward's arithmetic
(``plain.attention_bwd_tiled``) at MLA's head widths (D, Dv) = (192, 128).

Tolerances: the loss and each gradient leaf within 1e-4 of its own
largest gradient (float32; the frameworks sum in different orders), as
``tests/test_torch_train.py`` holds the dense and MoE stacks.  The JAX
gradients are taken once per model with every compressor leaf trainable
(Phase 2's mask): a leaf's gradient does not depend on which other leaves
``stop_gradient`` freezes, so Phase 1's are the same arrays restricted to
``memx`` and ``mem_tokens``, which the port computes with the stacks
frozen (no weight gradient forms for them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.kernels import plain
from repro_torch.launch import train as port_train

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
TOL = 1e-4
ARCHS = ["deepseek-v2-236b", "jamba-1.5-large-398b"]

# Phase-2 trainables that the loss never reads (the Memory-LLM is fed the
# memory tokens, not token ids; both stacks hand on their layers' K/V or
# state, not their final norms or heads): exactly 0 in both frameworks.
_UNREAD = {"memory_llm/embed/tokens", "memory_llm/final_norm/scale",
           "source/final_norm/scale", "memory_llm/lm_head",
           "source/lm_head"}


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """The JAX params and compressor, the batch, and the loss with the
    gradient of every compressor leaf (numpy), once per model."""
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    rng = np.random.default_rng(7)
    B, T, S = 2, 24, 12
    batch = {
        "source": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "target": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "target_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    loss, grads = jax.value_and_grad(
        lambda mc_: jmc.memcom_loss(mc_, params, cfg,
                                    jax.tree.map(jnp.asarray, batch))[0])(mc)
    grads = {p: np.asarray(g) for p, g in tree_flatten_with_names(grads)}
    masks = {ph: {p for p, on in tree_flatten_with_names(
        jmc.trainable_mask(mc, ph)) if on} for ph in (1, 2)}
    np_params = jax.tree.map(np.asarray, params)
    np_mc = jax.tree.map(np.asarray, mc)
    return cfg, np_params, np_mc, batch, float(loss), grads, masks


def _port(arch):
    """Fresh port modules bridged from the JAX trees."""
    _, np_params, np_mc, *_ = _jax_side(arch)
    pcfg = port_smoke_config(arch)
    pmc = bridge.from_jax_memcom(pcfg, np_mc, device="cpu")
    ptgt = bridge.from_jax_params(pcfg, np_params, device="cpu")
    return pcfg, pmc, ptgt


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_memcom_loss_and_grads_match_jax(arch, phase):
    """The loss (CE + MoE aux) and every trainable leaf's gradient: MLA's
    latent prefix (O^i through the layer's own ``wdkv``) carries Phase 1's
    gradient into ``memx``; in Phase 2 it reaches ``wukv`` through the
    expanded values' copy, and the hybrid's handed-off SSM state carries
    the target's gradient into the Source-LLM's Mamba2 layers."""
    _, _, _, batch, jloss, grads, masks = _jax_side(arch)
    pcfg, pmc, ptgt = _port(arch)
    trained = memcom.set_trainable(pmc, phase)
    ploss, aux = memcom.memcom_loss(pmc, ptgt, pcfg, _torch_batch(batch))
    pg = torch.autograd.grad(ploss, list(trained.values()),
                             allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(ploss.detach()), jloss, rtol=TOL,
                               atol=TOL)
    assert float((aux["ce"] + aux["moe"]).detach()) == float(ploss.detach())
    per = {}
    for n, g in zip(trained, pg):
        per.setdefault(bridge.jax_path(pcfg, "memcom", n), []).append(
            g.detach().numpy())
    assert set(per) == masks[phase]
    for path, lst in per.items():
        want = grads[path]
        got = np.stack(lst) if want.ndim == lst[0].ndim + 1 else lst[0]
        big = float(np.abs(want).max())
        if path in _UNREAD:
            assert big == 0.0 and not np.any(got), path
            continue
        assert big >= 1e-6, (path, big)  # no comparison passes vacuously
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * big,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_mask_and_set_trainable_per_phase(arch):
    """The port's mask equals the JAX package's, leaf by leaf (the hybrid's
    Mamba2 layers hold no ``memx``: their holes keep the layer index), and
    ``set_trainable`` turns on exactly the phase's parameters."""
    _, _, np_mc, _, _, _, _ = _jax_side(arch)
    _, pmc, _ = _port(arch)
    for phase in (1, 2):
        want = dict(tree_flatten_with_names(jmc.trainable_mask(np_mc,
                                                               phase)))
        assert memcom.trainable_mask(pmc, phase) == want
        trained = memcom.set_trainable(pmc, phase)
        for name, p in pmc.named_parameters():
            assert p.requires_grad == (name in trained)
            if phase == 1:
                assert p.requires_grad == name.startswith(("memx.",
                                                           "mem_tokens"))
    holes = [i for i, x in enumerate(memcom.memx_list(pmc.memx)) if x is None]
    kinds = [d.mixer for d in pmc.cfg.layout.descriptors()]
    assert holes == [i for i, k in enumerate(kinds) if k == "mamba"]


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_step_and_exact_restart(tmp_path, arch):
    """Phase 1 through the launcher's ``build`` on the CPU: two Trainer
    steps with a checkpoint after each, then a second Trainer restored
    from step 1 reproduces step 2's loss and trained tensors bit for bit;
    the frozen tensors do not move."""
    cfg = port_smoke_config(arch)
    kw = dict(phase=1, batch=2, seq=24, split=16, steps=2, ckpt_every=1,
              ckpt=str(tmp_path), device="cpu", log_every=1)
    run = port_train.build(cfg, **kw)
    frozen = {n: p.detach().clone() for n, p in run.mc.named_parameters()
              if n not in run.params}
    start = {n: p.detach().clone() for n, p in run.params.items()}
    run.trainer.run()
    losses = dict(run.trainer.losses)
    assert sorted(losses) == [1, 2] and all(np.isfinite(list(
        losses.values())))
    assert all(not torch.equal(p, start[n]) for n, p in run.params.items())
    assert all(torch.equal(p, frozen[n]) for n, p in
               run.mc.named_parameters() if n in frozen)
    final = {n: p.detach().clone() for n, p in run.params.items()}
    again = port_train.build(cfg, **kw)
    assert again.trainer.restore_if_available(step=1) == 1
    again.trainer.run()
    assert again.trainer.losses == {2: losses[2]}
    assert all(torch.equal(p, final[n]) for n, p in again.params.items())


# (B, Sq, Skv, Hq, Hkv, layout, dlse): MLA's per-head keys of 192 and
# values of 128, scale 192^-0.5, tiles of 16 rows so that the walks cross
# several tiles (the kernel's are 64)
TILED_DV_CASES = [
    (1, 40, 40, 4, 4, "causal", False),
    (2, 24, 24, 2, 2, "offset", True),     # a prompt at offset 40
    (2, 24, 40, 4, 2, "prefix", True),     # against a prefix, GQA fold 2
    (1, 37, 53, 2, 2, "prefix", False),
]


@pytest.mark.parametrize("case", TILED_DV_CASES)
def test_attention_bwd_tiled_at_mla_widths(rng, case):
    """The wgmma backward's restated arithmetic at (D, Dv) = (192, 128),
    its P and dS unrounded and its KV walks split in two, against the
    explicit formulas (``plain.attention_bwd_ref``), with and without an
    lse cotangent: float32, within 1e-4 of each gradient's largest
    magnitude."""
    B, Sq, Skv, Hq, Hkv, layout, with_dlse = case
    D, Dv, scale, tile = 192, 128, 192 ** -0.5, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.5)

    q, dout = t(B, Sq, Hq, D), t(B, Sq, Hq, Dv)
    k, v = t(B, Skv, Hkv, D), t(B, Skv, Hkv, Dv)
    ar = lambda lo, n: (lo + torch.arange(n, dtype=torch.int32)).expand(  # noqa: E731
        B, n).contiguous()
    q_pos, kv_pos, causal = {
        "causal": (ar(0, Sq), ar(0, Skv), True),
        "offset": (ar(40, Sq), ar(40, Skv), True),
        "prefix": (ar(Skv, Sq), ar(0, Skv), False)}[layout]
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, scale=scale)
    out, lse = plain.attention_ref(q, k, v, return_lse=True, **kw)
    dlse = t(B, Sq, Hq) if with_dlse else None
    want = plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse, **kw)
    nq = -(-Sq * (Hq // Hkv) // tile)
    split_at = [nq // 2] * -(-Skv // tile)
    got = plain.attention_bwd_tiled(q, k, v, out, lse, dout, dlse,
                                    round_p=False, split_at=split_at,
                                    tile=tile, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        big = float(w.abs().max())
        assert big > 1e-3, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * big, err_msg=name)
    # rounded P and dS stay within bf16's reach of the exact gradients
    rounded = plain.attention_bwd_tiled(q, k, v, out, lse, dout, dlse,
                                        tile=tile, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), rounded, want):
        assert plain.grad_err(g, w) <= 2e-2, name
