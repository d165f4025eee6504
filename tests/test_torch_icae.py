"""The port's ICAE / ICAE+ / ICAE++ baselines (``repro_torch.core.icae``)
against the JAX package's (``repro.core.icae``), on the CPU with the smoke
configs of smollm-135m, gemma2-2b (its embedding scale multiplies the soft
tokens and ``mem_embed`` too) and mistral-7b for each variant, plus
granite-moe-3b-a800m's for the ``moe_loss`` term; parameters carried
across by ``repro_torch.bridge``, inputs made with numpy.  Every adapter's
``b`` is drawn off zero first: at init every gradient of ``a`` is 0.

Tolerances (float32; the frameworks sum in different orders): soft tokens
and losses 1e-4; each trained gradient 1e-4 of its largest magnitude; two
train steps against the JAX step rebuilt from ``repro.optim`` (AdamW with
the mask, ``clip_by_global_norm``, ``warmup_constant``) 1e-4 on the
losses, the trained tensors and the AdamW moments (the moments of their
largest magnitude), the frozen tensors bit for bit.  The step on the card,
kernels against the plain versions, is in ``test_torch_cuda_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import icae as jicae
from repro.models import transformer as jtfm
from repro.optim import AdamW as JAdamW
from repro.optim import clip_by_global_norm as jclip
from repro.optim import warmup_constant as jwconst
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import icae
from repro_torch.launch import steps as port_steps

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
TOL = 1e-4
ARCHS = ["smollm-135m", "gemma2-2b", "mistral-7b"]
VARIANTS = ["icae", "icae+", "icae++"]
CASES = [(a, v) for a in ARCHS for v in VARIANTS] + [
    ("granite-moe-3b-a800m", "icae++")]


def _perturb_b(tree, seed=5):
    rng = np.random.default_rng(seed)

    def f(path, x):
        return (jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
                if path[-1].key == "b" else x)
    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _jax_side(arch, variant):
    """JAX target params and ICAE tree (b off zero), and a batch."""
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    ic = jicae.init_icae(cfg, params, variant=variant, seed=1)
    ic["lora"] = _perturb_b(ic["lora"])
    rng = np.random.default_rng(3)
    B, T, S = 2, 20, 12
    batch = {
        "source": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "target": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "target_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    return cfg, params, ic, batch


def _port_side(arch, variant):
    """Fresh port modules holding the JAX side's tensors."""
    cfg, params, ic, batch = _jax_side(arch, variant)
    pcfg = port_smoke_config(arch)
    pic = bridge.from_jax_icae(pcfg, jax.tree.map(np.asarray, ic), variant,
                               device="cpu")
    ptgt = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return pcfg, pic, ptgt, {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_ref(arch, variant):
    """The JAX side's results, computed once a case: the soft tokens, the
    loss, its parts and its gradients (``stop_gradient`` on the frozen
    leaves), and two steps of the ``benchmarks/common.py`` ICAE step
    (AdamW with the mask, clip at 1.0, ``warmup_constant(2e-3, 30)``)."""
    cfg, params, ic, batch = _jax_side(arch, variant)
    mask = jicae.icae_trainable_mask(ic, variant)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(c):
        c = jax.tree.map(lambda x, mk: x if mk else jax.lax.stop_gradient(x),
                         c, mask)
        return jicae.icae_loss(c, params, cfg, jbatch)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, aux), grads = grad_fn(ic)
    soft = jax.jit(lambda c: jicae.icae_compress(c, cfg, jbatch["source"]))(ic)
    opt = JAdamW(lr=jwconst(2e-3, 30), mask=mask)
    c, state, losses = ic, opt.init(ic), []
    for i in range(2):
        (l, _), g = (loss, aux), grads
        if i:
            (l, _), g = grad_fn(c)
        g, _ = jclip(g, 1.0)
        c, state = opt.step(c, g, state)
        losses.append(float(l))
    return dict(mask=mask, soft=np.asarray(soft), loss=float(loss),
                moe=float(aux["moe"]),
                grads=dict(tree_flatten_with_names(grads)),
                steps=(dict(tree_flatten_with_names(c)), state, losses))


def _by_path(pcfg, named):
    """Port {name: tensor} -> {JAX path: [arrays]}, one a period layer."""
    out = {}
    for n, t in named.items():
        out.setdefault(bridge.jax_path(pcfg, "icae", n), []).append(
            t.detach().numpy())
    return out


def _stacked(want, lst):
    return np.stack(lst) if np.ndim(want) == lst[0].ndim + 1 else lst[0]


@pytest.mark.parametrize("arch,variant", CASES)
def test_compress_and_loss_match_jax(arch, variant):
    cfg = get_smoke_config(arch)
    ref = _jax_ref(arch, variant)
    pcfg, pic, ptgt, pbatch = _port_side(arch, variant)
    with torch.no_grad():
        soft = icae.icae_compress(pic, pcfg, pbatch["source"])
        loss, aux = icae.icae_loss(pic, ptgt, pcfg, pbatch)
    assert tuple(soft.shape) == (2, cfg.memcom.num_memory_tokens,
                                 cfg.d_model)
    np.testing.assert_allclose(soft.numpy(), ref["soft"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux["moe"]), ref["moe"], rtol=TOL,
                               atol=TOL)
    assert (float(aux["moe"]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_counts_match_jax_and_rise_along_the_ladder(arch):
    """The mask keyed by JAX path equals the JAX package's, the trainable
    counts equal, and they rise strictly icae < icae+ < icae++
    (``tests/test_memcom.py:184``)."""
    counts = {}
    for variant in VARIANTS:
        _, _, ic, _ = _jax_side(arch, variant)
        pcfg, pic, _, _ = _port_side(arch, variant)
        want = dict(tree_flatten_with_names(
            jicae.icae_trainable_mask(ic, variant)))
        assert icae.icae_trainable_mask(pic) == want
        leaves = dict(tree_flatten_with_names(ic))
        n_jax = sum(int(np.prod(leaves[p].shape)) for p, m in want.items()
                    if m)
        trained = icae.set_trainable(pic)
        for name, p in pic.named_parameters():
            assert p.requires_grad == (name in trained)
        counts[variant] = sum(p.numel() for p in trained.values())
        assert counts[variant] == n_jax
        assert "mem_embed" in trained
    assert counts["icae"] < counts["icae+"] < counts["icae++"]


@pytest.mark.parametrize("arch,variant", CASES)
def test_trained_gradients_match_jax(arch, variant):
    """``jax.grad`` with ``stop_gradient`` on the frozen leaves against the
    port's backward on the variant's trainable tensors; the frozen tensors
    (the target's and the compressor's others) get no ``.grad``."""
    ref = _jax_ref(arch, variant)
    pcfg, pic, ptgt, pbatch = _port_side(arch, variant)
    gflat = ref["grads"]
    trained = icae.set_trainable(pic)
    loss, _ = icae.icae_loss(pic, ptgt, pcfg, pbatch)
    loss.backward()
    for name, p in list(pic.named_parameters()) + [
            ("target." + n, p) for n, p in ptgt.named_parameters()]:
        assert (p.grad is not None) == (name in trained), name
    per = _by_path(pcfg, {n: p.grad for n, p in trained.items()})
    assert set(per) == {p for p, m in tree_flatten_with_names(ref["mask"])
                        if m}
    for path, lst in per.items():
        want = np.asarray(gflat[path])
        big = float(np.abs(want).max())
        assert big >= 1e-5, (path, big)
        np.testing.assert_allclose(_stacked(want, lst), want, rtol=0,
                                   atol=TOL * big, err_msg=path)


@pytest.mark.parametrize("arch,variant", CASES)
def test_two_train_steps_match_the_jax_step(arch, variant):
    want, jstate, jlosses = _jax_ref(arch, variant)["steps"]
    pcfg, pic, ptgt, pbatch = _port_side(arch, variant)
    frozen = {n: p.detach().clone() for n, p in pic.named_parameters()}
    tgt0 = {n: p.detach().clone() for n, p in ptgt.named_parameters()}
    step, popt, trained = port_steps.build_icae_train_step(pcfg, pic, ptgt)
    assert float(popt.lr(1)) == float(jwconst(2e-3, 30)(jnp.int32(1)))
    state = popt.init(trained)
    losses = []
    for _ in range(2):
        trained, state, m = step(trained, state, pbatch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    for path, lst in _by_path(pcfg, trained).items():
        w = np.asarray(want[path])
        got = _stacked(w, lst)
        start = _stacked(w, [v for n, v in _by_path(pcfg, frozen).items()
                             if n == path][0])
        assert np.abs(got - start).max() > 1e-5, path  # it moved
        np.testing.assert_allclose(got, w, rtol=0, atol=TOL, err_msg=path)
    for key in ("mu", "nu"):
        for path, lst in _by_path(pcfg, {n: state[key][n]
                                         for n in trained}).items():
            w = np.asarray(jstate[key][path])
            np.testing.assert_allclose(
                _stacked(w, lst), w, rtol=0,
                atol=TOL * float(np.abs(w).max()), err_msg=f"{key} {path}")
    for n, p in pic.named_parameters():
        if n not in trained:
            assert torch.equal(p, frozen[n]), n
    for n, p in ptgt.named_parameters():
        assert torch.equal(p, tgt0[n]) and not p.requires_grad, n


@pytest.mark.parametrize("variant", ["icae", "icae+"])
def test_remat_recomputes_on_the_merged_weights(variant):
    """Under remat each block is recomputed in the backward pass: it must
    read the same LoRA-merged tensors (b is off zero, so the unmerged
    weights would give other gradients), and the loss and every trained
    gradient come out as without remat."""
    pcfg, pic, ptgt, pbatch = _port_side("gemma2-2b", variant)
    trained = icae.set_trainable(pic)
    out = []
    for remat in (False, True):
        loss, _ = icae.icae_loss(pic, ptgt, pcfg, pbatch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, list(trained.values()))))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_compressor_owns_its_tensors():
    """init_icae copies the target: training icae++ moves the compressor's
    attention, never the target's."""
    pcfg = port_smoke_config("smollm-135m")
    from repro_torch.models import transformer as tfm
    target = tfm.init_params(pcfg, 0, device="cpu")
    ic = icae.init_icae(pcfg, target, "icae++", seed=1)
    ours = {p.data_ptr() for p in ic.compressor.parameters()}
    assert not ours & {p.data_ptr() for p in target.parameters()}
    for (n, a), (_, b) in zip(ic.compressor.named_parameters(),
                              target.named_parameters()):
        assert torch.equal(a, b), n
    assert not ic.lora.adapters()
    assert ic.mem_embed.dtype == torch.float32  # the smoke config's type
