"""The port's training path against the JAX package's, on the CPU with
smoke configs, parameters carried across by ``repro_torch.bridge`` and
inputs made with numpy: ``memcom_loss`` and its gradients in both phases,
the trainable masks, chunked compression, the optimizer and gradient
transforms on equal gradients, the train step's ``accum``/``grad_bf16``,
the step builders and the launcher.

Tolerances: modules 1e-4 (float32; the frameworks sum in different
orders), the optimizer and transforms 1e-6 (element-wise float32
arithmetic).  AdamW is compared on equal gradients fed from numpy, not
after two different gradient computations: its first step moves each
element by about +-lr whatever the gradient's size, so a 1e-9 difference
of sign in a tiny gradient would move a parameter by 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.optim import AdamW as JAdamW
from repro.optim import ErrorFeedbackInt8 as JEF
from repro.optim import clip_by_global_norm as jclip
from repro.optim import compress_grads_bf16 as jbf16
from repro.optim import warmup_constant as jwconst
from repro.optim import warmup_cosine as jwcos
from repro.train import build_train_step as jbuild
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import memcom
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.optim import (AdamW, ErrorFeedbackInt8, clip_by_global_norm,
                               compress_grads_bf16, warmup_constant,
                               warmup_cosine)
from repro_torch.train import build_train_step

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
TOL = 1e-4
OPT_TOL = 1e-6
ARCHS = ["smollm-135m", "gemma2-2b", "granite-moe-3b-a800m"]


def _setup(arch):
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    pcfg = port_smoke_config(arch)
    np_mc = jax.tree.map(np.asarray, mc)
    pmc = bridge.from_jax_memcom(pcfg, np_mc, device="cpu")
    ptgt = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return cfg, params, mc, pcfg, pmc, ptgt


def _batch(cfg, rng, B=2, T=24, S=12):
    return {"source": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "target": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "target_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_loss(mc, params, cfg, batch, phase):
    mask = jmc.trainable_mask(mc, phase)

    def loss(mc_):
        mc_ = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x),
                           mc_, mask)
        return jmc.memcom_loss(mc_, params, cfg,
                               jax.tree.map(jnp.asarray, batch))[0]

    return jax.value_and_grad(loss)(mc)


def _by_jax_path(pcfg, named):
    """Port {name: tensor} -> {JAX path: array}, period layers stacked."""
    out = {}
    for n, g in named.items():
        out.setdefault(bridge.jax_path(pcfg, "memcom", n), []).append(
            g.detach().numpy())
    return out


# Phase-2 trainables that the loss never reads (the Memory-LLM is fed the
# memory tokens, not token ids; both stacks hand on their layers' K/V, not
# their final norms): their gradient is exactly 0 in both frameworks.
_UNREAD = {"memory_llm/embed/tokens", "memory_llm/final_norm/scale",
           "source/final_norm/scale"}


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_memcom_loss_and_grads_match_jax(rng, arch, phase):
    cfg, params, mc, pcfg, pmc, ptgt = _setup(arch)
    batch = _batch(cfg, rng)
    loss, grads = _jax_loss(mc, params, cfg, batch, phase)
    gflat = dict(tree_flatten_with_names(grads))
    trained = memcom.set_trainable(pmc, phase)
    ploss, aux = memcom.memcom_loss(pmc, ptgt, pcfg, _torch_batch(batch))
    pg = torch.autograd.grad(ploss, list(trained.values()),
                             allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=TOL,
                               atol=TOL)
    assert float((aux["ce"] + aux["moe"]).detach()) == float(ploss.detach())
    per = _by_jax_path(pcfg, dict(zip(trained, pg)))
    want_paths = {p for p, m in tree_flatten_with_names(
        jmc.trainable_mask(mc, phase)) if m}
    assert set(per) == want_paths
    for path, lst in per.items():
        want = np.asarray(gflat[path])
        got = np.stack(lst) if want.ndim == lst[0].ndim + 1 else lst[0]
        big = float(np.abs(want).max())
        if path in _UNREAD:
            assert big == 0.0 and not np.any(got), path
            continue
        # each leaf against its own largest gradient (smoke-width leaves
        # reach only 2e-4), and each far above the float32 noise of a
        # loss of ~6.6, so that no comparison passes vacuously
        assert big >= 1e-5, (path, big)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * big,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_mask_and_set_trainable_per_phase(arch):
    cfg, params, mc, pcfg, pmc, _ = _setup(arch)
    for phase in (1, 2):
        want = dict(tree_flatten_with_names(jmc.trainable_mask(mc, phase)))
        assert memcom.trainable_mask(pmc, phase) == want
        trained = memcom.set_trainable(pmc, phase)
        for name, p in pmc.named_parameters():
            assert p.requires_grad == (name in trained)
            if phase == 1:
                assert p.requires_grad == name.startswith(("memx.",
                                                           "mem_tokens"))
    assert all(p.requires_grad for p in pmc.parameters())  # phase 2 left on


@pytest.mark.parametrize("arch", ARCHS)
def test_init_memx_draws_init_memcoms_memx(arch):
    """``init_memx(cfg, s)`` equals ``init_memcom(cfg, target, s).memx``
    bit for bit, tensor by tensor."""
    from repro_torch.models import transformer as tfm

    pcfg = port_smoke_config(arch)
    target = tfm.init_params(pcfg, 0, device="cpu")
    want = dict(memcom.init_memcom(pcfg, target, 3).memx.named_parameters())
    got = dict(memcom.init_memx(pcfg, 3, device="cpu").named_parameters())
    assert list(got) == list(want) and len(got) > 0
    for name, t in got.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name


def test_phase1_grads_only_on_trainables(rng):
    """Phase 1: the two LLM stacks form no weight gradient at all, memx and
    mem_tokens a non-zero one; the compressor's source pass records
    nothing for the backward."""
    _, _, _, pcfg, pmc, ptgt = _setup("smollm-135m")
    trained = memcom.set_trainable(pmc, 1)
    loss, _ = memcom.memcom_loss(pmc, ptgt, pcfg,
                                 _torch_batch(_batch(pcfg, rng)))
    loss.backward()
    for name, p in pmc.named_parameters():
        if name in trained:
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        else:
            assert p.grad is None, name
    assert all(p.grad is None for p in ptgt.parameters())
    with torch.enable_grad():
        _, aux = pmc.source(tokens=torch.from_numpy(_batch(pcfg, rng)[
            "source"]), capture_hiddens=True, logits=False)
    assert all(h.grad_fn is None for h in aux["hiddens"])


def test_compress_records_no_graph(rng):
    _, _, _, pcfg, pmc, _ = _setup("gemma2-2b")
    memcom.set_trainable(pmc, 2)
    with torch.enable_grad():
        prefix, _ = memcom.compress(pmc, pcfg, _batch(pcfg, rng)["source"])
    assert all(e["h"].grad_fn is None and not e["h"].requires_grad
               for e in prefix)


def test_memcom_loss_decreases():
    """A few Phase-1 steps through the port's step builder on one batch
    reduce the loss (the reference's learnability check)."""
    rng = np.random.default_rng(0)
    _, _, _, pcfg, pmc, ptgt = _setup("smollm-135m")
    step, opt, params = port_steps.build_memcom_train_step(
        pcfg, pmc, ptgt, phase=1, remat=False,
        lr=lambda _: torch.tensor(3e-3))
    state = opt.init(params)
    batch = _torch_batch(_batch(pcfg, rng, T=32, S=16))
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def test_frozen_target_and_stacks_unchanged_by_training(rng):
    _, _, _, pcfg, pmc, ptgt = _setup("smollm-135m")
    before = {n: p.detach().clone() for n, p in pmc.named_parameters()}
    tgt_before = {n: p.detach().clone() for n, p in ptgt.named_parameters()}
    step, opt, params = port_steps.build_memcom_train_step(
        pcfg, pmc, ptgt, phase=1, remat=True)
    state = opt.init(params)
    step(params, state, _torch_batch(_batch(pcfg, rng)))
    for n, p in ptgt.named_parameters():
        assert torch.equal(p, tgt_before[n]), n
    for n, p in pmc.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == (n in params), n


def test_remat_gives_the_same_loss_and_grads(rng):
    _, _, _, pcfg, pmc, ptgt = _setup("gemma2-2b")
    trained = memcom.set_trainable(pmc, 2)
    batch = _torch_batch(_batch(pcfg, rng))
    out = []
    for remat in (False, True):
        loss, _ = memcom.memcom_loss(pmc, ptgt, pcfg, batch, remat=remat)
        out.append((loss, torch.autograd.grad(
            loss, list(trained.values()), allow_unused=True,
            materialize_grads=True)))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chunk", [16, 7])
def test_chunked_compress_matches_one_shot_and_jax(rng, chunk):
    """compress in slices (the Source-LLM cache carried across them) ==
    one-shot compress, and == the JAX package's compress_chunked."""
    cfg, _, mc, pcfg, pmc, _ = _setup("smollm-135m")
    src = rng.integers(4, cfg.vocab_size, (2, 48)).astype(np.int32)
    one, _ = memcom.compress(pmc, pcfg, src)
    chk, _ = memcom.compress_chunked(pmc, pcfg, src, chunk_size=chunk)
    jchk, _ = jmc.compress_chunked(mc, cfg, jnp.asarray(src),
                                   chunk_size=chunk)
    jlist = bridge.layerwise_to_list(cfg, jchk)
    for a, b, c in zip(one, chk, jlist):
        np.testing.assert_allclose(b["h"].numpy(), a["h"].numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(b["h"].numpy(), np.asarray(c["h"]),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Optimizer and transforms on equal gradients
# ---------------------------------------------------------------------------


def _tree(rng):
    shapes = {"a": (4, 8), "b": (7,), "c": (3, 5)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}


def _close_dict(got, want, tol=OPT_TOL):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n], np.float32),
                                   np.asarray(want[n], np.float32),
                                   rtol=tol, atol=tol, err_msg=n)


@pytest.mark.parametrize("sched", ["cosine", "constant"])
def test_schedules_match_jax(sched):
    if sched == "cosine":
        jf, pf = jwcos(2e-4, 5, 40), warmup_cosine(2e-4, 5, 40)
    else:
        jf, pf = jwconst(1e-3, 7), warmup_constant(1e-3, 7)
    for s in range(0, 50, 3):
        got = float(pf(torch.tensor(s, dtype=torch.int32)))
        want = float(jf(jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= 1e-7 * max(1.0, abs(want)), (s, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_on_equal_grads(rng, dtype):
    """Five steps with weight decay, both fed the same numpy gradients;
    bf16 parameters keep float32 masters.  JAX's optimizer is given every
    leaf and a mask; the port's is given only the leaves the mask trains
    (as ``set_trainable`` hands it), and those are compared, while the
    leaf JAX leaves frozen must not move there."""
    p0 = _tree(rng)
    mask = {"a": True, "b": False, "c": True}
    trained = [n for n, m in mask.items() if m]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jopt = JAdamW(lr=jwcos(1e-2, 2, 10), weight_decay=0.1, mask=mask)
    popt = AdamW(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1)
    jp = {n: jnp.asarray(x, jd) for n, x in p0.items()}
    pp = {n: torch.from_numpy(p0[n]).to(td) for n in trained}
    js, ps = jopt.init(jp), popt.init(pp)
    assert set(ps["mu"]) == set(trained) and set(ps["master"]) == (
        set(trained) if dtype == "bfloat16" else set())
    for _ in range(5):
        g = _tree(rng)
        jp, js = jopt.step(jp, {n: jnp.asarray(x, jd) for n, x in g.items()},
                           js)
        ps = popt.step(pp, {n: torch.from_numpy(g[n]).to(td)
                            for n in trained}, ps)
    assert int(ps["count"]) == int(js["count"]) == 5
    assert np.array_equal(np.asarray(jp["b"], np.float32),
                          np.asarray(jnp.asarray(p0["b"], jd), np.float32))
    _close_dict({n: p.float().numpy() for n, p in pp.items()},
                {n: np.asarray(jp[n], np.float32) for n in trained},
                OPT_TOL if dtype == "float32" else 2 ** -8)
    for key in ("mu", "nu", "master"):
        _close_dict({n: t.numpy() for n, t in ps[key].items()},
                    dict(js[key]))


def test_clip_and_bf16_transforms_match_jax(rng):
    g = {n: x * 10 for n, x in _tree(rng).items()}
    jc, jn = jclip({n: jnp.asarray(x) for n, x in g.items()}, 1.0)
    pc, pn = clip_by_global_norm({n: torch.from_numpy(x)
                                  for n, x in g.items()}, 1.0)
    assert abs(float(pn) - float(jn)) <= OPT_TOL * float(jn)
    _close_dict({n: t.numpy() for n, t in pc.items()}, dict(jc))
    _close_dict({n: t.numpy() for n, t in compress_grads_bf16(
        {n: torch.from_numpy(x) for n, x in g.items()}).items()},
        dict(jbf16({n: jnp.asarray(x) for n, x in g.items()})), 0.0)


def test_error_feedback_int8_matches_jax(rng):
    jef, pef = JEF(), ErrorFeedbackInt8()
    g0 = _tree(rng)
    je = jef.init({n: jnp.asarray(x) for n, x in g0.items()})
    pe = pef.init({n: torch.from_numpy(x) for n, x in g0.items()})
    for _ in range(3):
        g = _tree(rng)
        (jq, js), je = jef.compress({n: jnp.asarray(x) for n, x in g.items()},
                                    je)
        (pq, pscale), pe = pef.compress({n: torch.from_numpy(x)
                                         for n, x in g.items()}, pe)
        for n in g:
            assert np.array_equal(pq[n].numpy(), np.asarray(jq[n]))
        _close_dict({n: t.numpy() for n, t in pe.items()}, dict(je))
        _close_dict({n: t.numpy() for n, t in pef.decompress(
            (pq, pscale)).items()}, dict(jef.decompress((jq, js))))


@pytest.mark.parametrize("accum,grad_bf16", [(1, False), (2, False),
                                             (1, True), (2, True)])
def test_train_step_accum_and_grad_bf16_match_jax(rng, accum, grad_bf16):
    """A quadratic loss whose gradient the two frameworks form exactly
    alike (g = W x summed), through both train-step builders."""
    w0 = _tree(rng)
    x = rng.standard_normal((4, 8)).astype(np.float32)

    def jloss(p, batch):
        return jnp.sum((batch["x"] @ p["a"].T) ** 2) + jnp.sum(p["c"] ** 2), {}

    def ploss(p, batch):
        return (torch.sum((batch["x"] @ p["a"].T) ** 2)
                + torch.sum(p["c"] ** 2)), {}

    jopt = JAdamW(lr=1e-2, mask={"a": True, "b": False, "c": True})
    popt = AdamW(lr=1e-2)
    jstep = jbuild(jloss, jopt, clip=0.5, accum=accum, grad_bf16=grad_bf16)
    pstep = build_train_step(ploss, popt, clip=0.5, accum=accum,
                             grad_bf16=grad_bf16)
    jp = {n: jnp.asarray(v) for n, v in w0.items()}
    pp = {n: torch.from_numpy(v.copy()).requires_grad_(n != "b")
          for n, v in w0.items()}
    js, ps = jopt.init(jp), popt.init({n: pp[n] for n in ("a", "c")})
    for _ in range(3):
        jp, js, jm = jstep(jp, js, {"x": jnp.asarray(x)})
        pp2 = {n: pp[n] for n in ("a", "c")}
        pp2, ps, pm = pstep(pp2, ps, {"x": torch.from_numpy(x)})
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"]))
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    _close_dict({n: pp[n].detach().numpy() for n in ("a", "c")},
                {n: np.asarray(jp[n]) for n in ("a", "c")}, 1e-5)


def test_lm_train_step_builder_runs_and_learns():
    pcfg = port_smoke_config("smollm-135m")
    from repro_torch.models import transformer as tfm
    model = tfm.init_params(pcfg, 0, device="cpu")
    step, opt, params = port_steps.build_lm_train_step(
        pcfg, model, remat=False, lr=lambda _: torch.tensor(3e-3))
    state = opt.init(params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, pcfg.vocab_size, (2, 16)).astype(np.int64))
    losses = [float(step(params, state, {"tokens": toks})[2]["loss"])
              for _ in range(5)]
    assert losses[-1] < losses[0], losses


def test_mamba2_lm_loss_and_grads_match_jax(rng):
    """mamba2-370m (smoke), attention-free: the loss of the port's
    ``build_lm_train_step`` (next-token CE + MoE aux) and its gradients
    against the JAX package's ``build_lm_train_step`` (its step's loss and
    grad norm; the gradients by ``jax.grad`` of the same loss), every
    parameter trained."""
    from repro.launch import steps as jsteps
    from repro_torch.models import transformer as tfm
    arch = "mamba2-370m"
    cfg = get_smoke_config(arch)
    params = jtfm.init_params(cfg, 0)
    pcfg = port_smoke_config(arch)
    model = bridge.from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)

    def jloss(p):
        logits, aux = jtfm.forward(p, cfg, tokens=jnp.asarray(toks))
        return jmc.next_token_loss(logits, jnp.asarray(toks)) \
            + aux["moe_loss"]

    jl, jg = jax.value_and_grad(jloss)(params)
    jstep, jopt = jsteps.build_lm_train_step(cfg, remat=False)
    _, _, jm = jstep(params, jopt.init(params), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(jm["loss"]), float(jl), rtol=1e-6)

    step, opt, pparams = port_steps.build_lm_train_step(pcfg, model,
                                                        remat=False)
    assert all(p.requires_grad for p in pparams.values())
    ttoks = torch.from_numpy(toks.astype(np.int64))
    logits, aux = model(tokens=ttoks)
    ploss = memcom.next_token_loss(logits, ttoks) + aux["moe_loss"]
    pg = torch.autograd.grad(ploss, list(pparams.values()),
                             allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(ploss.detach()), float(jl), rtol=TOL,
                               atol=TOL)
    want = dict(tree_flatten_with_names(jg))
    per = {}
    for n, g in zip(pparams, pg):
        per.setdefault(bridge.jax_path(pcfg, "transformer", n), []).append(
            g.detach().numpy())
    assert set(per) == set(want)
    for path, lst in per.items():
        w = np.asarray(want[path])
        got = np.stack(lst) if w.ndim == lst[0].ndim + 1 else lst[0]
        big = float(np.abs(w).max())
        np.testing.assert_allclose(got, w, rtol=0, atol=TOL * max(big, 1e-3),
                                   err_msg=path)
    _, _, pm = step(pparams, opt.init(pparams), {"tokens": ttoks})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=TOL)


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    last = port_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                            "3", "--batch", "2", "--seq", "32", "--ckpt",
                            str(tmp_path), "--ckpt-every", "2",
                            "--device", "cpu"])
    assert last["step"] == 3 and np.isfinite(last["loss"])
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003"]
    resumed = port_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                               "4", "--batch", "2", "--seq", "32", "--ckpt",
                               str(tmp_path), "--device", "cpu"])
    assert resumed["step"] == 4
    assert "resumed from step 3" in capsys.readouterr().out
