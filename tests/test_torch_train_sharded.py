"""The port's sharded MemCom training against the JAX one-device step.

Training's sharding is placement in the JAX package (GSPMD keeps the
step's mathematics), so the JAX step on one device is the reference for
every mesh.  The port runs one process per rank: these tests spawn 2 and
4 ``gloo`` ranks on the CPU (each spawn with a timeout) and hold two
Phase-1 steps of gemma2-2b-smoke (float32, 4/2 heads, d_model 96) at the
meshes 1x1, 2x1, 1x2 and 2x2 under ``FSDP_RULES`` to the JAX step on the
same numpy inputs: each step's loss and gradient norm, every trained
gradient (whole, gathered from the ranks' slices), and AdamW's ``mu``,
``nu`` and ``count`` and the trained tensors after both steps, within
1e-4 of the largest.  The steps run at a constant rate of 1e-4, which
moves each trained tensor by 2 to 50 times the rule (the launcher's
schedule, 4e-7 in the first step, moves none by as much as the rule), so
a sharded AdamW that skipped its update, or applied it to another slice,
fails.  The trained tensors are held where the reference gradient is at
least 1e-3 of its largest in both steps (98% of the entries): below it
the update is Adam's eps and normalisation acting on gradient
differences, not the gradient.  The second batch's rows
count different numbers of mask positions, so the mean of the data
ranks' means would be wrong.  granite-moe-3b-a800m-smoke at 2x1 is held
to the JAX step with ``dispatch_groups=2`` (the JAX MoE's grouping under
the same placement).  A checkpoint written on 2x2 restores on 1x1 and on
2x1, a PREEMPTED flag that only rank 0 sees stops every rank, and
``launch/train.py`` at ``--data 2`` gives ``build(...)``'s losses (at 1x1
bit for bit).

The rank functions live in ``tests/torch_train_ranks.py``, which imports
no JAX.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks
from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import AdamW as JAdamW
from repro.utils.pytree import tree_flatten_with_names
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import (make_serving_mesh, one_rank_group,
                                     run_ranks)

torch.set_num_threads(1)
SPAWN_S = 150  # each spawn's time limit, its collectives' too
TOL = 1e-4
LR = 1e-4  # both steps' rate: each moves a trained entry by about LR
NOISE = 1e-3  # a gradient entry below NOISE of its largest: Adam's eps rules
B, T, S = 4, 24, 12


def _batches(cfg, rng):
    """Two global batches; in the second, rows 0-1 (data rank 0 at data 2)
    count every target position and rows 2-3 two of them."""
    out = []
    for uneven in (False, True):
        b = {"source": rng.integers(0, cfg.vocab_size, (B, T)),
             "target": rng.integers(0, cfg.vocab_size, (B, S)),
             "target_mask": (rng.random((B, S)) > 0.2)}
        if uneven:
            b["target_mask"][:2] = True
            b["target_mask"][2:] = False
            b["target_mask"][2:, 3:5] = True
        out.append({"source": b["source"].astype(np.int32),
                    "target": b["target"].astype(np.int32),
                    "target_mask": b["target_mask"].astype(np.float32)})
    return out


def _jax_reference(cfg, batches):
    """The JAX one-device Phase-1 step, two steps: losses, gradient norms,
    each step's gradients (before the step) and the trained leaves after
    both, by JAX path."""
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    spec = {"params": jax.tree.map(np.asarray, params),
            "mc": jax.tree.map(np.asarray, mc), "batches": batches, "lr": LR}
    sched = jsteps.warmup_cosine
    jsteps.warmup_cosine = lambda *a, **k: (lambda _: jnp.float32(LR))
    try:  # the JAX step itself, at the constant rate
        step, _ = jsteps.build_memcom_train_step(cfg, phase=1, remat=False)
    finally:
        jsteps.warmup_cosine = sched
    mask = jmc.trainable_mask(mc, 1)
    opt_state = JAdamW(lr=0.0, mask=mask).init(mc)

    def loss_fn(mc_, batch):
        mc_ = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x),
                           mc_, mask)
        return jmc.memcom_loss(mc_, params, cfg, batch, remat=False)[0]

    @jax.jit
    def grads_and_step(mc, opt_state, batch):
        return (jax.grad(loss_fn)(mc, batch),
                step(mc, opt_state, params, batch))

    want = {"loss": [], "grad_norm": [], "grads": []}
    trained = {p for p, m in tree_flatten_with_names(mask) if m}
    for b in batches:
        g, (mc, opt_state, m) = grads_and_step(
            mc, opt_state, jax.tree.map(jnp.asarray, b))
        g = dict(tree_flatten_with_names(g))
        want["grads"].append({p: np.asarray(g[p]) for p in trained})
        want["loss"].append(float(m["loss"]))
        want["grad_norm"].append(float(m["grad_norm"]))
    flat = dict(tree_flatten_with_names(mc))
    want["params"] = {p: np.asarray(flat[p]) for p in trained}
    for kind in ("mu", "nu"):
        want[kind] = {p: np.asarray(opt_state[kind][p]) for p in trained}
    want["count"] = int(opt_state["count"])
    return spec, want


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    out = {}
    for name, arch, groups in (("gemma", "gemma2-2b", 0),
                               ("granite", "granite-moe-3b-a800m", 2)):
        cfg = get_smoke_config(arch)
        if groups:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, dispatch_groups=groups))
        spec, want = _jax_reference(cfg, _batches(cfg, rng))
        out[name] = dict(spec=spec, want=want,
                         pcfg=port_smoke_config(arch))
    root = tmp_path_factory.mktemp("ckpt")
    out["ckpt"] = {k: str(root / k) for k in ("2x2", "1x1", "2x1", "pre")}
    return out


@pytest.fixture(scope="module")
def four(ref):
    spec = {"gemma": ref["gemma"]["spec"], "ckpt": ref["ckpt"]["2x2"]}
    (res, *_) = run_ranks(ranks.four_ranks, 4, (spec,), timeout=SPAWN_S)
    for k in ("1x1", "2x1"):  # each restoring mesh continues in a copy
        shutil.copytree(ref["ckpt"]["2x2"], ref["ckpt"][k])
    return res


@pytest.fixture(scope="module")
def two(ref, four):
    spec = {"gemma": ref["gemma"]["spec"],
            "granite": ref["granite"]["spec"],
            "ckpt_2x1": ref["ckpt"]["2x1"], "ckpt_pre": ref["ckpt"]["pre"]}
    res, other = run_ranks(ranks.two_ranks, 2, (spec,), timeout=SPAWN_S)
    res["other_rank"] = other
    return res


@pytest.fixture(scope="module")
def one(ref):
    with one_rank_group():
        mesh = make_serving_mesh(device="cpu")
        return ranks.phase1_steps(port_smoke_config("gemma2-2b"),
                                  ref["gemma"]["spec"], mesh)


def _stacked(pcfg, named, want):
    """Port tensors by JAX path, a path's layers stacked in port order as
    the JAX tree stacks them (where ``want``'s leaf has the extra axis)."""
    per = {}
    for n, g in named.items():
        per.setdefault(bridge.jax_path(pcfg, "memcom", n), []).append(g)
    return {path: (np.stack(parts) if path in want
                   and want[path].ndim == parts[0].ndim + 1 else parts[0])
            for path, parts in per.items()}


def _close_tree(pcfg, got, want, what, keep=None):
    """Each tensor within 1e-4 of its largest magnitude; with ``keep``
    (by path), only the entries it marks."""
    per = _stacked(pcfg, got, want)
    assert set(per) == set(want), what
    for path, g in per.items():
        w = want[path]
        big = float(np.abs(w).max())
        assert big > 0, (what, path)
        if keep is not None:
            g, w = g[keep[path]], w[keep[path]]
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * big,
                                   err_msg=f"{what} {path}")


def _set_by_gradient(want):
    """Per trained tensor, the entries whose update the gradient sets:
    the reference gradient at least NOISE of its largest in both steps.
    Below that, Adam's eps and normalisation turn the port's and JAX's
    gradient differences into a different step (one entry of wo moves
    8e-6 apart at lr 1e-4, twice the rule)."""
    out = {}
    for path in want["params"]:
        gs = [np.abs(step[path]) for step in want["grads"]]
        out[path] = np.logical_and.reduce(
            [g >= NOISE * g.max() for g in gs])
    return out


def _check(got, ref, name="gemma"):
    want, pcfg = ref[name]["want"], ref[name]["pcfg"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=0,
                                   err_msg=key)
    for i in range(2):
        _close_tree(pcfg, got["grads"][i], want["grads"][i], f"grads {i}")
    for kind in ("mu", "nu"):
        _close_tree(pcfg, got[kind], want[kind], kind)
    assert got["count"] == want["count"] == 2
    _close_tree(pcfg, got["params"], want["params"], "params",
                keep=_set_by_gradient(want))


def test_one_by_one_mesh_matches_jax(ref, one):
    _check(one, ref)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_two_rank_meshes_match_jax(ref, two, mesh):
    _check(two[mesh], ref)


def test_two_by_two_mesh_matches_jax(ref, four):
    _check(four["2x2"], ref)


def test_ranks_hold_slices(ref, two, four):
    """FSDP halves every trained tensor's d_model over data 2; memx
    replicates over "model" (its single head does not split)."""
    d = ref["gemma"]["pcfg"].d_model
    for got, n_data in ((two["2x1"], 2), (two["1x2"], 1), (four["2x2"], 2)):
        assert got["local"]["memx.0.wq"] == (d // n_data, d)
        assert got["local"]["mem_tokens"][1] == d // n_data


def test_the_uneven_batch_weighs_positions_not_ranks(ref):
    """The second batch's data ranks count 22 and 4 target positions: the
    mean of their means is another loss than the global mean."""
    m = ref["gemma"]["spec"]["batches"][1]["target_mask"][:, 1:]
    counts = m[:2].sum(), m[2:].sum()
    assert counts[0] != counts[1]


def test_granite_moe_at_data_2_matches_jax_dispatch_groups_2(ref, two):
    _check(two["granite_2x1"], ref, "granite")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-370m",
                                  "deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_unported_families_raise_under_a_model_axis(two, arch):
    msg = two["unported"][arch]
    assert msg is not None and msg.startswith("NotImplementedError")
    assert "ROADMAP Queue 1 step 5.2" in msg


def test_moe_without_the_plan_raises_across_data_ranks(two):
    msg = two["moe_without_plan"]
    assert msg.startswith("NotImplementedError") and "5.2" in msg


def test_rank_0s_preemption_flag_stops_every_rank(two):
    """Rank 0 alone sees the PREEMPTED flag (each rank checkpoints into
    its own directory here): both ranks stop before step 1, rank 0's
    decision broadcast, and only rank 0 writes the checkpoint."""
    for got in (two["preempted"], two["other_rank"]["preempted"]):
        assert got["last"] == {"preempted_at": 0}
        assert got["steps_run"] == []
    assert two["preempted"]["saved"] == [0]
    assert two["other_rank"]["preempted"]["saved"] == []


def _close_dict(got, want, tol=1e-5):
    assert set(got) == set(want)
    for n in want:
        big = max(float(np.abs(want[n]).max()), 1e-30)
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=tol * big,
                                   err_msg=n)


def _restored_as_saved(got, root):
    """The restored trained tensors and AdamW state, whole, bit for bit
    those of the 2x2 run's step-1 checkpoint."""
    from repro_torch.checkpoint import CheckpointManager

    like = {"params": got["params"],
            "opt": {"mu": got["mu"], "nu": got["nu"], "master": {},
                    "count": np.zeros((), np.int32)}}
    saved, _ = CheckpointManager(root).restore(1, like)
    assert got["count"] == int(saved["opt"]["count"]) == 1
    for kind, tree in (("params", saved["params"]),
                       ("mu", saved["opt"]["mu"]), ("nu", saved["opt"]["nu"])):
        for n, t in got[kind].items():
            assert np.array_equal(t, np.asarray(tree[n])), (kind, n)


def _second_step_as_2x2(got, seeded):
    """Step 2 after the restore against the 2x2 run's own: the loss, and
    AdamW's ``mu`` and ``nu`` (linear and quadratic in the gradients, so
    a state that was not restored shows at any rate) and the trained
    tensors within 1e-5 of the largest."""
    assert set(got["losses"]) == {2}
    np.testing.assert_allclose(got["losses"][2], seeded["losses"][2],
                               rtol=1e-5)
    assert got["final"]["count"] == seeded["final"]["count"] == 2
    for kind in ("mu", "nu", "params"):
        _close_dict(got["final"][kind], seeded["final"][kind])


def test_checkpoint_of_2x2_restores_on_2x1(ref, four, two):
    _restored_as_saved(two["restore_2x1"]["restored"], ref["ckpt"]["2x2"])
    _second_step_as_2x2(two["restore_2x1"], four["seeded_2x2"])


def test_checkpoint_of_2x2_restores_on_1x1(ref, four):
    """The 2x2 run's step-1 checkpoint, read by a 1x1 mesh: the whole
    tensors and AdamW state bit for bit, then its second step."""
    with one_rank_group():
        mesh = make_serving_mesh(device="cpu")
        got = ranks.seeded_restore(mesh, ref["ckpt"]["1x1"], 1)
    _restored_as_saved(got["restored"], ref["ckpt"]["2x2"])
    _second_step_as_2x2(got, four["seeded_2x2"])


def test_launcher_data_2_matches_build(tmp_path):
    """``launch/train.py --data 2`` (two spawned ranks) gives the one-rank
    ``build(...)`` run's losses; ``--data 1`` (a 1x1 mesh) bit for bit."""
    cfg = port_smoke_config("gemma2-2b").replace(vocab_size=388)
    run = port_train.build(cfg, batch=4, seq=32, steps=2, ckpt=str(
        tmp_path / "plain"), log_every=1, device="cpu")
    want = run.trainer.run()
    argv = ["--arch", "gemma2-2b", "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "32", "--device", "cpu"]
    one = port_train.main(argv + ["--data", "1", "--ckpt",
                                  str(tmp_path / "one")])
    assert one["loss"] == want["loss"] and one["grad_norm"] == want[
        "grad_norm"]
    two = port_train.main(argv + ["--data", "2", "--ckpt",
                                  str(tmp_path / "two")])
    for k in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(two[k], want[k], rtol=1e-5, err_msg=k)
