"""Rank functions of the port's sharded-training and pipeline tests
(``tests/test_torch_train_sharded.py``, ``tests/test_torch_pipeline.py``).

They run in ranks that :func:`repro_torch.launch.mesh.run_ranks` spawns,
so they live in a module of their own that imports neither ``jax`` nor
``repro``.  Each takes the JAX parameters and batches as numpy trees,
runs the port's Phase-1 step on a gloo mesh of CPU ranks and returns, on
the mesh's rank 0, host values (whole tensors gathered from the slices)
that the test holds to the JAX one-device step.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.data import host_slice
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.steps import act_sharding_for, build_memcom_train_step
from repro_torch.models import transformer as tfm
from repro_torch.sharding import ctx
from repro_torch.sharding.pipeline import (pipeline_apply, stage_scan,
                                           stage_slice)
from repro_torch.sharding.rules import FSDP_RULES, axis_sizes
from repro_torch.sharding.serving import shard_module


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the test reads the type and the message
        return f"{type(e).__name__}: {e}"
    return None


def _placed(cfg, spec, mesh):
    """The JAX target and compressor, carried across and placed on
    ``mesh`` by ``FSDP_RULES``."""
    target = bridge.from_jax_params(cfg, spec["params"], device="cpu")
    mc = bridge.from_jax_memcom(cfg, spec["mc"], device="cpu")
    shard_module(target, mesh, FSDP_RULES)
    shard_module(mc, mesh, FSDP_RULES)
    return mc, target


def phase1_steps(cfg, spec, mesh):
    """Two Phase-1 steps at the constant rate ``spec["lr"]`` on
    ``spec["batches"]`` (each the global batch; the rank reads its data
    shard): each step's loss, gradient norm and reduced gradients (whole,
    from ``step.grads`` before the step), the trained tensors and AdamW's
    ``mu``, ``nu`` and ``count`` after both steps, and the local shapes.
    Rank 0 of the mesh returns them, the other ranks None."""
    mc, target = _placed(cfg, spec, mesh)
    b0 = spec["batches"][0]
    B, T = b0["source"].shape
    step, opt, params = build_memcom_train_step(
        cfg, mc, target, phase=1, remat=False, mesh=mesh,
        act=act_sharding_for(mesh, cfg, B, T), lr=spec["lr"])
    pl = step.placement
    rows = host_slice(B, mesh.get_local_rank("data"),
                      axis_sizes(mesh)["data"])
    state = opt.init(params)
    out = {"loss": [], "grad_norm": [], "grads": [],
           "local": {n: tuple(p.shape) for n, p in params.items()}}
    for b in spec["batches"]:
        tb = {k: torch.as_tensor(v[rows]) for k, v in b.items()}
        _, _, grads = step.grads(params, tb)
        out["grads"].append({n: pl.whole(g, n) for n, g in grads.items()})
        params, state, m = step(params, state, tb)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = {n: pl.whole(p, n) for n, p in params.items()}
    for kind in ("mu", "nu"):
        out[kind] = {n: pl.whole(t, n) for n, t in state[kind].items()}
    out["count"] = int(state["count"])
    if not pl.lead:
        return None
    out["grads"] = [{n: g.numpy() for n, g in gs.items()}
                    for gs in out["grads"]]
    for kind in ("params", "mu", "nu"):
        out[kind] = {n: p.numpy() for n, p in out[kind].items()}
    return out


def _seeded_run(mesh, root, steps, restore=None):
    """``launch.train.build`` on gemma2-2b-smoke at the synthetic
    vocabulary (batch 4, seq 32), checkpointing every step into ``root``:
    the losses it ran, and its trained tensors and AdamW state (``mu``,
    ``nu``, ``count``) whole after restoring (when ``restore`` names a
    step) and after the run, on rank 0."""
    cfg = get_smoke_config("gemma2-2b").replace(vocab_size=388)
    run = launch_train.build(cfg, batch=4, seq=32, steps=steps, ckpt=root,
                             ckpt_every=1, log_every=1, device="cpu",
                             mesh=mesh)
    pl = run.step.placement

    def whole(tree):
        return {n: (pl.whole(t, n) if pl is not None else t.detach().clone())
                for n, t in tree.items()}

    def state():
        opt = run.trainer.opt_state
        return {"params": whole(run.params), "mu": whole(opt["mu"]),
                "nu": whole(opt["nu"]), "count": int(opt["count"])}

    res = {}
    with ctx.act_sharding(run.act):
        if restore is not None:
            assert run.trainer.restore_if_available(restore) == restore
            res["restored"] = state()
        run.trainer.run()
    res["losses"] = dict(run.trainer.losses)
    res["final"] = state()
    if pl is not None and not pl.lead:
        return None
    for key in ("restored", "final"):
        if key in res:
            res[key] = {k: ({n: t.numpy() for n, t in v.items()}
                            if isinstance(v, dict) else v)
                        for k, v in res[key].items()}
    return res


def seeded_restore(mesh, root, step):
    return _seeded_run(mesh, root, 2, restore=step)


def _preempted(mesh, root):
    """A seeded run whose PREEMPTED flag rank 0 alone can see (rank 0
    drops it before the run): every rank must stop at step 0 with rank
    0's decision and the checkpoint of step 0 written once."""
    import os

    import torch.distributed as dist

    cfg = get_smoke_config("gemma2-2b").replace(vocab_size=388)
    run = launch_train.build(cfg, batch=4, seq=32, steps=2,
                             ckpt=os.path.join(root, f"rank{dist.get_rank()}"),
                             log_every=1, device="cpu", mesh=mesh)
    if dist.get_rank() == 0:
        run.trainer.mgr.flag_preemption()
    with ctx.act_sharding(run.act):
        last = run.trainer.run()
    return {"last": last, "steps_run": sorted(run.trainer.losses),
            "saved": run.trainer.mgr.available_steps()}


def two_ranks(rank, world, spec):
    """2x1 and 1x2 against JAX (gemma2-2b-smoke), granite-moe-smoke at 2x1,
    a checkpoint of the 2x2 run restored at 2x1, and what raises."""
    torch.set_num_threads(1)
    cfg = get_smoke_config("gemma2-2b")
    res = {}
    m21 = make_serving_mesh(model=1, data=2, device="cpu")
    m12 = make_serving_mesh(model=2, data=1, device="cpu")
    res["2x1"] = phase1_steps(cfg, spec["gemma"], m21)
    res["1x2"] = phase1_steps(cfg, spec["gemma"], m12)
    granite = get_smoke_config("granite-moe-3b-a800m")
    res["granite_2x1"] = phase1_steps(granite, spec["granite"], m21)
    res["restore_2x1"] = seeded_restore(m21, spec["ckpt_2x1"], 1)
    res["preempted"] = _preempted(m21, spec["ckpt_pre"])
    res["unported"] = {
        arch: _raises(lambda a=arch: tfm.init_params(
            get_smoke_config(a), 0, device="cpu", mesh=m12))
        for arch in ("granite-moe-3b-a800m", "mamba2-370m",
                     "deepseek-v2-236b", "jamba-1.5-large-398b",
                     "whisper-medium")}
    mc, target = _placed(granite, spec["granite"], m21)
    with ctx.act_sharding(act_sharding_for(m21, granite, 4, 8)), \
            ctx.moe_plan_disabled():
        res["moe_without_plan"] = _raises(lambda: target(
            tokens=torch.zeros((2, 8), dtype=torch.long)))
    return res if rank == 0 else {"preempted": res["preempted"]}


def four_ranks(rank, world, spec):
    """2x2 against JAX, and the seeded 2x2 run whose checkpoints the other
    meshes restore."""
    torch.set_num_threads(1)
    cfg = get_smoke_config("gemma2-2b")
    mesh = make_serving_mesh(model=2, data=2, device="cpu")
    res = {"2x2": phase1_steps(cfg, spec["gemma"], mesh),
           "seeded_2x2": _seeded_run(mesh, spec["ckpt"], 2)}
    return res if rank == 0 else None


def pipeline(rank, world, spec):
    """``pipeline_apply`` over a ("pod",) mesh of ``world`` stages: the
    output and this stage's gradients of sum(y ** 2) (whole-stack leaves,
    zero outside the stage's layers), and the stage index."""
    torch.set_num_threads(1)
    device = torch.device(spec.get("device", "cpu"))
    mesh = DeviceMesh(device.type, torch.arange(world),
                      mesh_dim_names=("pod",))
    params = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in spec["params"].items()}
    h0 = torch.tensor(spec["h0"], device=device)
    stage_fn = stage_scan(lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]))
    y = pipeline_apply(stage_fn, stage_slice(params, mesh), h0, mesh=mesh,
                       axis="pod", microbatches=spec["microbatches"])
    grads = torch.autograd.grad((y ** 2).sum(), list(params.values()))
    return {"y": y.detach().cpu().numpy(), "stage": mesh.get_local_rank("pod"),
            "grads": {k: g.cpu().numpy() for k, g in zip(params, grads)}}

