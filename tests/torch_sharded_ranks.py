"""Rank functions of the port's tensor-parallel serving tests
(``tests/test_torch_serving_sharded.py``).

They run in ranks that :func:`repro_torch.launch.mesh.run_ranks` spawns,
so they live in a module of their own that imports neither ``jax`` nor
``repro``: a spawned child imports this module, not the test file.  Each
function takes the JAX parameters as numpy trees (carried across by
``repro_torch.bridge`` inside the rank), runs its scenarios on a gloo
mesh of CPU ranks and returns host values that the test holds to the JAX
one-device engine's.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import memcom
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer as tfm
from repro_torch.serving import (Request, ServingEngine, VirtualClock,
                                 materialize_prefix)
from repro_torch.sharding import FSDP_RULES
from repro_torch.sharding.serving import check_agreement

SLOTS = 2


def parity_config():
    """smollm-135m-smoke at d_model 128, 8/4 heads, d_ff 256, float32:
    the JAX package's sharded-serving test config."""
    return get_smoke_config("smollm-135m").replace(
        d_model=128, num_heads=8, num_kv_heads=4, d_ff=256)


def _target(cfg, tree):
    return bridge.from_jax_params(cfg, tree, device="cpu")


def _kv(rows):
    return [{k: torch.as_tensor(v) for k, v in e.items()} for e in rows]


def _serve(eng, reqs):
    out = eng.serve([Request(**r) for r in reqs])
    return [out[r["uid"]].tolist() for r in reqs]


def _offline_reqs(prompts, uid0=0):
    return [dict(tokens=p, max_new=4, prefix="task", uid=uid0 + i)
            for i, p in enumerate(prompts)]


def _online_reqs(prompts, raw, uid0=0):
    return [dict(tokens=p, max_new=3, raw_shots=raw, uid=uid0 + i)
            for i, p in enumerate(prompts)]


def _layout(layout):
    return dict(kv_layout="paged", block_size=4) if layout == "paged" else {}


def _shapes(eng):
    """This rank's local widths: the first layer's wq / MLP wo / cache k,
    the embedding rows and the mesh in stats()."""
    layer = eng.target.layers[0]
    return {"wq": tuple(layer.attn.wq.shape),
            "mlp_wo": tuple(layer.mlp.wo.shape),
            "cache_k": tuple(eng.cache[0]["k"].shape),
            "embed": tuple(eng.target.embed.tokens.shape),
            "mesh": eng.stats()["mesh"]}


def _placement_rule(arch, mesh, prompt_seed):
    """A smoke config whose heads do not divide the model axis: attention
    replicates (whole wq and cache), the rest splits, and the tokens are
    the unsplit engine's."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(prompt_seed)
    prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9)]
    reqs = [dict(tokens=p, max_new=4, uid=i) for i, p in enumerate(prompts)]
    out = {}
    for name, m in (("want", None), ("got", mesh)):
        target = tfm.init_params(cfg, 0, device="cpu")
        eng = ServingEngine(cfg, target, slots=SLOTS, max_len=32,
                            device="cpu", mesh=m)
        out[name] = _serve(eng, reqs)
        if m is not None:
            layer = target.layers[0]
            out["wq"] = tuple(layer.attn.wq.shape)
            out["whole_wq"] = (cfg.d_model, cfg.num_heads * cfg.hd)
            out["mlp_wo"] = tuple(layer.mlp.wo.shape)
            out["whole_ff"] = cfg.d_ff
            out["cache_k"] = tuple(eng.cache[0]["k"].shape)
            out["attn_tp"] = layer.attn.tp is not None
    return out


def _seated(eng, spec):
    eng.add_prefix("task", _kv(spec["jkv"]))
    return eng


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the test reads the type and the message
        return f"{type(e).__name__}: {e}"
    return None


def two_ranks(rank, world, spec):
    """Every 2-rank scenario of the test file in one group."""
    torch.set_num_threads(1)
    cfg = parity_config()
    mesh = make_serving_mesh(model=world, device="cpu")
    res = {}
    for layout in ("dense", "paged"):
        # offline, the prefix materialized through the whole JAX target:
        # add_prefix cuts it to the rank's heads
        eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                            max_len=64, device="cpu", mesh=mesh,
                            **_layout(layout))
        eng.add_prefix("task", _kv(spec["jkv"]))
        res[f"offline_{layout}"] = _serve(eng, _offline_reqs(spec["prompts"]))
        res[f"shapes_{layout}"] = _shapes(eng)
        # offline, materialized through this rank's split target
        target = _target(cfg, spec["params"])
        eng = ServingEngine(cfg, target, slots=SLOTS, max_len=64,
                            device="cpu", mesh=mesh, **_layout(layout))
        comp = bridge.from_jax_memcom(cfg, spec["mc"], device="cpu")
        prefix, _ = memcom.compress(comp, cfg, torch.as_tensor(
            spec["shots"][None]))
        kv = materialize_prefix(target, cfg, prefix)
        res[f"local_kv_heads_{layout}"] = int(kv[0]["k"].shape[-2])
        eng.add_prefix("task", kv)
        res[f"offline_local_{layout}"] = _serve(
            eng, _offline_reqs(spec["prompts"], 10))
        # online: the whole compressor, materialized through the split
        # target inside the engine's compiler
        eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                            max_len=96, device="cpu", mesh=mesh,
                            compressor=bridge.from_jax_memcom(
                                cfg, spec["mc"], device="cpu"),
                            compile_token_budget=16, **_layout(layout))
        res[f"online_{layout}"] = _serve(
            eng, _online_reqs(spec["prompts"], spec["raw"], 20))
    res["fused_spec"] = {
        name: _serve(_seated(ServingEngine(
            cfg, _target(cfg, spec["params"]), slots=SLOTS, max_len=64,
            device="cpu", mesh=m, fused_step=True, spec_draft="self",
            spec_k=2), spec), _offline_reqs(spec["prompts"], 30))
        for name, m in (("want", None), ("got", mesh))}
    res["tiers"] = _tiers(cfg, spec, mesh, rank)
    res["placement_smollm"] = _placement_rule("smollm-135m", mesh, 3)
    res["unported"] = {
        arch: _raises(lambda a=arch: ServingEngine(
            get_smoke_config(a), tfm.init_params(get_smoke_config(a), 0,
                                                 device="cpu"),
            slots=1, max_len=16, device="cpu", mesh=mesh))
        for arch in ("granite-moe-3b-a800m", "mamba2-370m",
                     "deepseek-v2-236b")}
    res["fsdp_2x1"] = _fsdp_2x1(cfg, spec)
    res["too_many_ranks"] = _raises(
        lambda: make_serving_mesh(model=4, device="cpu"))
    res["diverged"] = _raises(lambda: check_agreement(
        mesh.control_group, np.array([rank])))
    res["agreed"] = _raises(lambda: check_agreement(
        mesh.control_group, np.array([7, 8])))
    return res


def _fsdp_2x1(cfg, spec):
    """``FSDP_RULES`` at data 2: each rank holds half of every d_model
    (gathered for each call) and serves the same requests, dense and
    paged."""
    mesh = make_serving_mesh(model=1, data=2, device="cpu")
    res = {}
    for layout in ("dense", "paged"):
        target = _target(cfg, spec["params"])
        eng = ServingEngine(cfg, target, slots=SLOTS, max_len=64,
                            device="cpu", mesh=mesh, rules=FSDP_RULES,
                            **_layout(layout))
        eng.add_prefix("task", _kv(spec["jkv"]))
        res[layout] = _serve(eng, _offline_reqs(spec["prompts"]))
        res[f"wq_{layout}"] = tuple(
            target.layers[0].attn.wq.shape)
    return res


def _tiers(cfg, spec, mesh, rank):
    """Serve from HBM, demote, serve from the host tier, demote and spill,
    serve from disk (each rank its own directory), then a fresh compile."""
    m = cfg.memcom.num_memory_tokens
    eng = ServingEngine(
        cfg, _target(cfg, spec["params"]), slots=SLOTS, max_len=m + 24,
        device="cpu", mesh=mesh, clock=VirtualClock(),
        compressor=bridge.from_jax_memcom(cfg, spec["mc"], device="cpu"),
        compile_token_budget=16, host_capacity=4, disk_dir=spec["disk_dir"],
        promote_layer_budget=1)
    eng.add_prefix("t", _kv(spec["tier_kv"]))
    uid = iter(range(100, 200))
    prompt = spec["tier_prompt"]

    def one(prefix="t", raw=None):
        return _serve(eng, [dict(tokens=prompt, max_new=5, prefix=prefix,
                                 raw_shots=raw, uid=next(uid))])[0]

    def unseat():
        _serve(eng, [dict(tokens=prompt, max_new=1, uid=next(uid))])

    tokens = [one()]
    unseat()
    eng.store.demote("t")
    tokens.append(one())
    unseat()
    eng.store.demote("t")
    eng.store.spill("t")
    # the spilled shard, in this rank's own directory
    files = sorted(os.listdir(os.path.join(spec["disk_dir"],
                                           f"rank{dist.get_rank()}")))
    tokens.append(one())
    tokens.append(one(prefix=None, raw=spec["tier_raw"]))
    return {"tokens": tokens, "tiers": eng.stats()["prefix_tiers"],
            "files": files, "tier": eng.store.tier_of("t")}


def four_ranks(rank, world, spec):
    """The 4-rank scenarios: 1x4 dense and paged (baseline and fsdp rules),
    a 2x2 mesh (two replicas of a 2-way split), fsdp at 2x2 (d_model cut
    over data, heads over model), and qwen2-vl-2b-smoke's 4/2 heads
    replicating attention."""
    torch.set_num_threads(1)
    cfg = parity_config()
    res = {}
    mesh = make_serving_mesh(model=4, device="cpu")
    for layout in ("dense", "paged"):
        eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                            max_len=64, device="cpu", mesh=mesh,
                            **_layout(layout))
        eng.add_prefix("task", _kv(spec["jkv"]))
        res[f"offline_{layout}"] = _serve(eng, _offline_reqs(spec["prompts"]))
        res[f"shapes_{layout}"] = _shapes(eng)
    eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                        max_len=64, device="cpu", mesh=mesh,
                        rules=FSDP_RULES)
    eng.add_prefix("task", _kv(spec["jkv"]))
    res["fsdp_data1"] = _serve(eng, _offline_reqs(spec["prompts"]))
    res["placement_qwen"] = _placement_rule("qwen2-vl-2b", mesh, 4)
    mesh22 = make_serving_mesh(model=2, data=2, device="cpu")
    eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                        max_len=64, device="cpu", mesh=mesh22)
    eng.add_prefix("task", _kv(spec["jkv"]))
    res["mesh_2x2"] = _serve(eng, _offline_reqs(spec["prompts"]))
    res["shapes_2x2"] = _shapes(eng)
    eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                        max_len=64, device="cpu", mesh=mesh22,
                        rules=FSDP_RULES)
    eng.add_prefix("task", _kv(spec["jkv"]))
    res["fsdp_data2"] = _serve(eng, _offline_reqs(spec["prompts"]))
    res["fsdp_data2_wq"] = tuple(
        eng.target.layers[0].attn.wq.shape)
    return res


def one_rank(rank, world, spec):
    """A 1x1 mesh: the unsplit engine's tokens, stats()["mesh"], and a MoE
    config (which a model axis above 1 refuses) served unsplit."""
    torch.set_num_threads(1)
    cfg = parity_config()
    mesh = make_serving_mesh(model=1, device="cpu")
    res = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        eng = ServingEngine(cfg, _target(cfg, spec["params"]), slots=SLOTS,
                            max_len=64, device="cpu", mesh=m)
        eng.add_prefix("task", _kv(spec["jkv"]))
        res[name] = _serve(eng, _offline_reqs(spec["prompts"]))
        res[f"stats_{name}"] = eng.stats().get("mesh")
    moe = get_smoke_config("granite-moe-3b-a800m")
    rng = np.random.default_rng(5)
    reqs = [dict(tokens=rng.integers(4, moe.vocab_size, 6).astype(np.int32),
                 max_new=3, uid=0)]
    res["moe"] = {
        name: _serve(ServingEngine(moe, tfm.init_params(moe, 0, device="cpu"),
                                   slots=1, max_len=32, device="cpu",
                                   mesh=m), reqs)
        for name, m in (("plain", None), ("mesh", mesh))}
    return res


def hang(rank, world, _spec):
    """Rank 0 enters a collective that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        threading.Event().wait()
    return rank
