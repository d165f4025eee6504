"""Tensor-parallel serving of the port against the JAX one-device engine.

The JAX package holds its sharded engine to its one-device engine in a
subprocess with four forced host devices (``tests/test_serving_sharded.
py``).  The port runs one process per rank: these tests spawn 1, 2 and 4
``gloo`` ranks on the CPU (:func:`repro_torch.launch.mesh.run_ranks`,
each spawn with a timeout, so that a hung collective fails in seconds)
and hold their greedy tokens to the JAX engine's, on the JAX test's
config (smollm-135m-smoke at d_model 128, 8/4 heads of 16, d_ff 256,
float32), parameters carried across by ``repro_torch.bridge``:

* 2 and 4 ranks, dense and paged (block size 4), offline prefixes: one
  materialized by the whole JAX target (``add_prefix`` cuts it to the
  rank's heads) and one through the rank's split target;
* online-compiled prefixes (raw shots) at 2 ranks, dense and paged;
* the fused step with self-speculative decoding at 2 ranks, against the
  unsplit engine;
* the tiers at 2 ranks: HBM, host, disk (a directory a rank) and a fresh
  compile, with the JAX engine's tier counters (``promote_bytes`` counts
  the rank's half);
* the placement rule counted in heads: smollm-135m-smoke's 3/3 heads on 2
  ranks and qwen2-vl-2b-smoke's 4/2 on 4 replicate attention and give
  the unsplit engine's tokens;
* a 2x2 mesh (two replicas of a 2-way split), fsdp rules at data 1, at
  2x1 (dense and paged) and at 2x2 (d_model cut over the data ranks and
  gathered for each call), a 1x1 mesh, the launcher's ``--mesh 2`` and
  ``--mesh 2x1 --rules fsdp``;
* what raises: too many ranks, nccl past the cards, rules without a mesh,
  MoE / Mamba2 / MLA under a model axis above 1, diverged control planes,
  a hung collective.

The rank functions live in ``tests/torch_sharded_ranks.py``, which the
spawned children import (it imports no JAX).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks
from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import materialize_prefix as jmaterialize
from repro.serving.clock import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import (make_serving_mesh, one_rank_group,
                                     run_ranks)
from repro_torch.models import transformer as tfm
from repro_torch.serving import ServingEngine
from repro_torch.sharding import BASELINE_RULES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 120  # each spawn's time limit, its collectives' too
torch.set_num_threads(1)


def _jserve(eng, reqs):
    out = eng.serve([JRequest(**r) for r in reqs])
    return [np.asarray(out[r["uid"]]).tolist() for r in reqs]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX one-device engine's tokens, and the numpy spec the ranks
    rebuild the same models and prefixes from."""
    cfg = get_smoke_config("smollm-135m").replace(
        d_model=128, num_heads=8, num_kv_heads=4, d_ff=256)
    params = jtfm.init_params(cfg, 0)
    mc = jmc.init_memcom(cfg, params, 1)
    rng = np.random.default_rng(0)
    shots = rng.integers(4, cfg.vocab_size, 40).astype(np.int32)
    jkv = jmaterialize(params, cfg,
                       jmc.compress(mc, cfg, jnp.asarray(shots[None]))[0])
    prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9)]
    raw = rng.integers(4, cfg.vocab_size, 40).astype(np.int32)
    tmp = tmp_path_factory.mktemp("tiers")
    spec = dict(params=jax.tree.map(np.asarray, params),
                mc=jax.tree.map(np.asarray, mc),
                jkv=bridge.layerwise_to_list(cfg, jkv), shots=shots,
                prompts=prompts, raw=raw, tier_kv=bridge.layerwise_to_list(
                    cfg, jkv), tier_prompt=prompts[0], tier_raw=shots,
                disk_dir=str(tmp / "port"))
    want = {}
    for layout, kw in (("dense", {}),
                       ("paged", dict(kv_layout="paged", block_size=4))):
        eng = JaxEngine(cfg, params, slots=ranks.SLOTS, max_len=64, **kw)
        eng.add_prefix("task", jkv)
        want[f"offline_{layout}"] = _jserve(eng,
                                            ranks._offline_reqs(prompts))
        eng = JaxEngine(cfg, params, slots=ranks.SLOTS, max_len=96,
                        compressor=mc, compile_token_budget=16, **kw)
        want[f"online_{layout}"] = _jserve(
            eng, ranks._online_reqs(prompts, raw, 20))
    want["tiers"] = _jax_tiers(cfg, params, mc, jkv, spec, tmp / "jax")
    return dict(cfg=cfg, spec=spec, want=want)


def _jax_tiers(cfg, params, mc, jkv, spec, disk):
    """``torch_sharded_ranks._tiers``'s sequence on the JAX engine."""
    m = cfg.memcom.num_memory_tokens
    eng = JaxEngine(cfg, params, slots=ranks.SLOTS, max_len=m + 24,
                    clock=JClock(), compressor=mc, compile_token_budget=16,
                    host_capacity=4, disk_dir=str(disk),
                    promote_layer_budget=1)
    eng.add_prefix("t", jkv)
    uid = iter(range(100, 200))

    def one(prefix="t", raw=None):
        return _jserve(eng, [dict(tokens=spec["tier_prompt"], max_new=5,
                                  prefix=prefix, raw_shots=raw,
                                  uid=next(uid))])[0]

    def unseat():
        _jserve(eng, [dict(tokens=spec["tier_prompt"], max_new=1,
                           uid=next(uid))])

    tokens = [one()]
    unseat()
    eng.store.demote("t")
    tokens.append(one())
    unseat()
    eng.store.demote("t")
    eng.store.spill("t")
    tokens.append(one())
    tokens.append(one(prefix=None, raw=spec["tier_raw"]))
    return {"tokens": tokens, "tiers": eng.stats()["prefix_tiers"],
            "tier": eng.store.tier_of("t")}


@pytest.fixture(scope="module")
def two(ref):
    return run_ranks(ranks.two_ranks, 2, (ref["spec"],), timeout=SPAWN_S)


@pytest.fixture(scope="module")
def four(ref):
    return run_ranks(ranks.four_ranks, 4, (ref["spec"],), timeout=SPAWN_S)


# ---------------------------------------------------------------------------
# 2 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_ranks_offline_matches_jax(ref, two, layout):
    want = ref["want"][f"offline_{layout}"]
    for r in two:
        assert r[f"offline_{layout}"] == want
        assert r[f"offline_local_{layout}"] == want


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_ranks_online_matches_jax(ref, two, layout):
    for r in two:
        assert r[f"online_{layout}"] == ref["want"][f"online_{layout}"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_ranks_hold_their_slices(ref, two, layout):
    """Each rank holds half the heads, half of ff and of the vocabulary;
    a prefix materialized through the split target has the rank's 2 of 4
    KV heads."""
    cfg = ref["cfg"]
    d, hd = cfg.d_model, cfg.hd
    cache_k = ((ranks.SLOTS, 64, 2, hd) if layout == "dense"
               else (None, 4, 2, hd))
    for r in two:
        s = r[f"shapes_{layout}"]
        assert s["wq"] == (d, 4 * hd)
        assert s["mlp_wo"] == (cfg.d_ff // 2, d)
        assert s["embed"] == (cfg.vocab_size // 2, d)
        assert all(w in (None, g) for w, g in zip(cache_k, s["cache_k"]))
        assert s["mesh"] == {"data": 1, "model": 2}
        assert r[f"local_kv_heads_{layout}"] == 2


def test_two_ranks_fused_self_speculative_serving(two):
    """The fused step with the split target drafting for itself (its
    draft cache cut by head too) gives the unsplit engine's tokens."""
    for r in two:
        assert r["fused_spec"]["got"] == r["fused_spec"]["want"]


def test_two_ranks_tiers_match_jax(ref, two):
    """HBM, host and disk hits and a fresh compile give the JAX engine's
    tokens on both ranks, with its tier counters; each rank's shard sits
    in its own directory, and ``promote_bytes`` counts its half."""
    want = ref["want"]["tiers"]
    for r in two:
        got = r["tiers"]
        assert got["tokens"] == want["tokens"]
        assert got["tier"] == want["tier"]
        mine = dict(got["tiers"])
        theirs = dict(want["tiers"])
        assert 2 * mine.pop("promote_bytes") == theirs.pop("promote_bytes")
        assert mine == theirs
        assert mine["host_promotes"] >= 2 and mine["spills"] >= 1
        assert len(got["files"]) == 1


def test_placement_rule_replicates_attention_on_two_ranks(two):
    """smollm-135m-smoke's 3 heads do not split 2 ways: attention keeps
    its whole weights and cache, the MLP splits, tokens unchanged."""
    for r in two:
        p = r["placement_smollm"]
        assert p["got"] == p["want"]
        assert p["wq"] == p["whole_wq"] and not p["attn_tp"]
        assert p["cache_k"][-2] == 3


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-370m",
                                  "deepseek-v2-236b"])
def test_unported_families_raise_under_a_model_axis(two, arch):
    for r in two:
        msg = r["unported"][arch]
        assert msg is not None and msg.startswith("NotImplementedError")
        assert "ROADMAP" in msg


def test_mesh_past_the_ranks_raises(two):
    for r in two:
        assert r["too_many_ranks"].startswith("ValueError")
        assert "needs 4 ranks, the group has 2" in r["too_many_ranks"]


def test_diverged_control_planes_raise(two):
    for r in two:
        assert r["diverged"].startswith("RuntimeError")
        assert "diverged" in r["diverged"]
        assert r["agreed"] is None


# ---------------------------------------------------------------------------
# 4 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_four_ranks_offline_matches_jax(ref, four, layout):
    cfg = ref["cfg"]
    for r in four:
        assert r[f"offline_{layout}"] == ref["want"][f"offline_{layout}"]
        s = r[f"shapes_{layout}"]
        assert s["wq"] == (cfg.d_model, 2 * cfg.hd)
        assert s["cache_k"][-2] == 1
        assert s["mesh"] == {"data": 1, "model": 4}


def test_fsdp_rules_at_data_1_place_as_baseline(ref, four):
    for r in four:
        assert r["fsdp_data1"] == ref["want"]["offline_dense"]


def test_fsdp_rules_at_data_2_raise(ref, four):
    """Fully sharded weights at 2x2 serve (they raised before training's
    sharding came): the JAX engine's tokens, each rank holding a quarter
    of the first wq (d_model over data, heads over model)."""
    cfg = ref["cfg"]
    for r in four:
        assert r["fsdp_data2"] == ref["want"]["offline_dense"]
        assert r["fsdp_data2_wq"] == (cfg.d_model // 2,
                                      cfg.num_heads * cfg.hd // 2)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fsdp_rules_at_2x1_match_jax(ref, two, layout):
    cfg = ref["cfg"]
    for r in two:
        got = r["fsdp_2x1"]
        assert got[layout] == ref["want"][f"offline_{layout}"]
        assert got[f"wq_{layout}"] == (cfg.d_model // 2,
                                       cfg.num_heads * cfg.hd)


def test_data_axis_holds_replicas(ref, four):
    for r in four:
        assert r["mesh_2x2"] == ref["want"]["offline_dense"]
        assert r["shapes_2x2"]["mesh"] == {"data": 2, "model": 2}
        assert r["shapes_2x2"]["wq"] == (ref["cfg"].d_model,
                                         4 * ref["cfg"].hd)


def test_placement_rule_replicates_attention_on_four_ranks(four):
    """qwen2-vl-2b-smoke's 2 KV heads do not split 4 ways."""
    for r in four:
        p = r["placement_qwen"]
        assert p["got"] == p["want"]
        assert p["wq"] == p["whole_wq"] and not p["attn_tp"]
        assert p["mlp_wo"][0] == p["whole_ff"] // 4


# ---------------------------------------------------------------------------
# 1 rank, the launcher, what raises in one process
# ---------------------------------------------------------------------------


def test_one_rank_mesh_is_the_unsplit_engine(ref):
    (r,) = run_ranks(ranks.one_rank, 1, (ref["spec"],), timeout=SPAWN_S)
    assert r["mesh"] == r["plain"] == ref["want"]["offline_dense"]
    assert r["stats_mesh"] == {"data": 1, "model": 1}
    assert r["stats_plain"] is None
    assert r["moe"]["mesh"] == r["moe"]["plain"]


def test_hung_collective_fails_by_its_timeout():
    with pytest.raises((RuntimeError, TimeoutError)):
        run_ranks(ranks.hang, 2, (None,), timeout=5)


def test_launcher_mesh_2_gives_the_unsplit_tokens(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh", "2"])):
        out = tmp_path / f"{name}.json"
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "smollm-135m", "--smoke", "--device", "cpu", "--requests", "4",
             "--max-new", "4", "--metrics", str(out), *extra],
            capture_output=True, text=True, timeout=SPAWN_S, env=env,
            cwd=ROOT)
        assert res.returncode == 0, res.stderr[-3000:]
        runs[name] = json.loads(out.read_text())
    assert runs["mesh"]["tokens"] == runs["plain"]["tokens"]
    assert runs["mesh"]["mesh"] == "2"
    assert runs["mesh"]["rules"] == "baseline"
    assert runs["plain"]["mesh"] is None


def test_launcher_fsdp_at_data_2_raises(tmp_path):
    """``--mesh 2x1 --rules fsdp`` (it raised before training's sharding
    came) gives the one-rank launcher's tokens."""
    runs = {}
    for name, extra in (("plain", []),
                        ("fsdp", ["--mesh", "2x1", "--rules", "fsdp"])):
        out = tmp_path / f"{name}.json"
        launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--requests", "4", "--max-new", "4",
                           "--metrics", str(out), *extra])
        runs[name] = json.loads(out.read_text())
    assert runs["fsdp"]["tokens"] == runs["plain"]["tokens"]
    assert runs["fsdp"]["mesh"] == "2x1" and runs["fsdp"]["rules"] == "fsdp"


@pytest.mark.parametrize("spec", ["2x2x2", "0", "ax2"])
def test_launcher_bad_mesh_spec(spec, capsys):
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--mesh", spec])
    assert "mesh" in capsys.readouterr().err


def test_mesh_without_ranks_raises():
    with pytest.raises(ValueError, match="no process group"):
        make_serving_mesh(model=2, device="cpu")


def test_one_rank_mesh_needs_a_group():
    # a 1x1 mesh starts no group of its own: one_rank_group() holds one
    # for the block and tears it down after
    with pytest.raises(ValueError, match="one_rank_group"):
        make_serving_mesh(model=1, device="cpu")
    with one_rank_group():
        mesh = make_serving_mesh(model=1, device="cpu")
        assert mesh.shape == (1, 1) and mesh.control_group is None
    assert not torch.distributed.is_initialized()


def test_nccl_past_the_cards_raises():
    with pytest.raises(ValueError, match="one card per rank"):
        make_serving_mesh(model=torch.cuda.device_count() + 1,
                          device="cpu", backend="nccl")


def test_rules_without_a_mesh_raise():
    cfg = ranks.parity_config()
    target = tfm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="rules given without a mesh"):
        ServingEngine(cfg, target, slots=1, max_len=16, device="cpu",
                      rules=BASELINE_RULES)
