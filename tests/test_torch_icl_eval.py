"""``eval_accuracy`` and the committed trained target in both packages, and
the launcher's online-compile and tier flags against the JAX launcher's,
on the CPU.

* ``artifacts/bench/target/`` (the tiny target ``benchmarks/`` pretrains)
  loads through the port's checkpoint codec (``bridge.load_params``) and
  through the JAX store; ``eval_accuracy`` then scores a few episodes of
  one of ``benchmarks.common.TASKS`` through each engine's
  ``score_labels`` (full budget, and the fewer-shots protocol with
  ``query_budget``): the same predicted labels and the same accuracy.
* ``repro_torch.launch.serve`` with ``--raw-shots --compile-budget 16``,
  and with ``--host-capacity 0 --disk-dir`` under a one-prefix HBM store,
  prints the JAX launcher's tokens for the same flags, both launchers on
  the same parameters (the JAX launcher's seeds, carried across by
  ``repro_torch.bridge``).
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import memcom as jmc
from repro.data import eval_accuracy as jeval_accuracy
from repro.models import transformer as jtfm
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import bench_target
from repro_torch.data import SyntheticVocab, eval_accuracy
from repro_torch.serving import ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The trained target and eval_accuracy
# ---------------------------------------------------------------------------


def test_bench_target_config_is_the_benchmarks_config():
    sys.path.insert(0, ROOT)
    from benchmarks import common

    want = dataclasses.asdict(common.target_config())
    assert dataclasses.asdict(bench_target.config()) == want
    assert dataclasses.asdict(bench_target.VOCAB) == \
        dataclasses.asdict(common.VOCAB)
    assert bench_target.SOURCE_LEN == common.SOURCE_LEN
    assert {k: dataclasses.asdict(t) for k, t in bench_target.TASKS.items()} \
        == {k: dataclasses.asdict(t) for k, t in common.TASKS.items()}


@pytest.fixture(scope="module")
def trained():
    sys.path.insert(0, ROOT)
    from benchmarks import common
    from repro.checkpoint import load_tree

    jcfg = common.target_config()
    params = jtfm.init_params(jcfg, 0)
    tree, jmeta = load_tree(os.path.join(ROOT, bench_target.CHECKPOINT),
                            params)
    params = jax.tree.map(np.asarray, tree)
    cfg = bench_target.config()
    target, meta = bridge.load_params(
        cfg, os.path.join(ROOT, bench_target.CHECKPOINT), device="cpu")
    assert meta == jmeta and meta["steps"] == 4000
    return dict(common=common, jcfg=jcfg, params=params, cfg=cfg,
                target=target)


@pytest.mark.parametrize("query_budget", [None, 96])
def test_eval_accuracy_on_the_trained_target_matches_jax(trained,
                                                         query_budget):
    """One task, 3 episodes x 4 queries through ``score_labels``; with
    ``query_budget`` the model sees a 48-token context of a 96-token
    prompt's shots."""
    common, vocab = trained["common"], bench_target.VOCAB
    task = bench_target.TASKS["hwu64-like"]
    ids = vocab.label_ids()
    budget = bench_target.SOURCE_LEN if query_budget is None else 48
    jeng = JaxEngine(trained["jcfg"], trained["params"], slots=1,
                     max_len=128)
    peng = ServingEngine(trained["cfg"], trained["target"], slots=1,
                         max_len=128, device="cpu")
    preds = ([], [])

    def predictor(eng, out):
        def predict(context, query):
            out.append(int(eng.score_labels(context, query, ids))
                       - vocab.label_base)
            return out[-1]
        return predict

    kw = dict(budget=budget, query_budget=query_budget, n_episodes=3,
              queries_per_episode=4, seed=5)
    want = jeval_accuracy(predictor(jeng, preds[0]), task, **kw)
    got = eval_accuracy(predictor(peng, preds[1]), task, **kw)
    assert preds[1] == preds[0] and len(preds[1]) == 12
    assert got == want


def test_eval_accuracy_protocol_matches_jax():
    """The episodes, contexts and queries the port's ``eval_accuracy``
    hands its predictor are the JAX one's, budget or query budget."""
    sys.path.insert(0, ROOT)
    from benchmarks import common

    task = common.TASKS["banking77-like"]
    for kw in (dict(budget=96), dict(budget=40, query_budget=96)):
        seen = ([], [])

        def record(out):
            def predict(context, query):
                out.append((context.tolist(), query.tolist()))
                return len(out) % 3
            return predict

        a = jeval_accuracy(record(seen[0]), task, n_episodes=2,
                           queries_per_episode=3, **kw)
        b = eval_accuracy(record(seen[1]), task, n_episodes=2,
                          queries_per_episode=3, **kw)
        assert seen[1] == seen[0] and a == b
        assert all(len(c) % task.shot_tokens == 0 for c, _ in seen[1])


# ---------------------------------------------------------------------------
# The launcher's new flags against the JAX launcher's
# ---------------------------------------------------------------------------


def _launch_both(monkeypatch, argv, port_extra=()):
    """Run both launchers with ``argv`` (the port's with ``port_extra``
    too) on the JAX launcher's parameters.  Returns (the JAX launcher's
    tokens per request, the port launcher's metrics)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    arch = argv[argv.index("--arch") + 1]
    jcfg = get_smoke_config(arch).replace(vocab_size=SyntheticVocab().size)
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
    real_serve = JaxEngine.serve

    def spy(self, requests, **kw):
        requests = list(requests)
        out = real_serve(self, requests, **kw)
        want.extend(out[r.uid].tolist() for r in requests)
        return out

    monkeypatch.setattr(JaxEngine, "serve", spy)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    metrics = serve.main(argv + list(port_extra) + ["--device", "cpu"])
    return want, metrics


def test_launcher_raw_shots_matches_jax(monkeypatch, capsys):
    argv = ["--arch", "mistral-7b", "--smoke", "--requests", "4",
            "--tasks", "2", "--slots", "2", "--max-new", "4",
            "--context-tokens", "48", "--raw-shots", "--compile-budget",
            "16"]
    want, metrics = _launch_both(monkeypatch, argv)
    assert metrics["tokens"] == want and len(want) == 4
    assert metrics["compiler"]["jobs"] == 2
    assert metrics["compiler"]["deduped"] == 2
    assert "online compile: 2 job(s)" in capsys.readouterr().out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_launcher_tiers_match_jax(monkeypatch, tmp_path, layout):
    argv = ["--arch", "mistral-7b", "--smoke", "--requests", "4",
            "--tasks", "2", "--slots", "2", "--max-new", "4",
            "--context-tokens", "48", "--prefix-capacity", "1",
            "--host-capacity", "0", "--kv-layout", layout, "--disk-dir"]
    from repro_torch.launch import serve

    # each launcher spills into a directory of its own
    want, metrics = _launch_both(monkeypatch, argv + [str(tmp_path / "jax")],
                                 ["--disk-dir", str(tmp_path / "port")])
    assert metrics["tokens"] == want
    ts = metrics["prefix_tiers"]
    assert ts["demotes"] >= 1 and ts["spills"] >= 1 and ts["disk_loads"] >= 1
    assert len(os.listdir(tmp_path / "port")) == ts["disk_resident"]
    with pytest.raises(SystemExit):
        serve.main(argv[:-1] + ["--host-capacity", "-1", "--device", "cpu"])
