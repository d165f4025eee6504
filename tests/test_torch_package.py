"""Package-level properties of the PyTorch port: it imports neither jax nor
the JAX package, its entry points run on the card unless asked for the
CPU (and raise without a card), its serve CLI drives the compress → serve
path, and ``chip_smoke.py`` refuses to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import memcom
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)  # smoke shapes: threads only contend with xdist
ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    code = """
import pkgutil, sys, importlib, runpy
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
sys.path.insert(0, sys.argv[1])
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes"))
mods = sorted(m for m in sys.modules if m.startswith("repro_torch."))
print(len(mods), bad, " ".join(mods))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n, _, mods = res.stdout.split(" ", 2)
    assert int(n) >= 40  # every module was imported
    for mod in ("optim.adamw", "optim.schedule", "optim.transforms",
                "checkpoint.store", "checkpoint.manager", "data.pipeline",
                "train.train_step", "train.trainer", "launch.steps",
                "launch.train", "configs.smollm_135m", "serving.compiler",
                "serving.tiers", "data.icl_tasks", "configs.bench_target",
                "serving.traffic", "serving.telemetry", "serving.slo_watchdog",
                "serving.profiler", "serving.server", "core.icae",
                "core.lora", "configs.smollm_360m", "configs.stablelm_1_6b",
                "configs.mistral_nemo_12b", "launch.costs",
                "launch.roofline"):
        assert f"repro_torch.{mod}" in mods.split(), mod


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    target = tfm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, target, slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])
    assert memcom.init_memcom(cfg, target, 1).mem_tokens.device.type == "cpu"


def test_seeded_init_is_deterministic_and_scaled():
    cfg = get_smoke_config("mistral-7b")
    a = tfm.init_params(cfg, 0, device="cpu")
    b = tfm.init_params(cfg, 0, device="cpu")
    c = tfm.init_params(cfg, 1, device="cpu")
    assert torch.equal(a.layers[1].attn.wq, b.layers[1].attn.wq)
    assert not torch.equal(a.layers[1].attn.wq, c.layers[1].attn.wq)
    assert not torch.equal(a.layers[0].attn.wq, a.layers[1].attn.wq)
    std = float(a.layers[0].mlp.wo.std())  # fan-in scaled: 1/sqrt(d_ff)
    assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert torch.equal(a.final_norm.scale, torch.ones(cfg.d_model))


def test_engine_validates_its_inputs():
    cfg = get_smoke_config("gemma2-2b")
    target = tfm.init_params(cfg, 0, device="cpu")
    engine = ServingEngine(cfg, target, slots=2, max_len=12, device="cpu")
    with pytest.raises(ValueError):
        engine.generate([np.arange(4, 8)], 2)  # one prompt for two slots
    with pytest.raises(ValueError):
        engine.generate([np.arange(4, 20)] * 2, 2)  # does not fit max_len
    with pytest.raises(KeyError):  # names a prefix nobody registered
        engine.serve([Request(tokens=np.arange(4, 8), max_new=2, prefix="a")])
    with pytest.raises(ValueError):
        ServingEngine(cfg, target, slots=2, max_len=12, device="cpu",
                      kv_layout="ragged")


@pytest.mark.parametrize("classify", [False, True])
def test_serve_cli_runs_compress_then_serve_on_the_cpu(tmp_path, classify):
    out = tmp_path / "metrics.json"
    argv = ["--arch", "mistral-7b", "--smoke", "--requests", "5",
            "--tasks", "2", "--slots", "2", "--max-new", "3",
            "--context-tokens", "48", "--device", "cpu",
            "--metrics", str(out)]
    metrics = serve.main(argv + (["--classify"] if classify else []))
    assert json.loads(out.read_text()) == metrics
    assert metrics["device"] == "cpu" and metrics["m"] == 8
    if classify:
        assert metrics["queries"] == 5 and 0 <= metrics["correct"] <= 5
    else:
        assert metrics["generated"] == 5 * 3


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_serve_cli_paged_layout_on_the_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    metrics = serve.main(["--arch", "gemma2-2b", "--smoke", "--requests", "6",
                          "--tasks", "2", "--slots", "4", "--max-new", "4",
                          "--context-tokens", "48", "--device", "cpu",
                          "--kv-layout", "paged", "--block-size", "3",
                          "--priority-classes", "2", "--priority-aging",
                          "0.01", "--metrics", str(out)])
    # aging on the wall clock may reorder admissions (and then preempt),
    # never change what a request generates
    assert metrics["kv_layout"] == "paged" and metrics["generated"] == 6 * 4
    pool = metrics["pool"]
    # both prefixes stay resident: 2 x ceil(m / 3) shared blocks at least
    assert pool["block_size"] == 3 and pool["blocks_used"] >= 2 * 3


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_cli_runs_granite_moe_on_the_cpu(layout):
    """The MoE config through the launcher: compress, then serve ragged
    requests (prefills at the padded width) on either KV layout."""
    metrics = serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                          "--requests", "5", "--tasks", "2", "--slots", "3",
                          "--max-new", "3", "--context-tokens", "48",
                          "--device", "cpu", "--kv-layout", layout,
                          "--block-size", "4"])
    assert metrics["arch"] == "granite-moe-smoke" and metrics["m"] == 8
    assert metrics["kv_layout"] == layout and metrics["generated"] == 5 * 3
