"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The paper's own two targets, the MoE family's granite-moe-3b-a800m, the
attention-free mamba2-370m, smollm-135m (the reference's training
tests run on its smoke config) and the dense smollm-360m, stablelm-1.6b
and mistral-nemo-12b, the hybrid jamba-1.5-large-398b (Mamba2 + attention,
MemCom's SSM-state handoff), the MLA family's deepseek-v2-236b, the
enc-dec whisper-medium (an encoder over precomputed frames, cross-
attention, learned positions) and qwen2-vl-2b (M-RoPE), copied from
``repro/configs``: every architecture the JAX package registers.  Each module exposes ``config()`` (full
published config) and ``smoke_config()`` (reduced same-family config for
CPU tests).
"""

from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = ("gemma2-2b", "mistral-7b", "granite-moe-3b-a800m", "mamba2-370m",
            "smollm-135m", "smollm-360m", "stablelm-1.6b", "mistral-nemo-12b",
            "jamba-1.5-large-398b", "deepseek-v2-236b", "whisper-medium",
            "qwen2-vl-2b")

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
            for name in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).config()


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).smoke_config()
