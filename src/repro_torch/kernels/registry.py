"""The port's kernels, each with its plain twin and the TPU kernel it replaces.

Keys are ``"<wrapper module>:<function>"`` under ``repro_torch.kernels``;
``plain`` names the function in :mod:`.plain` the kernel is held to on the
card and that runs for CPU tensors; ``replaces`` is the Pallas entry point
of the JAX package (by file and line); ``source`` is the CUDA file.
"""

from __future__ import annotations

KERNELS = {
    "flash_attention:flash_attention": {
        "plain": "attention_ref",
        "replaces": "src/repro/kernels/flash_attention.py:127",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
    },
    "memcom_xattn:memcom_xattn": {
        "plain": "memcom_xattn_ref",
        "replaces": "src/repro/kernels/memcom_xattn.py:96",
        "source": "src/repro_torch/kernels/csrc/memcom_xattn.cu",
    },
    "paged_attention:paged_flash_decode": {
        "plain": "paged_decode_attention_ref",
        "replaces": "src/repro/kernels/paged_attention.py:117",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
    },
}


def resolve(key: str):
    """Return (kernel wrapper, plain twin) for a registry key."""
    import importlib

    from repro_torch.kernels import plain

    modname, fn = key.split(":")
    mod = importlib.import_module(f"repro_torch.kernels.{modname}")
    return getattr(mod, fn), getattr(plain, KERNELS[key]["plain"])
