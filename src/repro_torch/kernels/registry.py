"""The port's kernels, each with its plain twin and the TPU kernel it replaces.

Keys are ``"<wrapper module>:<function>"`` under ``repro_torch.kernels``;
``plain`` names the function in :mod:`.plain` the kernel is held to on the
card and that runs for CPU tensors; ``replaces`` is the Pallas entry point
of the JAX package (by file and line); ``source`` is the CUDA file.  A backward kernel replaces the gradient
JAX forms for the Pallas entry point by differentiating its jnp path (the
JAX package defines no ``custom_vjp``), so it names that entry point too.
"""

from __future__ import annotations

KERNELS = {
    "flash_attention:flash_attention": {
        "plain": "attention_ref",
        "replaces": "src/repro/kernels/flash_attention.py:127",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
    },
    "flash_attention:flash_attention_bwd": {
        "plain": "attention_bwd_ref",
        "replaces": "src/repro/kernels/flash_attention.py:127",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    },
    "memcom_xattn:memcom_xattn": {
        "plain": "memcom_xattn_ref",
        "replaces": "src/repro/kernels/memcom_xattn.py:96",
        "source": "src/repro_torch/kernels/csrc/memcom_xattn.cu",
    },
    "memcom_xattn:memcom_xattn_bwd": {
        "plain": "memcom_xattn_bwd_ref",
        "replaces": "src/repro/kernels/memcom_xattn.py:96",
        "source": "src/repro_torch/kernels/csrc/memcom_xattn.cu",
    },
    "paged_attention:paged_flash_decode": {
        "plain": "paged_decode_attention_ref",
        "replaces": "src/repro/kernels/paged_attention.py:117",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
    },
    "moe_gmm:gmm": {
        "plain": "gmm_ref",
        "replaces": "src/repro/kernels/moe_gmm.py:61",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    },
    "moe_gmm:gmm_bwd": {
        "plain": "gmm_bwd_ref",
        "replaces": "src/repro/kernels/moe_gmm.py:61",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    },
    "ssd_scan:ssd": {
        "plain": "ssd_ref",
        "replaces": "src/repro/kernels/ssd_scan.py:93",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    },
    "ssd_scan:ssd_bwd": {
        "plain": "ssd_bwd_ref",
        "replaces": "src/repro/kernels/ssd_scan.py:93",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    },
}


def resolve(key: str):
    """Return (kernel wrapper, plain twin) for a registry key."""
    import importlib

    from repro_torch.kernels import plain

    modname, fn = key.split(":")
    mod = importlib.import_module(f"repro_torch.kernels.{modname}")
    return getattr(mod, fn), getattr(plain, KERNELS[key]["plain"])
