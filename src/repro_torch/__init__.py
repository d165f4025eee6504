"""PyTorch + CUDA port of the MemCom reproduction (``src/repro`` is the JAX
reference it is held to).

The same layout as ``repro``: ``config``/``configs``/``data`` (own copies),
``kernels`` (hand-written Hopper kernels beside their plain PyTorch
versions), ``models``, ``core``, ``serving``, ``launch``; plus ``bridge``,
which carries parameters between the two packages as numpy arrays.  The
package never imports ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise (:func:`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when no card is present instead of
    quietly running on the CPU; the CPU is used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
