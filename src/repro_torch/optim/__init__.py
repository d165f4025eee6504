"""Optimizer and gradient transforms (the port's ``repro/optim``)."""

from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_constant, warmup_cosine
from repro_torch.optim.transforms import (ErrorFeedbackInt8,
                                          clip_by_global_norm,
                                          compress_grads_bf16, global_norm)

__all__ = [
    "AdamW",
    "warmup_cosine",
    "warmup_constant",
    "global_norm",
    "clip_by_global_norm",
    "compress_grads_bf16",
    "ErrorFeedbackInt8",
]
