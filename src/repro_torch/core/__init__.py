"""The paper's technique and its baselines (``repro/core``): MemCom
compression, and the ICAE / ICAE+ / ICAE++ compressors with their LoRA
adapters."""

from repro_torch.core.icae import (ICAE, icae_compress, icae_loss,
                                   icae_trainable_mask, init_icae)
from repro_torch.core.lora import init_lora, merge_lora
from repro_torch.core.memcom import (build_prefix, compress, init_memcom,
                                     init_memx, memcom_loss, next_token_loss,
                                     trainable_mask)

__all__ = [
    "init_memcom",
    "init_memx",
    "compress",
    "memcom_loss",
    "next_token_loss",
    "trainable_mask",
    "build_prefix",
    "ICAE",
    "init_icae",
    "icae_compress",
    "icae_loss",
    "icae_trainable_mask",
    "merge_lora",
    "init_lora",
]
