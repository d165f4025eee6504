"""Checkpoints (the port's ``repro/checkpoint``): the reference's manifest
and shard format, so that either package loads the other's."""

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import (compress_bytes, decompress_bytes,
                                          default_codec, load_tree, save_tree)

__all__ = ["save_tree", "load_tree", "CheckpointManager", "compress_bytes",
           "decompress_bytes", "default_codec"]
