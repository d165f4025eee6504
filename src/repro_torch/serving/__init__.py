"""Serving of the port (``repro/serving``): the compressed-prefix store and
the lock-step dense engine."""

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_store import (PrefixStore, materialize_prefix,
                                              seat_prefix_row,
                                              take_prefix_row,
                                              write_prefix_to_cache)

__all__ = [
    "ServingEngine",
    "PrefixStore",
    "materialize_prefix",
    "seat_prefix_row",
    "take_prefix_row",
    "write_prefix_to_cache",
]
