"""Serving of the port (``repro/serving``): the compressed-prefix stores,
the pure-Python control plane (scheduler, block allocator, clock) and the
continuous-batching engine over a dense or a paged KV cache."""

from repro_torch.serving.block_pool import (TRASH_BLOCK, BlockAllocationError,
                                            BlockAllocator, OutOfBlocksError)
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_store import (PagedPrefixStore,
                                              PrefixSeatedError, PrefixStore,
                                              materialize_prefix,
                                              seat_prefix_row,
                                              take_prefix_row,
                                              write_prefix_to_cache)
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = [
    "ServingEngine",
    "PrefixStore",
    "PagedPrefixStore",
    "PrefixSeatedError",
    "BlockAllocator",
    "BlockAllocationError",
    "OutOfBlocksError",
    "TRASH_BLOCK",
    "Request",
    "Scheduler",
    "VirtualClock",
    "materialize_prefix",
    "seat_prefix_row",
    "take_prefix_row",
    "write_prefix_to_cache",
]
