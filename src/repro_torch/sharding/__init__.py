"""Placement of the port on a ("data", "model") mesh of
``torch.distributed`` ranks (``repro/sharding``): the logical-axis rules
and the serving placements.  ``constrain_cache``, ``constrain_heads`` and
``shard_map_heads`` have no counterpart: under explicit placement every
tensor already is the rank's slice (:mod:`repro_torch.sharding.serving`)."""

from repro_torch.sharding.rules import (
    BASELINE_RULES,
    FSDP_RULES,
    LAYERS_FSDP_RULES,
    Rules,
    batch_sharding,
    logical_to_shardings,
    opt_state_shardings,
    replicated,
)
from repro_torch.sharding.serving import (
    cache_shardings,
    model_axis_size,
    shard_cache,
)

__all__ = [
    "Rules",
    "BASELINE_RULES",
    "FSDP_RULES",
    "LAYERS_FSDP_RULES",
    "logical_to_shardings",
    "batch_sharding",
    "replicated",
    "opt_state_shardings",
    "cache_shardings",
    "model_axis_size",
    "shard_cache",
]
