"""Serving of the port (``repro/serving``): the compressed-prefix stores
and their host/disk tiers, the online prefix compiler, the pure-Python
control plane (scheduler, block allocator, clock), the
continuous-batching engine over a dense or a paged KV cache (Mamba2
layers keep per-slot recurrent state on both) with its fused step and
speculative decoding and budget autotuner, the traffic harness (Zipf
catalogs, timed arrivals, SLO metrics over a ``Histogram``), and the
observability of the reference: the flight-recorder tracer, the metrics
registry, the SLO burn-rate watchdog, the span profiler and the HTTP
telemetry server."""

from repro_torch.serving.block_pool import (TRASH_BLOCK, BlockAllocationError,
                                            BlockAllocator, OutOfBlocksError)
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.compiler import CompileJob, PrefixCompiler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_store import (PagedPrefixStore,
                                              PrefixSeatedError, PrefixStore,
                                              materialize_prefix,
                                              seat_prefix_row,
                                              take_prefix_row,
                                              write_prefix_to_cache)
from repro_torch.serving.profiler import (profile_spans,
                                          validate_profile_report)
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.server import TelemetryServer
from repro_torch.serving.slo_watchdog import (BurnRateRule, ShedDegrade,
                                              SLOWatchdog, default_rules,
                                              validate_alert_log)
from repro_torch.serving.telemetry import (Counter, Gauge, Histogram,
                                           MetricGroup, MetricsRegistry,
                                           Tracer, validate_chrome_trace)
from repro_torch.serving.tiers import PromotionJob, TieredPrefixStore
from repro_torch.serving.traffic import (Trace, TrafficConfig, generate_trace,
                                         slo_metrics)

__all__ = [
    "ServingEngine",
    "PrefixCompiler",
    "CompileJob",
    "TieredPrefixStore",
    "PromotionJob",
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
    "TrafficConfig",
    "Trace",
    "generate_trace",
    "slo_metrics",
    "Tracer",
    "MetricsRegistry",
    "MetricGroup",
    "Counter",
    "Gauge",
    "Histogram",
    "validate_chrome_trace",
    "TelemetryServer",
    "SLOWatchdog",
    "BurnRateRule",
    "ShedDegrade",
    "default_rules",
    "validate_alert_log",
    "profile_spans",
    "validate_profile_report",
    "materialize_prefix",
    "seat_prefix_row",
    "take_prefix_row",
    "write_prefix_to_cache",
]
