"""dwpa_tpu_torch.obs — unified telemetry: metrics, spans, logging.

One observability layer for every process in the system:

- :mod:`.metrics` — process-local registry (counters, gauges, fixed-
  bucket histograms; thread-safe, zero deps) with Prometheus text-format
  v0.0.4 and JSON rendering, plus snapshot/merge for multi-host slices.
- :mod:`.spans` — nested wall-clock spans over ``perf_counter`` with
  the repo's device-sync rule baked into the API (a span covering
  device work must force a device→host fetch before its clock stops —
  lint rule DW106 enforces it statically).
- :mod:`.logs` — ``setup_logging()``: the one logging config
  (``DWPA_LOG=json`` for structured lines) every emitter inherits.
- :mod:`.multihost` — ``is_emitter()``: only rank 0 of a multi-process
  slice emits; ``allgather_json`` / ``merged_slice_snapshot`` merge the
  slice's registries into one report.

Scrape surface: the server's ``?metrics`` endpoint (server/api.py)
renders the registry; README "Telemetry" documents metric names and
label conventions.
"""

from .logs import get_logger, setup_logging
from .metrics import (DEFAULT_BUCKETS, MetricsRegistry, default_registry)
from .multihost import allgather_json, is_emitter, merged_slice_snapshot
from .spans import Span, SpanTracer, default_tracer

__all__ = [
    "DEFAULT_BUCKETS", "MetricsRegistry", "default_registry",
    "Span", "SpanTracer", "default_tracer",
    "setup_logging", "get_logger", "is_emitter", "allgather_json",
    "merged_slice_snapshot",
]
