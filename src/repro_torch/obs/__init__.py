"""repro_torch.obs — span tracing + metrics for the port.

One process-wide :class:`~repro_torch.obs.tracer.Tracer` and one
:class:`~repro_torch.obs.metrics.MetricsRegistry`, both disabled-cheap:
a disabled ``obs.span(...)`` is one flag check returning a shared no-op
context manager. Span name prefixes follow the reference package:
``op.`` kernel dispatch, ``tuning.`` autotuner decisions, ``serve.``
serving tier (queue_wait / flush / sample / pack / gather / apply),
``train.`` / ``loader.`` trainers. :class:`DeviceCounters` are counters
kept on the device and drained once per epoch. ``write_chrome_trace``
exports the spans for ``chrome://tracing`` / Perfetto (one process track
a rank: each rank passes its rank as ``pid``), ``metrics_to_jsonl``
appends the registry's snapshot to a JSONL file.
"""
from repro_torch.obs.tracer import (Span, Tracer, disable, enable, enabled,
                                    get_tracer, instant, op_profiling_enabled,
                                    op_record, op_t0, profiled, reset, span)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, metrics,
                                     metrics_to_jsonl)
from repro_torch.obs.device_counters import DeviceCounters, device_counters
from repro_torch.obs.export import (to_chrome_trace, validate_chrome_trace,
                                    write_chrome_trace)

__all__ = [
    "Span", "Tracer", "span", "instant", "op_record", "op_t0", "profiled",
    "enable", "disable", "enabled", "reset", "get_tracer",
    "op_profiling_enabled",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "metrics_to_jsonl", "DeviceCounters", "device_counters",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
]
