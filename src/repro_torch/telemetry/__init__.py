"""Telemetry plane: spans, metrics, exports — zero overhead when off.

Four parts, one discipline (see ``docs/observability.md``):

* :mod:`repro_torch.telemetry.clock` — the single monotonic clock every
  data-plane timestamp comes from.
* :mod:`repro_torch.telemetry.spans` — per-call span tracing into per-thread
  ring buffers; armed via :func:`enable` (one pointer compare per hook
  site when disarmed).
* :mod:`repro_torch.telemetry.metrics` — the named counter/gauge/histogram
  registry that the scattered hot-path counters publish into.
* :mod:`repro_torch.telemetry.trace` — Chrome/Perfetto ``trace_event`` export.
"""
from repro_torch.telemetry import clock, metrics, spans, trace      # noqa: F401
from repro_torch.telemetry.spans import (Tracer, disable, enable,   # noqa: F401
                                   enabled, tracer)

__all__ = [
    "Tracer", "clock", "disable", "enable", "enabled", "metrics",
    "spans", "trace", "tracer",
]
