"""Telemetry plane: spans, metrics, exports — zero overhead when off.

Five parts, one discipline (see ``docs/observability.md``):

* :mod:`repro_torch.telemetry.clock` — the single monotonic clock every
  data-plane timestamp comes from.
* :mod:`repro_torch.telemetry.spans` — per-call span tracing into per-thread
  ring buffers; armed via :func:`enable` (one pointer compare per hook
  site when disarmed).
* :mod:`repro_torch.telemetry.metrics` — the named counter/gauge/histogram
  registry that the scattered hot-path counters publish into.
* :mod:`repro_torch.telemetry.trace` — Chrome/Perfetto ``trace_event`` export.
* :mod:`repro_torch.telemetry.device` — device spans: the card's time of
  the work a layer queues (CUDA timing events, read without a sync),
  into the registry's histograms and the tracer's rings
  (``docs/observability_torch.md``).
"""
from repro_torch.telemetry import clock, metrics, spans, trace      # noqa: F401
from repro_torch.telemetry import device                            # noqa: F401
from repro_torch.telemetry.device import device_span                # noqa: F401
from repro_torch.telemetry.spans import (Tracer, disable, enable,   # noqa: F401
                                   enabled, tracer)

__all__ = [
    "Tracer", "clock", "device", "device_span", "disable", "enable",
    "enabled", "metrics", "spans", "trace", "tracer",
]
