"""Telemetry for the port: the one clock and the metrics registry.

Copies of ``repro.telemetry.clock`` and ``repro.telemetry.metrics``.
Spans and trace export come with the runtime slice, because
``spans.enable()`` wires into the runtime's core and state modules.
"""
from repro_torch.telemetry import clock, metrics      # noqa: F401

__all__ = ["clock", "metrics"]
