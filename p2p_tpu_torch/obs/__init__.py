"""Telemetry (counterpart of ``p2p_tpu/obs``), as far as serving needs it:
the metrics registry and the Prometheus exposition. Sinks, spans, taps,
timing, the manifest and the watchdogs come later."""

from p2p_tpu_torch.obs.registry import (
    Counter,
    EWMARate,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from p2p_tpu_torch.obs.sinks import prometheus_exposition

__all__ = [
    "Counter",
    "EWMARate",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "prometheus_exposition",
    "set_registry",
]
