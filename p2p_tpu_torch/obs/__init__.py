"""Telemetry (counterpart of ``p2p_tpu/obs``): one import surface for what
the trainer and the serving service report through.

- **registry** (:mod:`.registry`): counters, gauges, histograms and EWMA
  rates with tags, and the record bus to the sinks;
- **sinks** (:mod:`.sinks`): the JSONL ``metrics_<name>.jsonl`` stream,
  the stdout heartbeat, TensorBoard event files, the Prometheus textfile
  and exposition;
- **spans** (:mod:`.spans`): host spans paired with
  ``torch.profiler.record_function`` ranges, exported as Perfetto-loadable
  JSON, and the ``trace()`` profiler capture;
- **taps** (:mod:`.taps`): NaN/Inf sentinels read one step late from
  pinned host buffers, and gradient-norm scalars;
- **watchdogs** (:mod:`.watchdogs`): the kernel-build watchdog and
  device-memory sampling;
- **timing** (:mod:`.timing`): the fenced ``StepTimer``;
- **manifest** (:mod:`.manifest`): the per-run provenance JSON.

The cross-host ``aggregate`` and ``crosscheck_hbm_budget`` come in later
slices (11 and 12).
"""

from p2p_tpu_torch.obs.manifest import (
    build_manifest,
    config_hash,
    write_manifest,
)
from p2p_tpu_torch.obs.registry import (
    Counter,
    EWMARate,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from p2p_tpu_torch.obs.sinks import (
    JSONLSink,
    MetricsLogger,
    PrometheusTextfileSink,
    Sink,
    StdoutSink,
    TensorBoardSink,
    prometheus_exposition,
)
from p2p_tpu_torch.obs.spans import (
    SpanRecorder,
    annotate,
    get_recorder,
    span,
    timed_annotation,
    trace,
)
from p2p_tpu_torch.obs.taps import (
    add_sentinel_handler,
    grad_norm_taps,
    nan_sentinel,
    read_sentinels,
    remove_sentinel_handler,
)
from p2p_tpu_torch.obs.timing import StepTimer, measure_rtt
from p2p_tpu_torch.obs.watchdogs import (
    MemoryWatchdog,
    RetraceWatchdog,
    budget_drift,
)

__all__ = [
    "Counter",
    "EWMARate",
    "Gauge",
    "Histogram",
    "JSONLSink",
    "MemoryWatchdog",
    "MetricsLogger",
    "MetricsRegistry",
    "PrometheusTextfileSink",
    "RetraceWatchdog",
    "Sink",
    "SpanRecorder",
    "StdoutSink",
    "StepTimer",
    "TensorBoardSink",
    "add_sentinel_handler",
    "annotate",
    "budget_drift",
    "build_manifest",
    "config_hash",
    "get_recorder",
    "get_registry",
    "grad_norm_taps",
    "measure_rtt",
    "nan_sentinel",
    "prometheus_exposition",
    "read_sentinels",
    "remove_sentinel_handler",
    "set_registry",
    "span",
    "timed_annotation",
    "trace",
    "write_manifest",
]
