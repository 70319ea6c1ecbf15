"""Record sinks and the Prometheus exposition (counterpart of
``p2p_tpu/obs/sinks.py``, whole): every sink implements
``write(rec, force=False)`` / ``flush()`` / ``close()`` and receives the
host-coerced records the registry fans out (obs/registry.py).

- :class:`JSONLSink`: the ``metrics_<name>.jsonl`` stream; ``force=True``
  records flush to the OS at once, so a killed run keeps them;
- :class:`StdoutSink`: the heartbeat (forced records, ``eval`` records,
  every ``print_every`` steps);
- :class:`TensorBoardSink`: scalars into event files through the
  ``tensorboard`` package's writer; construction raises ``ImportError``
  where the package is missing, and callers treat the sink as optional;
- :class:`PrometheusTextfileSink`: the registry's state rewritten
  atomically for node_exporter's textfile collector;
- :class:`MetricsLogger`: the trainer's facade over a registry with the
  JSONL and stdout sinks.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Any, Dict, Optional


class Sink:
    """Interface; also a no-op null sink."""

    def write(self, rec: Dict[str, Any], force: bool = False) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JSONLSink(Sink):
    """Append-only JSON-lines file — the metrics_<name>.jsonl stream.

    ``flush_every`` buffers that many records between flushes; ``force=True``
    records (epoch summaries, eval, sentinel events) always flush so a killed
    run keeps its partial epoch. flush_every=1 (default) flushes
    every record.
    """

    def __init__(self, path: str, flush_every: int = 1):
        self.path = path
        self.flush_every = max(1, flush_every)
        self._pending = 0
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        atexit.register(self.close)

    def write(self, rec: Dict[str, Any], force: bool = False) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps(rec) + "\n")
            self._pending += 1
            if force or self._pending >= self.flush_every:
                self._f.flush()
                self._pending = 0

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._pending = 0

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


class StdoutSink(Sink):
    """The heartbeat: print on force, on eval
    records, and every ``print_every`` steps."""

    def __init__(self, print_every: int = 50):
        self.print_every = max(1, print_every)

    def write(self, rec: Dict[str, Any], force: bool = False) -> None:
        step = rec.get("step", 0)
        if force or rec.get("kind") == "eval" or step % self.print_every == 0:
            msg = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "ts"
            )
            print(msg, flush=True)


class TensorBoardSink(Sink):
    """Scalar records into TensorBoard event files.

    Uses the pure-python event writer bundled with the ``tensorboard``
    package (no TF dependency). Raises ImportError at construction when the
    package is absent — callers treat the sink as optional.

    Numeric fields of each record become ``<kind>/<field>`` scalars at the
    record's ``step`` (or an internal monotonic index when absent).
    """

    def __init__(self, logdir: str):
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.event_file_writer import (
            EventFileWriter,
        )

        os.makedirs(logdir, exist_ok=True)
        self._Event, self._Summary = Event, Summary
        self._writer = EventFileWriter(logdir)
        self._auto_step = 0
        atexit.register(self.close)

    def write(self, rec: Dict[str, Any], force: bool = False) -> None:
        if self._writer is None:
            return
        kind = rec.get("kind", "metric")
        step = rec.get("step")
        if step is None:
            self._auto_step += 1
            step = self._auto_step
        values = [
            self._Summary.Value(tag=f"{kind}/{k}", simple_value=float(v))
            for k, v in rec.items()
            if isinstance(v, (int, float)) and k not in ("step", "ts")
        ]
        if values:
            self._writer.add_event(
                self._Event(step=int(step), wall_time=rec.get("ts"),
                            summary=self._Summary(value=values))
            )

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _prom_name(s: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in s)
    return ("p2p_" + out) if not out or out[0].isdigit() else out


def prometheus_exposition(registry) -> str:
    """A registry's metric state in the Prometheus text exposition
    format: the one formatter behind the textfile sink below and the HTTP
    server's ``GET /metrics`` (serve/server.py), with the JAX formatter's
    names, labels and lines. The snapshot is taken first: a metric
    registered concurrently may appear in the later ``kinds()`` and is
    then skipped, never the reverse."""
    lines = []
    snap = sorted(registry.snapshot().items())
    kinds = registry.kinds()
    for key, fields in snap:
        if key not in kinds:
            continue
        name, _, tagpart = key.partition("{")
        labels = ""
        if tagpart:
            # registry keys carry tags as k=v,...} — the exposition
            # format requires label VALUES quoted (k="v"), and one
            # malformed line makes the collector drop the whole file
            pairs = []
            for kv in tagpart.rstrip("}").split(","):
                k, _, v = kv.partition("=")
                v = v.replace("\\", r"\\").replace('"', r"\"")
                pairs.append(f'{_prom_name(k)}="{v}"')
            labels = "{" + ",".join(pairs) + "}"
        base = _prom_name(name)
        ptype = {"counter": "counter", "ewma": "gauge",
                 "gauge": "gauge", "histogram": "summary"}[kinds[key]]
        lines.append(f"# TYPE {base} {ptype}")
        for f, v in fields.items():
            suffix = "" if f in ("value", "rate") else "_" + _prom_name(f)
            if v != v:  # NaN gauges poison dashboards; skip them
                continue
            lines.append(f"{base}{suffix}{labels} {v}")
    return "\n".join(lines) + "\n"


class PrometheusTextfileSink(Sink):
    """Textfile-exporter format (node_exporter's ``--collector.textfile``).

    This sink exports the REGISTRY's metric state, not the record stream: on
    every ``export_every``-th record (and on flush/close) it rewrites the
    target file atomically with the current snapshot. Point node_exporter at
    the directory and the trainer's counters/gauges land in Prometheus with
    zero daemon code here.
    """

    def __init__(self, path: str, registry, export_every: int = 50):
        self.path = path
        self.registry = registry
        self.export_every = max(1, export_every)
        self._n = 0
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        atexit.register(self.close)
        self._closed = False

    def write(self, rec: Dict[str, Any], force: bool = False) -> None:
        # counted under the lock (records arrive from any thread; a bare
        # += would lose updates), exported OUTSIDE it — export() takes
        # the same non-reentrant lock for the atomic rename
        with self._lock:
            self._n += 1
            n = self._n
        if force or n % self.export_every == 0:
            self.export()

    def export(self) -> None:
        if self._closed:
            return
        # formatted OUTSIDE the lock (prometheus_exposition snapshots the
        # registry race-free); the lock serializes the tmp-file rename
        # against other threads' force-records.
        text = prometheus_exposition(self.registry)
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, self.path)  # atomic: scrapers never see torn files

    def flush(self) -> None:
        self.export()

    def close(self) -> None:
        if not self._closed:
            try:
                self.export()
            finally:
                self._closed = True


class MetricsLogger:
    """The train loop's logging facade: a registry wired with the JSONL
    and stdout sinks behind ``.log(record, force)``. Extra sinks
    (TensorBoard, Prometheus textfile) attach via ``.registry.add_sink``."""

    def __init__(self, path: Optional[str] = None, print_every: int = 50,
                 registry=None):
        from p2p_tpu_torch.obs.registry import MetricsRegistry

        self.registry = registry if registry is not None else MetricsRegistry()
        self.path = path
        self._jsonl: Optional[JSONLSink] = None
        if path:
            self._jsonl = JSONLSink(path)
            self.registry.add_sink(self._jsonl)
        self.registry.add_sink(StdoutSink(print_every))
        # atexit flushes every attached sink on an orderly exit (sys.exit,
        # an uncaught exception); the train loop's PreemptionGuard runs the
        # same flush when a signal arrives; SIGKILL keeps what force=True
        # records already flushed
        self._atexit_flush = self.registry.flush
        atexit.register(self._atexit_flush)

    def log(self, record: Dict[str, Any], force: bool = False) -> None:
        self.registry.record(record, force=force)

    def close(self) -> None:
        # unhook the atexit flush: processes that build many loggers
        # (tests, sweeps) must not pin every registry until exit
        if self._atexit_flush is not None:
            atexit.unregister(self._atexit_flush)
            self._atexit_flush = None
        self.registry.close()
