"""Span tracing (counterpart of ``p2p_tpu/obs/spans.py``, whole): named
host intervals (epoch, eval, dispatch, checkpoint) paired with profiler
annotations.

Each ``span(...)``:

1. times the block on the host clock and keeps the (name, ts, dur, depth)
   record in a :class:`SpanRecorder` ring;
2. enters a ``torch.profiler.record_function`` range, so the same name
   shows on the profiler's timeline when a :func:`trace` capture runs;
3. optionally emits a ``kind="span"`` record into a registry.

:meth:`SpanRecorder.export_perfetto` writes the spans as Chrome-trace JSON
in the JAX module's layout (https://ui.perfetto.dev loads it), the host
complement of the profiler trace :func:`trace` exports.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Optional

import torch

# bound at import: a test that patches time.perf_counter to drive the
# train loop's clock must not skew the spans
_perf_counter = time.perf_counter
_wall_clock = time.time


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU, and
    the card when there is one) and export it as
    ``<logdir>/trace.json`` (Chrome-trace JSON)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A bare named range on the profiler's timeline (no host timing)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed_annotation(name: str, histogram=None):
    """The hot-path form of a span: a profiler range and an optional
    histogram observation, but no entry in a recorder ring (the trainer
    records only each epoch's first dispatches in the ring)."""
    t0 = _perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if histogram is not None:
            histogram.observe(_perf_counter() - t0)


class SpanRecorder:
    """Finished spans in a bounded ring that drops the oldest first, so
    the exported trace of a long run shows its latest window."""

    def __init__(self, max_spans: int = 200_000):
        self.max_spans = max_spans
        self.spans: Any = collections.deque(maxlen=max_spans)
        self._total = 0
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def dropped(self) -> int:
        return max(0, self._total - len(self.spans))

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, registry=None, force: bool = False,
             histogram=None, **attrs):
        """Time the block inside a profiler range and record it on exit.
        ``attrs`` (e.g. ``epoch=3``) ride along into the span and the
        optional registry record; ``histogram`` also receives the
        duration."""
        depth = self._depth()
        self._tls.depth = depth + 1
        ts = _wall_clock()
        t0 = _perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            dur = _perf_counter() - t0
            self._tls.depth = depth
            rec = {"name": name, "ts": ts, "dur_s": dur, "depth": depth,
                   **attrs}
            with self._lock:
                self.spans.append(rec)
                self._total += 1
            if histogram is not None:
                histogram.observe(dur)
            if registry is not None:
                registry.record(
                    {"kind": "span", "span": name, "sec": round(dur, 6),
                     **attrs},
                    force=force)

    def export_perfetto(self, path: str) -> str:
        """Write the spans as Chrome-trace JSON: complete events (``"ph":
        "X"``) with microsecond wall-clock timestamps, nested by their
        ts/dur containment; written to a temporary file renamed into
        place."""
        pid = os.getpid()
        with self._lock:
            spans = list(self.spans)
            dropped = self.dropped
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": "p2p_tpu host spans"}}]
        for s in spans:
            events.append({
                "name": s["name"], "ph": "X", "cat": "obs",
                "ts": int(s["ts"] * 1e6),
                "dur": max(int(s["dur_s"] * 1e6), 1),
                "pid": pid, "tid": 0,
                "args": {k: v for k, v in s.items()
                         if k not in ("name", "ts", "dur_s")}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            doc["p2p_tpu_dropped_spans"] = dropped
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


_default_recorder: Optional[SpanRecorder] = None
_default_lock = threading.Lock()


def get_recorder() -> SpanRecorder:
    global _default_recorder
    with _default_lock:
        if _default_recorder is None:
            _default_recorder = SpanRecorder()
        return _default_recorder


def span(name: str, recorder: Optional[SpanRecorder] = None, registry=None,
         **attrs):
    """A span on the process-default recorder (or ``recorder``)."""
    return (recorder or get_recorder()).span(name, registry=registry, **attrs)
