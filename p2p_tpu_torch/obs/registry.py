"""Process-wide metrics registry (counterpart of
``p2p_tpu/obs/registry.py:29-386``): counters, gauges, histograms and EWMA
rates keyed by (name, tags), thread-safe, with the JAX package's names,
bucket bounds and snapshot fields, so one series reads the same from
either package.

Ported: the four metric kinds, :class:`MetricsRegistry` (get-or-create
factories, ``snapshot``, ``kinds``, ``total``, the record bus that fans
structured records out to its sinks: obs/sinks.py, and the cross-process
``aggregate`` over the default process group), the pure combine
:func:`combine_host_snapshots` and the process default
(:func:`get_registry` / :func:`set_registry`).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

Tags = Tuple[Tuple[str, str], ...]


def _tags_key(tags: Dict[str, Any]) -> Tags:
    return tuple(sorted((k, str(v)) for k, v in tags.items()))


class Counter:
    """Monotonic count (events, images, retries)."""

    kind = "counter"

    def __init__(self, name: str, tags: Tags = ()):
        self.name, self.tags = name, tags
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, float]:
        return {"value": self._value}


class Gauge:
    """Last-written level (queue depth, pool fill)."""

    kind = "gauge"

    def __init__(self, name: str, tags: Tags = ()):
        self.name, self.tags = name, tags
        self._value = float("nan")

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, float]:
        return {"value": self._value}


class Histogram:
    """Streaming distribution over fixed log-spaced buckets (default 1 µs
    .. ~1000 s in half-decade steps). count/sum/min/max are exact,
    quantiles bucket-resolution estimates."""

    kind = "histogram"
    DEFAULT_BOUNDS = tuple(10.0 ** (e / 2.0) for e in range(-12, 7))

    def __init__(self, name: str, tags: Tags = (),
                 bounds: Optional[Iterable[float]] = None):
        self.name, self.tags = name, tags
        self.bounds = (tuple(bounds) if bounds is not None
                       else self.DEFAULT_BOUNDS)
        self.buckets = [0] * (len(self.bounds) + 1)  # last = +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.buckets[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-th observation."""
        if not self.count:
            return float("nan")
        target = q * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {"count": float(self.count), "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


class EWMARate:
    """Exponentially weighted event rate: ``mark(n)`` credits n events,
    the rate is an EWMA of per-interval rates with a half-life in
    seconds. Locked: the HTTP handlers mark from many threads."""

    kind = "ewma"

    def __init__(self, name: str, tags: Tags = (), halflife_s: float = 30.0,
                 clock=time.monotonic):
        self.name, self.tags = name, tags
        self.halflife_s = halflife_s
        self._clock = clock
        self._rate = float("nan")
        self._t_last: Optional[float] = None
        self._lock = threading.Lock()

    def mark(self, n: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            if self._t_last is None:
                self._t_last = now
                return
            dt = max(now - self._t_last, 1e-9)
            self._t_last = now
            inst = n / dt
            if math.isnan(self._rate):
                self._rate = inst
            else:
                alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
                self._rate += alpha * (inst - self._rate)

    @property
    def rate(self) -> float:
        return self._rate

    def snapshot(self) -> Dict[str, float]:
        return {"rate": self._rate}


def _key(name: str, tags: Tags) -> str:
    return name + ("{" + ",".join(f"{k}={v}" for k, v in tags) + "}"
                   if tags else "")


# the cross-process combine of each kind's snapshot fields
_REDUCERS = {
    "counter": {"value": sum},
    "gauge": {"value_mean": None, "value_max": None},  # special-cased
    "ewma": {"rate": sum},
    "histogram": {"count": sum, "sum": sum, "min": min, "max": max},
}


def combine_host_snapshots(rows: List[Dict[str, Dict[str, float]]],
                           kinds: Dict[str, str]
                           ) -> Dict[str, Dict[str, float]]:
    """Combine per-process ``snapshot()`` dicts (``p2p_tpu/obs/
    registry.py:189``): counters and EWMA rates add, histograms add their
    counts and sums and keep the extremes, gauges give their mean and max;
    a metric missing on some process combines over those that have it."""
    out: Dict[str, Dict[str, float]] = {}
    for key, kind in kinds.items():
        cols = [r[key] for r in rows if key in r]
        if not cols:
            continue
        if kind == "gauge":
            vals = [c["value"] for c in cols if not math.isnan(c["value"])]
            out[key] = {
                "value_mean": sum(vals) / len(vals) if vals else float("nan"),
                "value_max": max(vals) if vals else float("nan"),
            }
            continue
        fields = {}
        for f, red in _REDUCERS[kind].items():
            vals = [c[f] for c in cols if f in c]
            if vals:
                fields[f] = red(vals)
        if kind == "histogram" and fields.get("count"):
            fields["mean"] = fields["sum"] / fields["count"]
        out[key] = fields
    return out


class MetricsRegistry:
    """Metric factory: ``counter/gauge/histogram/ewma(name, **tags)``
    get or create a metric (idempotent per (name, tags), safe in hot
    loops); ``snapshot()`` and ``kinds()`` expose the state to the
    Prometheus formatter (obs/sinks.py); ``record`` fans structured
    records out to the attached sinks."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tags], Any] = {}
        self._sinks: List[Any] = []
        self._lock = threading.Lock()

    def _get(self, cls, name: str, tags: Dict[str, Any], **kw):
        key = (name, _tags_key(tags))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **tags) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, bounds=None, **tags) -> Histogram:
        return self._get(Histogram, name, tags, bounds=bounds)

    def ewma(self, name: str, halflife_s: float = 30.0, **tags) -> EWMARate:
        return self._get(EWMARate, name, tags, halflife_s=halflife_s)

    # the sink list changes under the lock; every fan-out iterates a
    # snapshot, so a sink attached while records flow from another thread
    # (the signal guard's flush helper) cannot break the iteration
    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    @property
    def sinks(self) -> Tuple[Any, ...]:
        with self._lock:
            return tuple(self._sinks)

    def record(self, payload: Dict[str, Any], force: bool = False) -> None:
        """Fan a structured record (a flat dict with a ``kind`` field) out
        to every sink. Numbers and 0-d tensors become host floats here, so
        no sink holds a device tensor; a ``ts`` wall-clock stamp is
        added."""
        rec = {k: (float(v) if hasattr(v, "item")
                   or isinstance(v, (int, float)) else v)
               for k, v in payload.items()}
        rec.setdefault("ts", round(time.time(), 3))
        for s in self.sinks:
            s.write(rec, force=force)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._metrics.items())
        return {_key(name, tags): m.snapshot() for (name, tags), m in items}

    def kinds(self) -> Dict[str, str]:
        with self._lock:
            items = list(self._metrics.items())
        return {_key(name, tags): m.kind for (name, tags), m in items}

    def total(self, name: str) -> float:
        """A counter's value summed over all its tag variants."""
        with self._lock:
            items = list(self._metrics.items())
        return sum(m.value for (n, _), m in items
                   if n == name and m.kind == "counter")

    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """The snapshot combined over every process of the default group
        (the snapshot itself through the same combine on one process).
        Every process calls it together: the key sets may differ, so each
        snapshot travels as length-padded JSON in two all-gathers (the
        lengths, then the bytes)."""
        import json

        import numpy as np

        from p2p_tpu_torch.core.mesh import process_allgather, process_count

        snap = self.snapshot()
        kinds = self.kinds()
        if process_count() == 1:
            return combine_host_snapshots([snap], kinds)
        blob = json.dumps([snap, kinds]).encode()
        lens = process_allgather(
            np.array([len(blob)], np.int64)).reshape(-1)
        buf = np.zeros(int(lens.max()), np.uint8)
        buf[:len(blob)] = np.frombuffer(blob, np.uint8)
        rows = process_allgather(buf).reshape(len(lens), -1)
        host_rows, all_kinds = [], {}
        for r, n in zip(rows, lens):
            s, k = json.loads(bytes(r[:int(n)]).decode())
            host_rows.append(s)
            all_kinds.update(k)
        return combine_host_snapshots(host_rows, all_kinds)


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def set_registry(reg: Optional[MetricsRegistry]
                 ) -> Optional[MetricsRegistry]:
    """Swap the process default (tests); returns the previous one."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = reg
        return prev
