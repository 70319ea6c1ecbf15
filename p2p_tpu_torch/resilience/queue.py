"""Serving's request queue (counterpart of
``p2p_tpu/resilience/queue.py:39-247``): a depth cap that sheds the newest
arrivals, a byte budget over queued payloads, per-request deadlines,
requeue with backoff, ``flush``, and quarantine of poison inputs by
moving them out of the watched directory. The counters and gauges keep
the JAX names and tags: ``serve_shed_total``,
``serve_deadline_expired_total``, ``serve_queue_depth``,
``serve_quarantined_total``, each tagged ``tenant=`` when given one.

The queue is not thread-safe by itself: the directory frontend is single
threaded, and the HTTP frontend goes through
:class:`p2p_tpu_torch.serve.batcher.ContinuousBatcher`'s condition lock.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple


@dataclasses.dataclass
class Request:
    """One queued request: a file name (directory frontend), or a name and
    the request body in ``payload`` (HTTP frontend)."""

    name: str
    enqueued_at: float
    attempts: int = 0
    not_before: float = 0.0   # backoff: not dispatched before this time
    payload: Any = None       # in-memory body; None = decode from disk
    cost: int = 0             # queued payload bytes (the byte budget)


class BoundedRequestQueue:
    """FIFO with a depth cap (shed newest), an optional byte budget over
    queued ``bytes`` payloads, deadlines, and retry re-entry."""

    def __init__(self, max_depth: int, deadline_s: Optional[float] = None,
                 registry=None, clock: Callable[[], float] = time.monotonic,
                 tenant: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.deadline_s = deadline_s
        self.tenant = tenant
        self.max_bytes = max_bytes
        self.queued_bytes = 0
        self._clock = clock
        self._q: deque = deque()
        if registry is None:
            from p2p_tpu_torch.obs import get_registry

            registry = get_registry()
        tags = {"tenant": tenant} if tenant else {}
        self._shed = registry.counter("serve_shed_total", **tags)
        self._expired = registry.counter("serve_deadline_expired_total",
                                         **tags)
        self._depth = registry.gauge("serve_queue_depth", **tags)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def shed_count(self) -> int:
        return int(self._shed.value)

    @property
    def expired_count(self) -> int:
        return int(self._expired.value)

    def _full(self, cost: int) -> bool:
        return len(self._q) >= self.max_depth or (
            self.max_bytes is not None
            and self.queued_bytes + cost > self.max_bytes)

    def offer(self, name: str, payload: Any = None) -> Optional[Request]:
        """Enqueue a fresh request; the queued :class:`Request`, or None
        (a shed, counted) when full."""
        return self.offer_request(Request(name, 0.0, payload=payload))

    def offer_request(self, req: Request) -> Optional[Request]:
        """Enqueue a caller-built request, stamping ``enqueued_at`` (the
        deadline clock starts here); sheds like :meth:`offer`."""
        req.cost = (len(req.payload)
                    if isinstance(req.payload, (bytes, bytearray)) else 0)
        if self._full(req.cost):
            self._shed.inc()
            self._depth.set(len(self._q))
            return None
        req.enqueued_at = self._clock()
        self._q.append(req)
        self.queued_bytes += req.cost
        self._depth.set(len(self._q))
        return req

    def oldest_enqueued_at(self) -> Optional[float]:
        """Arrival time of the head of the queue (the batcher's linger
        clock); None when empty."""
        return self._q[0].enqueued_at if self._q else None

    def requeue(self, req: Request, delay_s: float = 0.0) -> bool:
        """Re-enter a failed request, not dispatchable for ``delay_s``;
        it keeps its first enqueue time, so the deadline covers its whole
        time in the system. Sheds (False) when full."""
        if self._full(req.cost):
            self._shed.inc()
            return False
        req.not_before = self._clock() + max(0.0, delay_s)
        self._q.append(req)
        self.queued_bytes += req.cost
        self._depth.set(len(self._q))
        return True

    def take(self, n: int) -> Tuple[List[Request], List[Request]]:
        """Dequeue up to ``n`` dispatchable requests: ``(ready,
        expired)``. Expired requests are counted and handed back, never
        dispatched; requests inside a backoff window stay queued, in
        order, without blocking younger ones."""
        ready: List[Request] = []
        expired: List[Request] = []
        waiting: List[Request] = []
        now = self._clock()
        while self._q and len(ready) < n:
            req = self._q.popleft()
            if self.deadline_s is not None and \
                    now - req.enqueued_at > self.deadline_s:
                self._expired.inc()
                expired.append(req)
            elif req.not_before > now:
                waiting.append(req)
            else:
                ready.append(req)
        for req in reversed(waiting):
            self._q.appendleft(req)
        for req in ready + expired:
            self.queued_bytes -= req.cost
        self._depth.set(len(self._q))
        return ready, expired

    def flush(self) -> List[Request]:
        """Dequeue everything, backoff windows included (the drain
        timeout answers these stragglers instead of abandoning them)."""
        out = list(self._q)
        self._q.clear()
        self.queued_bytes = 0
        self._depth.set(0)
        return out


class Quarantine:
    """Move poison inputs out of the watched directory into
    ``directory``, with ``<name>.reason.txt`` beside each naming the last
    error; counts ``serve_quarantined_total``."""

    def __init__(self, directory: str, registry=None,
                 tenant: Optional[str] = None):
        self.directory = directory
        if registry is None:
            from p2p_tpu_torch.obs import get_registry

            registry = get_registry()
        tags = {"tenant": tenant} if tenant else {}
        self._count = registry.counter("serve_quarantined_total", **tags)
        self._registry = registry

    @property
    def count(self) -> int:
        return int(self._count.value)

    def quarantine(self, path: str, reason: str = "") -> Optional[str]:
        """The new path, or None when the move failed (the file may have
        gone); never raises into the serving loop."""
        dest = os.path.join(self.directory, os.path.basename(path))
        try:
            os.makedirs(self.directory, exist_ok=True)
            shutil.move(path, dest)
        except OSError:
            return None
        self._count.inc()
        self._registry.record(
            {"kind": "quarantine", "file": dest, "reason": reason[:500]},
            force=True)
        if reason:
            try:
                with open(dest + ".reason.txt", "w") as f:
                    f.write(reason + "\n")
            except OSError:
                pass
        return dest
