"""Continuous cross-request batching (counterpart of
``p2p_tpu/serve/batcher.py:38-166``).

Requests are admitted the moment they arrive (the HTTP handler threads
feed one bounded queue through a condition lock), and the tenant's
dispatch thread forms a group at every tick:

- loaded (queue ≥ group_cap): a full largest-bucket group, now;
- under-full: linger up to ``linger_s`` from the OLDEST queued request,
  letting stragglers join;
- linger over: the largest FULL bucket that fits the queue (the rest
  follows at once in a smaller bucket), so only a depth below the
  smallest bucket pads.

Shedding, deadlines and backoff are the queue's; occupancy accounting is
the dispatch loop's (serve/frontend.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

from p2p_tpu_torch.resilience.queue import BoundedRequestQueue, Request


class ContinuousBatcher:
    """Thread-safe admission and bucket-aware group formation. One
    consumer calls :meth:`next_group`/:meth:`take`; any number of
    producers call :meth:`submit`/:meth:`submit_request`."""

    def __init__(self, queue: BoundedRequestQueue, buckets: Sequence[int],
                 group_cap: Optional[int] = None, linger_s: float = 0.05,
                 clock=time.monotonic):
        self.queue = queue
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets {self.buckets}")
        cap = self.buckets[-1]
        self.group_cap = min(int(group_cap), cap) if group_cap else cap
        self.linger_s = max(0.0, float(linger_s))
        self._clock = clock
        self._cond = threading.Condition()
        self._closed = False

    def submit(self, name: str, payload: Any = None) -> Optional[Request]:
        """Admit a fresh request; None = shed (queue full) or closed
        (draining)."""
        with self._cond:
            if self._closed:
                return None
            req = self.queue.offer(name, payload=payload)
            if req is not None:
                self._cond.notify()
            return req

    def submit_request(self, req: Request) -> Optional[Request]:
        """Admit a caller-built request; the contract of :meth:`submit`."""
        with self._cond:
            if self._closed:
                return None
            out = self.queue.offer_request(req)
            if out is not None:
                self._cond.notify()
            return out

    def requeue(self, req: Request, delay_s: float = 0.0) -> bool:
        """Decode-retry re-entry, locked against the producers."""
        with self._cond:
            ok = self.queue.requeue(req, delay_s)
            if ok:
                self._cond.notify()
            return ok

    def take(self, n: int) -> Tuple[List[Request], List[Request]]:
        """The queue's ``take``, locked (the drain path)."""
        with self._cond:
            return self.queue.take(n)

    def flush(self) -> List[Request]:
        """The queue's ``flush``, locked (the drain timeout)."""
        with self._cond:
            return self.queue.flush()

    def __len__(self) -> int:
        with self._cond:
            return len(self.queue)

    def close(self) -> None:
        """Stop admitting (drain): submits return None, and a blocked
        :meth:`next_group` wakes and hands back what is dispatchable."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def _group_size(self, now: float) -> Tuple[int, Optional[float]]:
        """(size, wait): size > 0 = dispatch that many now; else ``wait``
        is the time until the linger ends (None = queue empty). Called
        under the condition."""
        n = len(self.queue)
        if n == 0:
            return 0, None
        if n >= self.group_cap:
            return self.group_cap, None
        oldest = self.queue.oldest_enqueued_at()
        waited = now - (oldest if oldest is not None else now)
        if waited >= self.linger_s:
            full = [b for b in self.buckets if b <= n]
            return (full[-1] if full else n), None
        return 0, self.linger_s - waited

    def next_group(self, timeout: float = 0.1
                   ) -> Tuple[List[Request], List[Request]]:
        """Block until a group is ready or ``timeout`` passes; returns
        ``(ready, expired)``, either possibly empty. When everything
        queued sits in a backoff window it waits instead of spinning."""
        deadline = self._clock() + max(0.0, timeout)
        with self._cond:
            while not self._closed:
                now = self._clock()
                size, linger_wait = self._group_size(now)
                if size > 0:
                    ready, expired = self.queue.take(size)
                    if ready or expired:
                        return ready, expired
                    linger_wait = max(self.linger_s, 0.01)
                remaining = deadline - now
                if remaining <= 0:
                    return [], []
                wait = (remaining if linger_wait is None
                        else min(remaining, linger_wait))
                self._cond.wait(max(wait, 1e-3))
            # closed: what is dispatchable now, so the drain can finish
            return self.queue.take(self.group_cap)
