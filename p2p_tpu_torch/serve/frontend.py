"""The request lifecycle shared by the directory and HTTP frontends
(counterpart of ``p2p_tpu/serve/frontend.py``): decode, then the engine,
then deliver.

One :class:`DispatchLoop` per tenant:

- a failed decode (a file still being copied in, injected ``decode``
  chaos, a body that is not a PNG) re-enters the queue with exponential
  backoff up to ``max_attempts``, then goes to the frontend's
  ``on_poison`` (the directory frontend quarantines the file, the HTTP
  frontend answers 422);
- a decoded group stacks into one host batch, is padded to a warmed
  bucket (``engine.infer_batch``), and its device prediction goes to the
  frontend's ``deliver``;
- every dispatch records its occupancy (real / bucket) in the
  ``serve_batch_occupancy`` histogram and its padding in
  ``serve_padded_images_total``, tenant-tagged.

Exactly one thread per tenant calls :meth:`DispatchLoop.dispatch` and
:meth:`DispatchLoop.drain`; producers feed the queue through the
batcher's lock (serve/batcher.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from p2p_tpu_torch.resilience.queue import Request

# serve_batch_occupancy bounds: sixteenths at the low end, eighths above
OCCUPANCY_BOUNDS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                    0.875, 1.0)


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """1, 2, 4, ... below ``max_batch``, then ``max_batch`` itself: a
    group of any size up to it pads to at most twice its images."""
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


class DispatchLoop:
    """Decode-retry, dispatch and occupancy accounting over ``queue``
    (a :class:`~p2p_tpu_torch.resilience.queue.BoundedRequestQueue`, or
    the :class:`~p2p_tpu_torch.serve.batcher.ContinuousBatcher` around
    one).

    Callbacks (the frontend's policy):

    - ``decode(req) -> np.ndarray`` raises on failure (retried);
    - ``deliver(reqs, pred, n_real)``: the device prediction, rows
      ``[:n_real]`` answering ``reqs`` in order;
    - ``on_poison(req, exc)``: ``max_attempts`` decodes failed;
    - ``on_expired(req)``: the deadline passed before dispatch;
    - ``on_retry_shed(req)``: a decode retry found the queue full;
    - ``on_engine_error(reqs, exc)``: the engine or ``deliver`` raised
      for the decoded group; None re-raises.
    """

    def __init__(self, engine, queue, *,
                 decode: Callable[[Request], np.ndarray],
                 deliver: Callable[[Sequence[Request], object, int], None],
                 on_poison: Callable[[Request, BaseException], None],
                 on_expired: Optional[Callable[[Request], None]] = None,
                 on_retry_shed: Optional[Callable[[Request], None]] = None,
                 on_engine_error=None, max_attempts: int = 3,
                 retry_delay_s: float = 1.0, registry=None,
                 tenant: Optional[str] = None,
                 group_cap: Optional[int] = None):
        self.engine = engine
        self.queue = queue
        self._decode = decode
        self._deliver = deliver
        self._on_poison = on_poison
        self._on_expired = on_expired
        self._on_retry_shed = on_retry_shed
        self._on_engine_error = on_engine_error
        self.max_attempts = max(1, int(max_attempts))
        self.retry_delay_s = retry_delay_s
        self.tenant = tenant
        # a group never exceeds the largest warmed bucket
        cap = engine.buckets[-1]
        self.group_cap = min(int(group_cap), cap) if group_cap else cap
        if registry is None:
            from p2p_tpu_torch.obs import get_registry

            registry = get_registry()
        self.registry = registry
        tags = {"tenant": tenant} if tenant else {}
        self._retries = registry.counter("retry_attempts_total",
                                         seam="decode", **tags)
        self._occupancy = registry.histogram(
            "serve_batch_occupancy", bounds=OCCUPANCY_BOUNDS, **tags)
        self._padded = registry.counter("serve_padded_images_total", **tags)
        self._batches = registry.counter("serve_batches_total", **tags)
        self.served = 0

    @property
    def decode_retries(self) -> int:
        return int(self._retries.value)

    @property
    def padded_images(self) -> int:
        return int(self._padded.value)

    @property
    def occupancy_mean(self) -> Optional[float]:
        """Mean bucket occupancy over every dispatch (None before the
        first)."""
        h = self._occupancy
        return (h.sum / h.count) if h.count else None

    def dispatch(self, group_reqs: Sequence[Request]) -> int:
        """One group: decode, engine, deliver. Returns the number of
        requests dispatched to the engine."""
        group = []
        for req in group_reqs:
            try:
                group.append((req, self._decode(req)))
            except Exception as e:
                req.attempts += 1
                if req.attempts >= self.max_attempts:
                    self._on_poison(req, e)
                else:
                    # the backoff lives in the queue: the loop never sleeps
                    delay = self.retry_delay_s * (2.0 ** (req.attempts - 1))
                    if self.queue.requeue(req, delay):
                        self._retries.inc()
                    elif self._on_retry_shed is not None:
                        self._on_retry_shed(req)
        if not group:
            return 0
        reqs = [r for r, _ in group]
        try:
            stack = np.stack([img for _, img in group])
            batch = {k: stack for k in self.engine.batch_keys}
            pred, _, n_real = self.engine.infer_batch(batch)
            bucket = int(pred.shape[0])
            self._occupancy.observe(n_real / bucket)
            self._padded.inc(bucket - n_real)
            self._batches.inc()
            self._deliver(reqs, pred, n_real)
        except BaseException as e:
            if self._on_engine_error is None:
                raise
            self._on_engine_error(reqs, e)
            return 0
        self.served += len(group)
        return len(group)

    def drain(self) -> int:
        """Dispatch everything dispatchable now (not in a backoff window);
        expired requests go to ``on_expired``. Returns requests
        dispatched."""
        n = 0
        while True:
            ready, expired = self.queue.take(self.group_cap)
            if self._on_expired is not None:
                for req in expired:
                    self._on_expired(req)
            if not ready:
                return n
            n += self.dispatch(ready)
