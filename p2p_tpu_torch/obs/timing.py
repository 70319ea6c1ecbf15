"""Fenced step timing (counterpart of ``p2p_tpu/obs/timing.py``, whole):
the one img/s definition of the port.

:class:`StepTimer` measures wall-clock over fenced step boundaries two
ways that feed one accumulator:

- ``tick()`` per step, fenced on the step's outputs;
- ``chain()`` around K queued steps fenced once at the end, with the
  measured round trip of a trivial fetch (:func:`measure_rtt`)
  subtracted.

The fence is ``torch.cuda.synchronize`` where the fenced values lie on the
card, and nothing on the CPU, where every op has finished when it returns.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import torch

from p2p_tpu_torch.core.debug import tree_leaves

_PROBE: Optional[torch.Tensor] = None


def fence(tree: Any) -> None:
    """Wait until the work producing ``tree``'s card tensors is done (a
    no-op for CPU tensors)."""
    for d in {leaf.device for _, leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(d)


def measure_rtt() -> float:
    """Seconds of one trivial round trip: a one-element add on the card
    and its fetch to the host (on the CPU the add alone). The probe tensor
    is made once per process, outside the measured call."""
    global _PROBE
    if _PROBE is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        _PROBE = torch.ones((), device=dev)
    float(_PROBE + 1)              # warm the path
    t0 = time.perf_counter()
    float(_PROBE + 1)
    return time.perf_counter() - t0


class _Chain:
    """Handle yielded by :meth:`StepTimer.chain`; :meth:`fence` on a value
    of the last queued step waits for the whole chain."""

    def __init__(self):
        self.fenced = False

    def fence(self, value) -> None:
        fence(value)
        self.fenced = True


class StepTimer:
    """Wall-clock over fenced steps.

    Loop style, one fence a step::

        t = StepTimer(batch_size=64)
        for batch in data:
            state, m = step(state, batch)
            t.tick(m)
        t.images_per_sec

    Chained style, one fence for K steps::

        with t.chain(steps=K, rtt=measure_rtt()) as ch:
            for _ in range(K):
                state, m = step(state, batch)
            ch.fence(m["loss_g"])
    """

    def __init__(self, batch_size: int, skip_first: int = 1):
        self.batch_size = batch_size
        self.skip_first = skip_first       # warm-up intervals to discard
        self.intervals = 0                 # timed step intervals
        self.elapsed = 0.0
        self._seen = 0
        self._t0: Optional[float] = None

    def tick(self, fence_on=None) -> None:
        if fence_on is not None:
            fence(fence_on)
        now = time.perf_counter()
        if self._t0 is not None:
            self._seen += 1
            if self._seen > self.skip_first:
                self.elapsed += now - self._t0
                self.intervals += 1
        self._t0 = now

    @contextlib.contextmanager
    def chain(self, steps: int, rtt: float = 0.0):
        """Time a block of ``steps`` queued steps, fenced by the caller's
        ``ch.fence(...)``; the interval less ``rtt`` credits ``steps``
        intervals. An exit without a fence warns: the interval may then
        miss device time."""
        ch = _Chain()
        t0 = time.perf_counter()
        try:
            yield ch
        finally:
            dt = time.perf_counter() - t0
            if not ch.fenced:
                print("WARNING: StepTimer.chain exited without a fence — "
                      "the measured interval may exclude device time",
                      flush=True)
            self.elapsed += max(dt - rtt, 1e-9)
            self.intervals += steps

    def credit(self, steps: int, seconds: float) -> None:
        """Account an interval fenced elsewhere (e.g. a serving engine's
        dispatch-to-drain window) into the same accumulator."""
        self.elapsed += max(seconds, 1e-9)
        self.intervals += steps

    @property
    def images_per_sec(self) -> float:
        if self.elapsed <= 0 or self.intervals <= 0:
            return 0.0
        return self.batch_size * self.intervals / self.elapsed
