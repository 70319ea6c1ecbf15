"""Retry with exponential backoff and full jitter (counterpart of
``p2p_tpu/resilience/retry.py:39-133``): the same policy, delays for a
seed, classification and counters (``retry_attempts_total{seam=...}``,
``retry_exhausted_total{seam=...}``)."""

from __future__ import annotations

import dataclasses
import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

from p2p_tpu_torch.resilience.chaos import FaultInjected

# transient by default: OS/filesystem errors, timeouts and injected
# faults; ValueError and the like stay fatal
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    OSError, TimeoutError, FaultInjected,
)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape and give-up rules for one seam."""

    max_attempts: int = 4           # total tries (1 first try + 3 retries)
    base_delay: float = 0.05        # seconds before the first retry
    max_delay: float = 2.0          # per-retry backoff cap
    jitter: bool = True             # full jitter: delay ~ U(raw/2, raw]
    deadline: Optional[float] = None  # total wall-clock budget (seconds)
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def backoff(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        raw = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        if not self.jitter:
            return raw
        r = rng.random() if rng is not None else random.random()
        return raw * (0.5 + 0.5 * r)


DEFAULT_POLICY = RetryPolicy()
# checkpoint writes and reads: a slower backoff for filesystem blips
CKPT_POLICY = RetryPolicy(max_attempts=4, base_delay=0.2, max_delay=5.0)


def retry_call(fn: Callable, *args, policy: RetryPolicy = DEFAULT_POLICY,
               seam: str = "op", registry=None,
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic, **kwargs):
    """``fn(*args, **kwargs)``, retrying retryable failures up to
    ``policy.max_attempts`` tries (or its deadline); the last failure is
    re-raised unchanged."""
    if registry is None:
        from p2p_tpu_torch.obs import get_registry

        registry = get_registry()
    t0 = clock()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — classified below
            if not policy.is_retryable(exc):
                raise
            delay = policy.backoff(attempt, rng)
            out_of_attempts = attempt >= policy.max_attempts
            out_of_time = (policy.deadline is not None
                           and clock() - t0 + delay > policy.deadline)
            if out_of_attempts or out_of_time:
                registry.counter("retry_exhausted_total", seam=seam).inc()
                raise
            registry.counter("retry_attempts_total", seam=seam).inc()
            registry.record(
                {"kind": "retry", "seam": seam, "attempt": attempt,
                 "delay_sec": round(delay, 4), "error": repr(exc)})
            sleep(delay)


def retrying(policy: RetryPolicy = DEFAULT_POLICY, seam: str = "op",
             **retry_kw):
    """Decorator form of :func:`retry_call`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, seam=seam,
                              **retry_kw, **kwargs)

        return wrapped

    return deco
