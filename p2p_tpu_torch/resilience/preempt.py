"""Graceful shutdown on SIGTERM/SIGINT (counterpart of
``p2p_tpu/resilience/preempt.py``, its single-process part): the handlers
only set a flag and run the flush hooks; the serving loop
(``serve/server.run_server``) polls :attr:`PreemptionGuard.requested` and
drains, the train loop polls :meth:`PreemptionGuard.should_stop` at step
boundaries, saves an exact-step checkpoint with its iterator sidecar and
raises :class:`Preempted`, which ``cli/train.py`` turns into
:data:`PREEMPTED_EXIT_CODE` (75, ``EX_TEMPFAIL``: "re-run me"). A second
signal restores the old handler and re-delivers it, so a wedged process
can still be killed. On more than one process ``should_stop`` agrees: every
``sync_every``-th poll is one all-reduce MAX of the flag over the default
group, so every rank stops (saves, exits 75) at the same step even when
one alone was signalled; one process polls its own flag."""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, List, Optional

#: Exit code meaning "preempted after a clean checkpoint — resume me".
#: 75 is BSD EX_TEMPFAIL ("temporary failure; user is invited to retry").
PREEMPTED_EXIT_CODE = 75


class Preempted(RuntimeError):
    """Raised by the train loop after a preemption-triggered save."""

    def __init__(self, step: int, signum: Optional[int] = None):
        self.step = step
        self.signum = signum
        name = signal.Signals(signum).name if signum else "request"
        super().__init__(
            f"preempted ({name}): checkpoint saved at step {step}")


class PreemptionGuard:
    """Signal → flag. ``install()`` sets real handlers (main thread only);
    :meth:`request` sets the flag from code (tests, an embedding
    program)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, registry=None, sync_every: int = 16):
        self._registry = registry
        # the polls between two agreements of the processes
        self.sync_every = max(1, int(sync_every))
        self._polls = 0
        self._requested = False
        self._signum: Optional[int] = None
        self._old = {}
        self._installed = False
        self._flush_hooks: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def _reg(self):
        if self._registry is None:
            from p2p_tpu_torch.obs import get_registry

            self._registry = get_registry()
        return self._registry

    def add_flush_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` when a signal arrives (errors are swallowed: a
        broken flush must not eat the flag)."""
        with self._lock:
            self._flush_hooks.append(fn)

    def install(self) -> "PreemptionGuard":
        """Install the SIGTERM/SIGINT handlers (idempotent)."""
        if self._installed:
            return self
        for s in self.SIGNALS:
            self._old[s] = signal.signal(s, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the handlers from before :meth:`install`."""
        if not self._installed:
            return
        for s, old in self._old.items():
            try:
                signal.signal(s, old)
            except (ValueError, TypeError):
                pass
        self._old.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handler(self, signum, frame) -> None:
        if self._requested:
            # the second signal: hand it to the old disposition
            signal.signal(signum, self._old.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        self._signum = signum
        self._requested = True
        # the counter and the hooks take locks the interrupted main thread
        # may hold; a helper thread waits for them safely
        threading.Thread(target=self._signal_side_effects, args=(signum,),
                         name="p2p-preempt-flush", daemon=False).start()

    def _signal_side_effects(self, signum) -> None:
        try:
            self._reg().counter("preemptions_total",
                                signal=signal.Signals(signum).name).inc()
        except Exception:
            pass
        with self._lock:
            hooks = list(self._flush_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass

    def request(self, signum: Optional[int] = None) -> None:
        """Set the flag programmatically."""
        self._signum = signum
        self._requested = True

    def should_stop(self) -> bool:
        """Poll at a step boundary. One process: the local flag. More: the
        flag agreed over the default group every ``sync_every``-th poll
        (False in between); every process calls this once a step, so the
        collectives line up (``p2p_tpu/resilience/preempt.py:176``)."""
        from p2p_tpu_torch.core.mesh import collective_device, process_count

        if process_count() == 1:
            return self._requested
        self._polls += 1
        if self._polls % self.sync_every:
            return False
        import torch
        import torch.distributed as dist

        flag = torch.tensor([1 if self._requested else 0],
                            dtype=torch.int32, device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed and not self._requested:
            self._requested = True      # a peer was signalled
        return agreed

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signum(self) -> Optional[int]:
        return self._signum
