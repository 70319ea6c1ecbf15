"""Graceful shutdown on SIGTERM/SIGINT (counterpart of
``p2p_tpu/resilience/preempt.py:50-176``, the single-process part of
``PreemptionGuard``): the handlers only set a flag and run the flush
hooks; the serving loop (``serve/server.run_server``) polls
:attr:`PreemptionGuard.requested` and drains. A second signal restores
the old handler and re-delivers it, so a wedged process can still be
killed. Not ported yet: the multi-host ``should_stop`` agreement and the
train loop's exit code 75."""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, List, Optional


class PreemptionGuard:
    """Signal → flag. ``install()`` sets real handlers (main thread only);
    :meth:`request` sets the flag from code (tests, an embedding
    program)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, registry=None):
        self._registry = registry
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

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signum(self) -> Optional[int]:
        return self._signum
