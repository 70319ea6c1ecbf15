"""Fault injection at named seams (counterpart of
``p2p_tpu/resilience/chaos.py:57-230``): the same spec grammar, the same
seeded firing sequence, the same ``P2P_CHAOS`` / ``P2P_CHAOS_SEED``
environment variables.

Spec grammar (comma-separated entries)::

    decode:0.5        fail seam 'decode' with probability 0.5
    decode@7          fail seam 'decode' exactly at "step" 7
    decode:0.5x3      as above, but at most 3 injected faults in all
    nan@50x3          fail seam 'nan' at steps 50, 51 and 52
    serve_write       fail seam 'serve_write' once

``seam@N`` compares against the step the seam reports; seams with no step
(``decode``, ``serve_write``) count their own calls, so ``decode@7`` is
the 7th decode of the process. A step-pinned entry's ``xM`` widens the
target to the range [N, N+M). Every injected fault raises
:class:`FaultInjected` (retryable under the default retry policy) and
counts ``chaos_injected_total{seam=...}``. Unarmed, :func:`chaos_point`
returns after one global check.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import threading
from typing import Dict, Optional

_ENV_VAR = "P2P_CHAOS"
_ENV_SEED_VAR = "P2P_CHAOS_SEED"

_ENTRY_RE = re.compile(
    r"^(?P<seam>[^:@]+?)"
    r"(?::(?P<prob>[0-9.eE+\-]+)|@(?P<step>\d+))?"
    r"(?:x(?P<cap>\d+))?$")

# seams that must fire on every host at the same step, so only a
# step-pinned spec is accepted for them (the JAX grammar's rule)
_STEP_PINNED_SEAMS = frozenset({"elastic"})


class FaultInjected(RuntimeError):
    """A fault planted by the chaos layer (always retryable)."""

    def __init__(self, seam: str, step: Optional[int] = None):
        self.seam = seam
        self.step = step
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"chaos: injected fault at seam {seam!r}{at}")


@dataclasses.dataclass
class SeamSpec:
    """Arming rule for one seam."""

    prob: float = 0.0                 # per-call failure probability
    at_step: Optional[int] = None     # fire exactly when step == at_step
    max_faults: Optional[int] = None  # stop injecting after this many
    fired: int = 0                    # injected so far
    calls: int = 0                    # chaos-point hits (the @N fallback)


def parse_spec(spec: str) -> Dict[str, SeamSpec]:
    """Parse the spec grammar above into ``{seam: SeamSpec}``."""
    out: Dict[str, SeamSpec] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if m is None:
            raise ValueError(f"bad chaos entry {entry!r}")
        seam = m.group("seam").strip()
        cap = int(m.group("cap")) if m.group("cap") else None
        if seam in _STEP_PINNED_SEAMS and m.group("step") is None:
            raise ValueError(
                f"chaos seam {seam!r} must be step-pinned (use "
                f"'{seam}@N' or '{seam}@NxM') (bad entry: {entry!r})")
        if m.group("step") is not None:
            out[seam] = SeamSpec(at_step=int(m.group("step")),
                                 max_faults=cap if cap else 1)
        elif m.group("prob") is not None:
            p = float(m.group("prob"))
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos probability out of [0,1]: {entry!r}")
            out[seam] = SeamSpec(prob=p, max_faults=cap)
        else:
            # bare seam name = always fail, once unless capped
            out[seam] = SeamSpec(prob=1.0, max_faults=cap if cap else 1)
    if not out:
        raise ValueError(f"empty chaos spec {spec!r}")
    return out


class ChaosMonkey:
    """Armed fault-injection state: seams, a seeded RNG, fired counts."""

    def __init__(self, seams: Dict[str, SeamSpec], seed: int = 0,
                 registry=None):
        self.seams = seams
        self._rng = random.Random(seed)
        self._registry = registry
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0,
                  registry=None) -> "ChaosMonkey":
        return cls(parse_spec(spec), seed=seed, registry=registry)

    def _reg(self):
        if self._registry is None:
            from p2p_tpu_torch.obs import get_registry

            self._registry = get_registry()
        return self._registry

    def counts(self) -> Dict[str, int]:
        return {name: s.fired for name, s in self.seams.items()}

    def maybe_fail(self, seam: str, step: Optional[int] = None) -> None:
        s = self.seams.get(seam)
        if s is None:
            return
        with self._lock:
            s.calls += 1
            if s.max_faults is not None and s.fired >= s.max_faults:
                return
            if s.at_step is not None:
                at = step if step is not None else s.calls
                span = s.max_faults if s.max_faults is not None else 1
                if not (s.at_step <= at < s.at_step + span):
                    return
            elif not (s.prob > 0.0 and self._rng.random() < s.prob):
                return
            s.fired += 1
        self._reg().counter("chaos_injected_total", seam=seam).inc()
        raise FaultInjected(seam, step)


_active: Optional[ChaosMonkey] = None
_env_checked = False
_lock = threading.Lock()


def install(monkey: Optional[ChaosMonkey]) -> Optional[ChaosMonkey]:
    """Arm ``monkey`` process-wide (None disarms); returns the previous
    one."""
    global _active, _env_checked
    with _lock:
        prev = _active
        _active = monkey
        _env_checked = monkey is not None
        return prev


def get_chaos() -> Optional[ChaosMonkey]:
    """The armed monkey (armed from ``P2P_CHAOS`` on first use), or
    None."""
    _maybe_arm_from_env()
    return _active


def _maybe_arm_from_env() -> None:
    """Arm from ``P2P_CHAOS`` once, on first use."""
    global _active, _env_checked
    if _env_checked:
        return
    with _lock:
        if _env_checked:
            return
        _env_checked = True
        spec = os.environ.get(_ENV_VAR)
        if spec:
            _active = ChaosMonkey.from_spec(
                spec, seed=int(os.environ.get(_ENV_SEED_VAR, "0")))


def chaos_point(seam: str, step: Optional[int] = None) -> None:
    """Mark a fault-injectable seam: a no-op unless a monkey is armed,
    which may then raise :class:`FaultInjected`."""
    _maybe_arm_from_env()
    m = _active
    if m is not None:
        m.maybe_fail(seam, step)
