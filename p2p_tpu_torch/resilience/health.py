"""Training health (counterpart of ``p2p_tpu/resilience/health.py``,
whole): the divergence sentinel, the recovery ladder and the facade the
trainer wires in. Pure host logic, so every decision equals the JAX
module's on the same metric stream (tests/test_torch_health.py).

- :class:`DivergenceSentinel` classifies each step's host metrics
  ``healthy`` / ``spiking`` / ``diverged``: a spike is a robust z-score
  (median/MAD over the last ``window`` healthy steps, EWMA-recentered)
  above ``spike_zscore``; a non-finite value is diverged on sight. The
  trainer feeds it one step late (train/loop.py), from a pinned host
  buffer the step's metrics were copied into without a fence.
- :class:`RecoveryLadder`: rung 1 skip (the in-step guard of
  ``train/step.py`` already dropped a non-finite step's update), rung 2
  LR cooldown (``cooldown_factor`` for ``cooldown_steps`` steps), rung 3
  rollback to the last eval-validated (``mark_good``) checkpoint on a
  perturbed shuffle; past ``max_rollbacks`` it raises
  :class:`DivergenceError`, which ``cli/train.py`` turns into
  :data:`DIVERGED_EXIT_CODE` (76), distinct from preemption's 75.

Every rung counts on the registry (``health_spikes_total``,
``health_skips_total``, ``health_cooldowns_total``,
``health_rollbacks_total``) and logs a ``kind="health"`` record. The
``nan`` chaos seam (``P2P_CHAOS=nan@50x3``: steps 50..52) poisons the
observed losses to rehearse the ladder.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterable, Optional

# Exit code for "training diverged and the recovery ladder is exhausted".
# 75 (preemption) means "relaunch me"; 76 means "do NOT blindly relaunch —
# the run rolled back max_rollbacks times and diverged again every time".
DIVERGED_EXIT_CODE = 76

HEALTHY = "healthy"
SPIKING = "spiking"
DIVERGED = "diverged"

# Metric keys the sentinel watches when present in a step's metrics.
DEFAULT_WATCH = ("loss_g", "loss_d", "loss_dt", "loss_c",
                 "grad_norm_g", "grad_norm_d")


def poison_nan_observation(step: int,
                           metrics: Dict[str, float]) -> Dict[str, float]:
    """Apply the ``nan`` chaos seam to one step's HOST metrics (the train
    loop's delayed read): ``loss_g`` becomes NaN where the seam fires.
    Returns the (possibly poisoned) metrics."""
    from p2p_tpu_torch.resilience.chaos import FaultInjected, chaos_point

    try:
        chaos_point("nan", step=step)
    except FaultInjected:
        metrics = dict(metrics)
        metrics["loss_g"] = float("nan")
    return metrics


class DivergenceError(RuntimeError):
    """The recovery ladder is exhausted: the run rolled back
    ``max_rollbacks`` times (or had no checkpoint to roll back to) and
    diverged again. Carries the step for the postmortem."""

    def __init__(self, step: int, rollbacks: int, reason: str = ""):
        self.step = int(step)
        self.rollbacks = int(rollbacks)
        msg = (f"training diverged at step {step} after {rollbacks} "
               f"rollback(s); recovery ladder exhausted")
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)


class _RobustWindow:
    """Robust z-score over the last K healthy observations of ONE series.

    Median/MAD over a deque of K values (K is small — tens), recentered
    by an EWMA so a slow level drift (losses decay over training) does
    not read as a spike. Spiking values are EXCLUDED from the window —
    one blowup must not inflate the MAD and mask the next one.
    """

    def __init__(self, window: int, alpha: float):
        self.vals: deque = deque(maxlen=max(4, window))
        self.alpha = alpha
        self.ewma: Optional[float] = None

    def zscore(self, x: float) -> Optional[float]:
        """Robust z of ``x`` against the window; None until warmed up."""
        if len(self.vals) < max(4, self.vals.maxlen // 4):
            return None
        s = sorted(self.vals)
        n = len(s)
        med = (s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2]))
        mad = sorted(abs(v - med) for v in s)[n // 2]
        # 1.4826·MAD ≈ σ for a normal; floor keeps a flat window (MAD=0,
        # e.g. a constant loss) from turning ulp noise into infinite z
        sigma = max(1.4826 * mad, 1e-6 * max(abs(med), 1.0), 1e-12)
        center = med if self.ewma is None else 0.5 * (med + self.ewma)
        return (x - center) / sigma

    def push(self, x: float) -> None:
        self.vals.append(x)
        self.ewma = (x if self.ewma is None
                     else self.ewma + self.alpha * (x - self.ewma))


class DivergenceSentinel:
    """Classify each observed step ``healthy`` / ``spiking`` / ``diverged``
    from windowed loss statistics (EWMA + robust z-score per watched key).
    """

    def __init__(self, window: int = 32, spike_zscore: float = 6.0,
                 ewma_alpha: float = 0.1,
                 watch: Iterable[str] = DEFAULT_WATCH):
        self.window = int(window)
        self.spike_zscore = float(spike_zscore)
        self.watch = tuple(watch)
        self._alpha = float(ewma_alpha)
        self._series: Dict[str, _RobustWindow] = {}

    def reset(self) -> None:
        """Drop all windowed state (after a rollback: the restored regime's
        statistics are the pre-divergence ones, not the blowup's)."""
        self._series.clear()

    def classify(self, metrics: Dict[str, float]) -> str:
        """Classify one step's host metrics and absorb them into the
        windows. ``metrics`` keys outside the watch list are ignored."""
        status = HEALTHY
        worst_key, worst_z = None, 0.0
        for k in self.watch:
            v = metrics.get(k)
            if v is None:
                continue
            v = float(v)
            if not math.isfinite(v):
                self._last = (k, float("inf"))
                return DIVERGED
            w = self._series.get(k)
            if w is None:
                w = self._series[k] = _RobustWindow(self.window, self._alpha)
            z = w.zscore(v)
            if z is not None and abs(z) > self.spike_zscore:
                status = SPIKING
                if abs(z) > abs(worst_z):
                    worst_key, worst_z = k, z
                continue  # spike values stay out of the window
            w.push(v)
        self._last = (worst_key, worst_z)
        return status

    @property
    def last_spike(self):
        """(key, z) of the worst offender in the latest classification."""
        return getattr(self, "_last", (None, 0.0))


class RecoveryLadder:
    """Bounded escalation: skip → cooldown → rollback → give up.

    Pure host-side state machine: :meth:`on_status` maps a sentinel
    classification to an action for the trainer (``None`` / ``"skip"`` /
    ``"cooldown"`` / ``"rollback"``), raising :class:`DivergenceError`
    past the rollback budget. The trainer owns executing the action; the
    ladder owns pacing, counters, and the cooldown's LR multiplier.
    """

    def __init__(self, cooldown_steps: int = 20, cooldown_factor: float = 0.1,
                 max_rollbacks: int = 3, reset_after: int = 16,
                 registry=None, logger=None):
        self.cooldown_steps = int(cooldown_steps)
        self.cooldown_factor = float(cooldown_factor)
        self.max_rollbacks = int(max_rollbacks)
        self.reset_after = int(reset_after)
        self._registry = registry
        self._logger = logger
        self.level = 0            # rungs climbed in the current episode
        self.rollbacks = 0        # lifetime rollbacks performed
        self.healthy_streak = 0
        self._cooldown_left = 0
        self.rollback_pending = False

    def _reg(self):
        if self._registry is None:
            from p2p_tpu_torch.obs import get_registry

            self._registry = get_registry()
        return self._registry

    def _log(self, rec: Dict) -> None:
        if self._logger is not None:
            self._logger.log({"kind": "health", **rec}, force=True)

    @property
    def lr_multiplier(self) -> float:
        """The cooldown's LR factor while active, 1.0 otherwise — the
        trainer folds this into ``TrainState.lr_scale`` alongside the
        plateau controller's scale."""
        return self.cooldown_factor if self._cooldown_left > 0 else 1.0

    def on_status(self, status: str, step: int,
                  detail: Optional[Dict] = None) -> Optional[str]:
        if status == HEALTHY:
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
                if self._cooldown_left == 0:
                    self._log({"event": "cooldown_end", "step": int(step)})
            self.healthy_streak += 1
            if self.level and self.healthy_streak >= self.reset_after:
                self.level = 0
                self._log({"event": "ladder_reset", "step": int(step)})
            return None

        # unhealthy: escalate one rung per event
        self.healthy_streak = 0
        self._reg().counter("health_spikes_total", status=status).inc()
        rec = {"event": status, "step": int(step), "rung": self.level + 1}
        if detail:
            rec.update(detail)
        self.level += 1
        if self.level == 1:
            # rung 1 — skip: a non-finite step's update was already
            # dropped by the in-step guard; a finite z-spike's single bad
            # update is absorbed. Record, count, carry on.
            self._reg().counter("health_skips_total").inc()
            self._log({**rec, "action": "skip"})
            return "skip"
        if self.level == 2:
            self._cooldown_left = self.cooldown_steps
            self._reg().counter("health_cooldowns_total").inc()
            self._log({**rec, "action": "cooldown",
                       "factor": self.cooldown_factor,
                       "steps": self.cooldown_steps})
            return "cooldown"
        # rung 3 — rollback (the trainer performs it, then calls
        # note_rollback_done); past the budget: give up, distinctly.
        if self.rollbacks >= self.max_rollbacks:
            self._log({**rec, "action": "giveup",
                       "rollbacks": self.rollbacks})
            raise DivergenceError(step, self.rollbacks,
                                  "max_rollbacks exhausted")
        self.rollback_pending = True
        self._log({**rec, "action": "rollback"})
        return "rollback"

    def note_rollback_done(self, step: int, target_step: int) -> None:
        """The trainer restored ``target_step``: count it, re-arm a
        post-rollback cooldown (the restored state re-enters the exact
        regime that diverged — give it a gentler LR runway), and reset
        the episode."""
        self.rollbacks += 1
        self.rollback_pending = False
        self.level = 0
        self.healthy_streak = 0
        self._cooldown_left = self.cooldown_steps
        self._reg().counter("health_rollbacks_total").inc()
        self._log({"event": "rollback_done", "step": int(step),
                   "target_step": int(target_step),
                   "rollbacks": self.rollbacks})


class TrainingHealth:
    """The facade both trainers wire in: sentinel + ladder + bookkeeping.

    ``observe(step, metrics)`` feeds one step's HOST metrics through the
    sentinel and the ladder and returns the ladder's action (or None).
    A non-finite in-step guard verdict (``metrics["health_ok"] == 0``)
    counts as a skip even when the watched losses were themselves finite.
    """

    def __init__(self, hcfg, registry=None, logger=None):
        self.cfg = hcfg
        self.sentinel = DivergenceSentinel(
            window=hcfg.window, spike_zscore=hcfg.spike_zscore,
            ewma_alpha=hcfg.ewma_alpha)
        self.ladder = RecoveryLadder(
            cooldown_steps=hcfg.cooldown_steps,
            cooldown_factor=hcfg.cooldown_factor,
            max_rollbacks=hcfg.max_rollbacks,
            reset_after=hcfg.reset_after,
            registry=registry, logger=logger)
        self._registry = registry

    @property
    def rollback_pending(self) -> bool:
        return self.ladder.rollback_pending

    @property
    def lr_multiplier(self) -> float:
        return self.ladder.lr_multiplier

    def observe(self, step: int, metrics: Dict[str, float]) -> Optional[str]:
        status = self.sentinel.classify(metrics)
        ok = metrics.get("health_ok")
        if status == HEALTHY and ok is not None and float(ok) == 0.0:
            # the in-step guard skipped (non-finite grads/losses inside the
            # step) even though the fetched metric values read finite
            status = DIVERGED
        detail = None
        if status != HEALTHY:
            key, z = self.sentinel.last_spike
            if key:
                detail = {"metric": key}
                if math.isfinite(z):  # diverged = non-finite value, no z
                    detail["zscore"] = round(float(z), 3)
        return self.ladder.on_status(status, step, detail)

    def after_rollback(self, step: int, target_step: int) -> None:
        self.sentinel.reset()
        self.ladder.note_rollback_done(step, target_step)

    def summary(self) -> Dict[str, float]:
        reg = self.ladder._reg()
        return {
            "health_spikes_total": reg.total("health_spikes_total"),
            "health_skips_total": reg.total("health_skips_total"),
            "health_cooldowns_total": reg.total("health_cooldowns_total"),
            "health_rollbacks_total": reg.total("health_rollbacks_total"),
            "rollbacks": self.ladder.rollbacks,
        }
