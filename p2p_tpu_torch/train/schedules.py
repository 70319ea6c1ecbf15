"""Learning-rate schedule (counterpart of ``p2p_tpu/train/schedules.py``
``lambda_rule`` and ``make_schedule``), the ``"lambda"`` policy only: the
reference's linear decay, stepped per epoch and expressed per step."""

from __future__ import annotations

from typing import Callable

from p2p_tpu_torch.core.config import OptimConfig


def lambda_rule(epoch: int, epoch_count: int, niter: int,
                niter_decay: int) -> float:
    """The reference's multiplier ``1 − max(0, epoch + epoch_count −
    niter)/(niter_decay + 1)``, clamped at 0 (past ``niter + niter_decay``
    the reference formula turns negative)."""
    return max(0.0, 1.0 - max(0, epoch + epoch_count - niter)
               / float(niter_decay + 1))


def make_schedule(cfg: OptimConfig, steps_per_epoch: int,
                  epoch_count: int = 1) -> Callable[[int], float]:
    """``step → lr multiplier``, the form ``torch.optim.lr_scheduler.
    LambdaLR`` takes (the JAX function returns ``cfg.lr`` times it).
    ``epoch_count`` is the 1-based epoch label of step 0."""
    if cfg.lr_policy != "lambda":
        raise NotImplementedError(
            f"lr_policy {cfg.lr_policy!r} is not ported (have 'lambda')")

    def schedule(step: int) -> float:
        return lambda_rule(step // steps_per_epoch, epoch_count, cfg.niter,
                           cfg.niter_decay)

    return schedule
