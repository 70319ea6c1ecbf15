"""Learning-rate schedules (counterpart of ``p2p_tpu/train/schedules.py``):
the reference's epoch-wise policies, expressed per step.

- ``lambda``  1 − max(0, e + epoch_count − niter)/(niter_decay + 1), ≥ 0
- ``step``    0.1^(e // lr_decay_iters)
- ``cosine``  0.5·(1 + cos(π·e/niter)), not clamped past ``niter``
- ``plateau`` 1 here; the scale lives on the host (:class:`PlateauController`)
  and multiplies every update (train/state.py ``TrainState.lr_scale``)

The multipliers are the JAX closed forms, fed to ``torch.optim.
lr_scheduler.LambdaLR``; torch's ``StepLR``, ``CosineAnnealingLR`` and
``ReduceLROnPlateau`` are recursive or threshold forms that do not equal
them. Only ``lambda`` reads ``epoch_count``, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable

from p2p_tpu_torch.core.config import OptimConfig

LR_POLICIES = ("lambda", "step", "cosine", "plateau")


def lambda_rule(epoch: int, epoch_count: int, niter: int,
                niter_decay: int) -> float:
    """The reference's multiplier ``1 − max(0, epoch + epoch_count −
    niter)/(niter_decay + 1)``, clamped at 0 (past ``niter + niter_decay``
    the reference formula turns negative)."""
    return max(0.0, 1.0 - max(0, epoch + epoch_count - niter)
               / float(niter_decay + 1))


def policy_multiplier(cfg: OptimConfig, epoch: int,
                      epoch_count: int = 1) -> float:
    """The multiplier of ``cfg.lr_policy`` at 0-based ``epoch``."""
    if cfg.lr_policy == "lambda":
        return lambda_rule(epoch, epoch_count, cfg.niter, cfg.niter_decay)
    if cfg.lr_policy == "step":
        return 0.1 ** (epoch // cfg.lr_decay_iters)
    if cfg.lr_policy == "cosine":
        return 0.5 * (1.0 + math.cos(math.pi * epoch / cfg.niter))
    if cfg.lr_policy == "plateau":
        return 1.0
    raise ValueError(f"unknown lr policy {cfg.lr_policy!r} (have "
                     f"{LR_POLICIES})")


def make_schedule(cfg: OptimConfig, steps_per_epoch: int,
                  epoch_count: int = 1) -> Callable[[int], float]:
    """``step → lr multiplier``, the form ``torch.optim.lr_scheduler.
    LambdaLR`` takes (the JAX function returns ``cfg.lr`` times it).
    ``epoch_count`` is the 1-based epoch label of step 0."""
    policy_multiplier(cfg, 0, epoch_count)    # an unknown policy raises here

    def schedule(step: int) -> float:
        return policy_multiplier(cfg, step // steps_per_epoch, epoch_count)

    return schedule


class PlateauController:
    """Host-side ReduceLROnPlateau with the reference's hyperparameters
    (mode min, factor 0.2, relative threshold 0.01, patience 5), fed one
    metric per epoch."""

    def __init__(self, factor: float = 0.2, threshold: float = 0.01,
                 patience: int = 5):
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.best = math.inf
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        """Feed one epoch's metric; returns the current lr scale."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale
