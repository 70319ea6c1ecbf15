"""Adversarial losses (counterpart of ``p2p_tpu/losses/gan.py:23-58``):
LSGAN (the default), vanilla (BCE with logits) or hinge on the LAST
prediction map of each scale, in f32, summed over the scales. Under a
spatial mesh each mean is this rank's share of the global one
(parallel/spatial.py ``mean_of``): the D's maps have uneven rows, so a
mean of the ranks' means would be another number."""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn.functional as F

from p2p_tpu_torch.parallel.spatial import mean_of

Preds = Union[Sequence[torch.Tensor], Sequence[Sequence[torch.Tensor]]]


def _final_preds(preds: Preds) -> List[torch.Tensor]:
    if isinstance(preds[0], (list, tuple)):
        return [scale[-1] for scale in preds]
    return [preds[-1]]


def _elementwise(pred: torch.Tensor, target_is_real: bool, mode: str,
                 for_discriminator: bool) -> torch.Tensor:
    p = pred.float()
    target = 1.0 if target_is_real else 0.0
    if mode == "lsgan":
        return mean_of((p - target) ** 2, pred)
    if mode == "vanilla":
        return mean_of(torch.clamp_min(p, 0) - p * target
                       + torch.log1p(torch.exp(-p.abs())), pred)
    if mode == "hinge":
        if for_discriminator:
            return mean_of(F.relu(1.0 - p), pred) if target_is_real \
                else mean_of(F.relu(1.0 + p), pred)
        return -mean_of(p, pred)
    raise ValueError(f"unknown gan mode {mode!r}")


def gan_loss(preds: Preds, target_is_real: bool, mode: str = "lsgan",
             for_discriminator: bool = True) -> torch.Tensor:
    """Sum of the per-scale losses on each scale's final prediction map."""
    return torch.stack([
        _elementwise(p, target_is_real, mode, for_discriminator)
        for p in _final_preds(preds)]).sum()
