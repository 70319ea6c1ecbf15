"""VGG19 perceptual loss (counterpart of ``p2p_tpu/losses/perceptual.py``):
L1 between the five tap activations, in f32, weights 1/32, 1/16, 1/8, 1/4,
1, target side detached. Under a spatial mesh each mean is this rank's
share of the global one.

The JAX ``vgg_loss(params, x, y)`` runs VGG on both images; here the
target's taps come in as :func:`target_features`, so a train step that
compares two images against one target runs VGG on it once.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from p2p_tpu_torch.parallel.spatial import mean_of

VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def target_features(vgg: nn.Module, y: torch.Tensor) -> List[torch.Tensor]:
    """VGG taps of a target image, without a graph."""
    with torch.no_grad():
        return vgg(y)


def vgg_loss(vgg: nn.Module, x: torch.Tensor,
             y_feats: List[torch.Tensor]) -> torch.Tensor:
    """Perceptual distance between x and the target whose taps are
    ``y_feats``."""
    return perceptual_distance(vgg(x), y_feats)


def perceptual_distance(x_feats: List[torch.Tensor],
                        y_feats: List[torch.Tensor]) -> torch.Tensor:
    """:func:`vgg_loss` on the taps of both images."""
    total = x_feats[0].new_zeros((), dtype=torch.float32)
    for w, fx, fy in zip(VGG_SLICE_WEIGHTS, x_feats, y_feats):
        total = total + w * mean_of((fx.float() - fy.float()).abs(), fx)
    return total
