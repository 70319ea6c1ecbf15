"""The one PatchGAN helper the generators use (counterpart of
``p2p_tpu/models/patchgan.py:39 avg_pool_downsample``); the
discriminators come with the training slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_downsample(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
