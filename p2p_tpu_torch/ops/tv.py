"""Total-variation loss (counterpart of ``p2p_tpu/ops/tv.py:10``)."""

from __future__ import annotations

import torch


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic L1 TV of an (N, C, H, W) image, mean-reduced in f32:
    mean |∂x along W| + mean |∂x along H|."""
    x = x.float()
    dw = (x[:, :, :, :-1] - x[:, :, :, 1:]).abs().mean()
    dh = (x[:, :, :-1, :] - x[:, :, 1:, :]).abs().mean()
    return dw + dh
