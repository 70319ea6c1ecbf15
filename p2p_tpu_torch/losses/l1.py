"""The pix2pix L1 term (counterpart of the ``lambda_l1`` term of
``p2p_tpu/train/step.py:195-202 make_g_loss_fn``)."""

from __future__ import annotations

import torch

from p2p_tpu_torch.parallel.spatial import mean_f32


def l1_loss(fake_b: torch.Tensor, real_b: torch.Tensor) -> torch.Tensor:
    """``mean(|fake_b − real_b|)``: the difference in the inputs' (train)
    dtype, the mean accumulated and returned in f32 (under a spatial mesh
    this rank's share of it)."""
    return mean_f32(torch.abs(fake_b - real_b), fake_b)
