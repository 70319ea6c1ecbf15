"""The pix2pix L1 term (counterpart of the ``lambda_l1`` term of
``p2p_tpu/train/step.py:195-202 make_g_loss_fn``)."""

from __future__ import annotations

import torch


def l1_loss(fake_b: torch.Tensor, real_b: torch.Tensor) -> torch.Tensor:
    """``mean(|fake_b − real_b|)``: the difference in the inputs' (train)
    dtype, the mean accumulated and returned in f32."""
    return torch.mean(torch.abs(fake_b - real_b), dtype=torch.float32)
