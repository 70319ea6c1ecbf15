"""Multiscale feature matching (counterpart of
``p2p_tpu/losses/feature_matching.py``): L1 between every intermediate D
activation of fake and real (all but each scale's prediction map), in f32,
weighted ``4/(n_layers+1) · 1/num_D · lambda_feat``, real side detached.
Under a spatial mesh each mean is this rank's share of the global one."""

from __future__ import annotations

from typing import Sequence

import torch

from p2p_tpu_torch.parallel.spatial import mean_of


def feature_matching_loss(pred_fake: Sequence[Sequence[torch.Tensor]],
                          pred_real: Sequence[Sequence[torch.Tensor]],
                          n_layers: int = 3,
                          lambda_feat: float = 10.0) -> torch.Tensor:
    w = 4.0 / (n_layers + 1) * (1.0 / len(pred_fake))
    total = pred_fake[0][0].new_zeros((), dtype=torch.float32)
    for scale_f, scale_r in zip(pred_fake, pred_real):
        for f, r in zip(scale_f[:-1], scale_r[:-1]):
            diff = (f.float() - r.detach().float()).abs()
            total = total + w * mean_of(diff, f) * lambda_feat
    return total
