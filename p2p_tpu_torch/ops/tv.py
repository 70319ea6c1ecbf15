"""Total-variation loss (counterpart of ``p2p_tpu/ops/tv.py:10``)."""

from __future__ import annotations

import torch

from p2p_tpu_torch.core.mesh import spatial_mesh


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic L1 TV of an (N, C, H, W) image, mean-reduced in f32:
    mean |∂x along W| + mean |∂x along H|; under a spatial mesh this
    rank's share of it (parallel/spatial.py ``tv_rows``)."""
    if spatial_mesh() is not None:
        from p2p_tpu_torch.parallel.spatial import tv_rows

        return tv_rows(x)
    x = x.float()
    dw = (x[:, :, :, :-1] - x[:, :, :, 1:]).abs().mean()
    dh = (x[:, :, :-1, :] - x[:, :, 1:, :]).abs().mean()
    return dw + dh
