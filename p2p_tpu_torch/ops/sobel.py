"""Sobel edge magnitude and the angular loss (counterpart of
``p2p_tpu/ops/sobel.py:24 sobel_edges`` and ``:40 angular_loss``), on
(N, C, H, W) tensors, channels_last or not.

- :func:`sobel_edges`: the two fixed 3×3 Sobel filters on channel 0, a
  zero-padded ("SAME") cross-correlation in f32, magnitude
  ``sqrt(gx² + gy² + 1e-12)`` (the ε keeps the gradient finite on flat
  regions, where gx = gy = 0). The filters are applied as sums of shifted
  slices (each filter is [1, 2, 1] across one axis times [1, 0, −1] along
  the other), not as a convolution: on the card cuDNN would run an f32
  convolution in TF32 under PyTorch's default ``cudnn.allow_tf32``, in
  the forward and the backward alike, while these sums are f32 in both;
- :func:`angular_loss`: the mean angle in degrees between per-pixel
  channel vectors, ``acos`` of their cosine, with ``1e-12`` under both
  norms' square roots, the product of the norms floored at ``1e-8`` and
  the cosine clamped to ±0.99999.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from p2p_tpu_torch.core.dtypes import at_least_f32


def sobel_edges(img: torch.Tensor) -> torch.Tensor:
    """Edge magnitude of channel 0: (N, C, H, W) → (N, 1, H, W) in f32
    (f64 for an f64 input). gx's filter is the JAX ``_SOBEL_X``
    ((1, 0, −1), (2, 0, −2), (1, 0, −1)) and gy's its transpose
    ``_SOBEL_Y``, as cross-correlations."""
    x = at_least_f32(img[:, :1])
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    rows = p[:, :, :h] + 2.0 * p[:, :, 1:h + 1] + p[:, :, 2:]   # (h, w+2)
    cols = p[..., :w] + 2.0 * p[..., 1:w + 1] + p[..., 2:]      # (h+2, w)
    gx = rows[..., :w] - rows[..., 2:]
    gy = cols[:, :, :h] - cols[:, :, 2:]
    return torch.sqrt(gx.square() + gy.square() + 1e-12)


def angular_loss(illum_gt: torch.Tensor, illum_pred: torch.Tensor
                 ) -> torch.Tensor:
    """Mean angular error in degrees between the channel vectors (dim 1)
    of two (N, C, H, W) tensors, computed in f32 (f64 for f64 inputs)."""
    a = at_least_f32(illum_gt)
    b = at_least_f32(illum_pred)
    dot = (a * b).sum(dim=1)
    na = torch.sqrt((a * a).sum(dim=1) + 1e-12)
    nb = torch.sqrt((b * b).sum(dim=1) + 1e-12)
    cos = dot / torch.clamp_min(na * nb, 1e-8)
    cos = torch.clamp(cos, -0.99999, 0.99999)
    return torch.acos(cos).mean() * (180.0 / math.pi)
