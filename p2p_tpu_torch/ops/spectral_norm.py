"""Spectral weight normalization (counterpart of
``p2p_tpu/ops/spectral_norm.py:36 spectral_normalize`` and ``:58
SpectralConv``).

One power-iteration step per call on the kernel viewed as (out, kh·kw·in),
the JAX package's column order; ``u`` is a buffer (the flax ``spectral``
collection) that a call in training mode advances in place, and ``u``/``v``
take no gradient, while σ = uᵀWv carries the gradient to W.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def spectral_normalize(w_mat: torch.Tensor, u: torch.Tensor,
                       n_iter: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power iteration on ``w_mat`` (rows, cols) from the left singular
    vector estimate ``u``; returns (σ, new u, new v)."""
    wm = w_mat.detach()
    v = None
    for _ in range(n_iter):
        v = l2normalize(wm.t() @ u)
        u = l2normalize(wm @ v)
    sigma = u @ w_mat @ v
    return sigma, u, v


class SpectralConv(nn.Module):
    """Zero-padded conv with spectral weight norm. Parameters ``weight``
    (OIHW) and ``bias``, buffer ``u``; ``dtype`` as in ops/conv.py."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", l2normalize(torch.ones(features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        # (out, kh, kw, in) rows, as the flax HWIO kernel flattens
        w_mat = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        sigma, u, _ = spectral_normalize(w_mat, self.u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
        dt = self.dtype or torch.promote_types(x.dtype, w.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), (w / sigma).to(dt), bias, self.stride,
                        self.padding)
