"""Spectral weight normalization (counterpart of
``p2p_tpu/ops/spectral_norm.py:36 spectral_normalize`` and ``:58
SpectralConv``, and of ``p2p_tpu/models/temporal_d.py:128
SpectralConv3D``).

One power-iteration step per call on the kernel viewed as (out, kh·kw·in),
the JAX package's column order; ``u`` is a buffer (the flax ``spectral``
collection) that a call in training mode advances in place, and ``u``/``v``
take no gradient, while σ = uᵀWv carries the gradient to W.

With ``int8`` (``p2p_tpu/ops/spectral_norm.py:91-160``) the power
iteration and the ``u`` update run exactly as in the plain path and only
the normalized kernel w/σ meets the int8 conv (ops/int8.py), in the three
forms of ``QuantConv``: dynamic, stored-scale (``int8_delayed``, an
``amax_x`` buffer) and the quantize-fused input ``epilogue``, whose tap
is the dequantized surrogate (:class:`~p2p_tpu_torch.ops.int8.QuantScale`
holds that plumbing for both).

A ``SpectralConv`` that holds its channel shard under a model mesh
(parallel/tp.py) all-reduces the power iteration's partial products and
norms over the model group: σ and ``u`` are the one-device values to
rounding, and ``u`` stays whole on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.core.mesh import spatial_mesh
from p2p_tpu_torch.ops.int8 import CONV_FORMS, QuantScale


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


class SpectralConv(QuantScale, nn.Module):
    """Zero-padded conv with spectral weight norm. Parameters ``weight``
    (OIHW) and ``bias``, buffer ``u`` (and ``amax_x`` with ``int8`` and
    ``int8_delayed``); ``dtype`` as in ops/conv.py. With ``epilogue_tap``
    the forward returns ``(y, tap)``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False,
                 epilogue: Optional[Callable] = None,
                 epilogue_tap: bool = False):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", l2normalize(torch.ones(features)))
        self.int8 = int8
        self._init_scale(int8 and int8_delayed, epilogue, epilogue_tap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        # (out, kh, kw, in) rows, as the flax HWIO kernel flattens
        w_mat = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        tp = getattr(self, "p2p_tp", None)
        if tp is not None:
            from p2p_tpu_torch.parallel.tp import tp_spectral_sigma

            sigma, u = tp_spectral_sigma(w_mat, self.u, tp)
        else:
            sigma, u, _ = spectral_normalize(w_mat, self.u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
        dt = self.dtype or torch.promote_types(x.dtype, w.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        if tp is not None and not self.int8:
            from p2p_tpu_torch.parallel.tp import tp_conv

            return tp_conv(tp, F.conv2d, x.to(dt), (w / sigma).to(dt), bias,
                           *self.p2p_tp_io, stride=self.stride,
                           padding=self.padding)
        if not self.int8:
            if spatial_mesh() is not None:
                from p2p_tpu_torch.parallel.spatial import conv_rows

                return conv_rows(x, (w / sigma).to(dt), bias, self.stride,
                                 self.padding, "zero", dt)
            return F.conv2d(x.to(dt), (w / sigma).to(dt), bias, self.stride,
                            self.padding)
        if spatial_mesh() is not None:
            raise NotImplementedError("the int8 spectral-norm conv has no "
                                      "form under a spatial mesh")
        y, tap = self.quant_conv(x, (w / sigma).to(dt), CONV_FORMS,
                                 (self.stride, self.stride), self.padding)
        if bias is not None and tp is None:     # else added by the TP form
            y = y + bias.to(y.dtype).view(1, -1, 1, 1)
        return (y, tap) if self.epilogue_tap else y


class SpectralConv3D(nn.Module):
    """3-D conv of (N, C, T, H, W) clips with spectral weight norm, k (3,
    4, 4), zero padding (1, 2, 2), stride (1, s, s). Parameters ``weight``
    (OIDHW) and ``bias``, buffer ``u``. The power iteration runs on the
    kernel as (out, kt·kh·kw·in) rows, the flax DHWIO kernel's order, and
    ``u`` advances in training mode only. ``dtype`` as in ops/conv.py: the
    input and w/σ are cast to it and the bias is added in the output's
    dtype after the conv, as flax adds it."""

    def __init__(self, in_channels: int, features: int, stride_hw: int = 2,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = (1, stride_hw, stride_hw)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 4,
                                               4))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", l2normalize(torch.ones(features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        w_mat = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)
        sigma, u, _ = spectral_normalize(w_mat, self.u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
        dt = self.dtype or torch.promote_types(x.dtype, w.dtype)
        from p2p_tpu_torch.parallel.temporal import sharded_temporal_conv3d

        y = sharded_temporal_conv3d(x.to(dt), (w / sigma).to(dt), None,
                                    self.stride[1], (1, 2, 2))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1, 1)
        return y
