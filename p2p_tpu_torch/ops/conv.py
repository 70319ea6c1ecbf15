"""Convolution layers on channels_last (N, C, H, W) tensors (counterparts
of ``p2p_tpu/ops/conv.py:104 reflect_pad_2d``, ``:116 ConvLayer``, ``:452
upsample_nearest`` and ``:646 UpsampleConvLayer``).

Each layer is reflect pad + ``F.conv2d``, which PyTorch hands to cuDNN on
the card, as XLA computed these convolutions outside any Pallas kernel.
The JAX package's dispatch forms (``PatchesConv`` :253, ``ThinHeadConv``
:375 and ``_NearestUp2Conv`` :583, gated at ``_THIN_DISPATCH_MIN_PIXELS``
:76) are exact rewrites of this same convolution for the TPU's matrix
unit, with the same ``Conv_0/kernel`` parameters, so here they are this
one conv. Parameter names follow the flax tree (``conv`` holds
``Conv_0``), which keeps convert.py a direct mapping.

``dtype`` is flax's ``dtype=``: the conv's input, weight and bias are cast
to it (bf16 compute on f32 master weights in training); ``None`` computes
in the promoted type of input and weight.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cast_conv(conv: nn.Conv2d, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv(x)`` with input, weight and bias cast to ``dtype`` (or to the
    promoted type of x and the weight), with the conv's own stride and
    zero padding."""
    dt = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x.to(dt), conv.weight.to(dt), bias, conv.stride,
                    conv.padding)


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad H and W."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour ×factor upsample of H and W."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class ConvLayer(nn.Module):
    """ReflectionPad(k//2) + conv, no norm or activation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pad = kernel_size // 2
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              stride=stride, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cast_conv(self.conv, reflect_pad_2d(x, self.pad), self.dtype)


class UpsampleConvLayer(nn.Module):
    """Optional nearest ×upsample → ReflectionPad(k//2) → conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, upsample: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upsample = upsample
        self.pad = kernel_size // 2
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              stride=stride, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsample:
            x = upsample_nearest(x, self.upsample)
        return cast_conv(self.conv, reflect_pad_2d(x, self.pad), self.dtype)
