"""ResNet generator (counterpart of ``p2p_tpu/models/resnet_gen.py``
``ResnetBlock`` and ``ResnetGenerator``).

c7s1-ngf → ``n_downsampling`` stride-2 k3 convs → ``n_blocks`` residual
blocks → as many nearest-resize k3 convs up → c7s1-out, tanh. Every conv is
reflection-padded and followed by the norm epilogue; the classic
ResnetBlock has NO activation after its residual add. Convs in front of a
mean-subtracting norm carry no bias (it would cancel exactly), as in the
JAX default layout; with ``norm="none"`` they do. Submodule names follow
the flax parameter tree. ``dtype`` is the convs' compute dtype on f32
masters (flax ``dtype=``), as in training; served as a whole-model cast
copy (serve/engine.py), the networks take none and compute in their
weights' dtype. With ``int8`` the residual blocks' k3-s1 convs run on the
int8 path (``ConvLayer(int8=True)``, stored scales under
``int8_delayed``); the stem, the stride-2 downs, the upsample convs and
the head stay as they are. ``forward(x, trunk_fn=...)`` hands the
residual trunk to an external schedule (``p2p_tpu/models/resnet_gen.py:
94-98``; the GPipe path, parallel/pp.py).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from p2p_tpu_torch.models.expand import trunk_block
from p2p_tpu_torch.ops.activations import tanh_y
from p2p_tpu_torch.ops.conv import (ConvLayer, UpsampleConvLayer,
                                    check_remat, remat_call)
from p2p_tpu_torch.ops.norm import make_norm_act


class ResnetBlock(nn.Module):
    """reflectpad-conv-norm-relu-reflectpad-conv-norm + identity. The convs
    carry biases with ``norm="none"`` or ``legacy_layout`` (the JAX
    block's flag, which models/compression_ae.py pins). Rematerialized
    per ``remat`` (ops/conv.py ``remat_call``)."""

    def __init__(self, features: int, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False, legacy_layout: bool = False,
                 remat: Union[bool, str] = False):
        super().__init__()
        check_remat(remat)
        self.remat = remat
        ub = legacy_layout or norm == "none"
        self.na = make_norm_act(norm)
        q = dict(use_bias=ub, dtype=dtype, int8=int8,
                 int8_delayed=int8_delayed)
        self.ConvLayer_0 = ConvLayer(features, features, 3, **q)
        self.ConvLayer_1 = ConvLayer(features, features, 3, **q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat_call(self, self._block, x, mode=self.remat)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        y = self.na(self.ConvLayer_0(x), act="relu")
        return self.na(self.ConvLayer_1(y), residual=x)


class ResnetGenerator(nn.Module):
    """``max_features`` caps the channel growth (pix2pixHD's G1 uses 1024);
    ``return_features`` skips the c7s1-out head and returns the
    ngf-channel feature map (the pix2pixHD enhancer taps it)."""

    def __init__(self, in_channels: int = 3, ngf: int = 64,
                 n_blocks: int = 9, out_channels: int = 3,
                 n_downsampling: int = 2, norm: str = "instance",
                 max_features: Optional[int] = None,
                 return_features: bool = False,
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False,
                 remat: Union[bool, str] = False):
        super().__init__()
        self.na = make_norm_act(norm)
        self.n_downsampling = n_downsampling
        self.n_blocks = n_blocks
        self.return_features = return_features
        cap = max_features or (1 << 30)
        ub = norm == "none"

        self.ConvLayer_0 = ConvLayer(in_channels, ngf, 7, use_bias=ub,
                                     dtype=dtype)
        c = ngf
        for i in range(n_downsampling):
            f = min(ngf * 2 ** (i + 1), cap)
            setattr(self, f"ConvLayer_{i + 1}",
                    ConvLayer(c, f, 3, stride=2, use_bias=ub, dtype=dtype))
            c = f
        for i in range(n_blocks):
            setattr(self, f"ResnetBlock_{i}",
                    ResnetBlock(c, norm=norm, dtype=dtype, int8=int8,
                                int8_delayed=int8_delayed, remat=remat))
        for j, i in enumerate(reversed(range(n_downsampling))):
            f = min(ngf * 2 ** i, cap)
            setattr(self, f"UpsampleConvLayer_{j}", UpsampleConvLayer(
                c, f, 3, upsample=2, use_bias=ub, dtype=dtype))
            c = f
        if not return_features:
            setattr(self, f"ConvLayer_{n_downsampling + 1}",
                    ConvLayer(c, out_channels, 7, dtype=dtype))

    def forward(self, x: torch.Tensor, trunk_fn=None) -> torch.Tensor:
        y = self.na(self.ConvLayer_0(x), act="relu")
        for i in range(self.n_downsampling):
            y = self.na(getattr(self, f"ConvLayer_{i + 1}")(y), act="relu")
        if trunk_fn is not None:
            y = trunk_fn(y)
        else:
            for i in range(self.n_blocks):
                y = trunk_block(self, f"ResnetBlock_{i}")(y)
        for j in range(self.n_downsampling):
            y = self.na(getattr(self, f"UpsampleConvLayer_{j}")(y),
                        act="relu")
        if self.return_features:
            return y
        return tanh_y(getattr(self, f"ConvLayer_{self.n_downsampling + 1}")(y))
