"""pix2pixHD coarse-to-fine generator (counterpart of
``p2p_tpu/models/pix2pixhd.py`` ``GlobalGenerator`` and
``Pix2PixHDGenerator``).

G1, the global generator (a ResnetGenerator with 4 stride-2 downsamples,
channels capped at 1024), runs on the avg-pool-downsampled input and
hands its pre-output ngf-channel features to G2, the local enhancer, which
adds them to its own half-resolution features, runs ``n_blocks_local``
residual blocks and one upsample back to full resolution. The enhancer
runs at ``ngf // 2``. G1 is registered under the name ``"global"``, as in
the flax tree. ``remat`` rematerializes every residual block of both
trunks (``ParallelConfig.remat``). ``dtype`` is the convs' compute dtype
on f32 masters, as in training (models/resnet_gen.py). ``int8`` puts G1's
trunk and the enhancer's residual blocks on the int8 path
(models/resnet_gen.py).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from p2p_tpu_torch.core.mesh import keep_rows
from p2p_tpu_torch.models.patchgan import avg_pool_downsample
from p2p_tpu_torch.models.resnet_gen import ResnetBlock, ResnetGenerator
from p2p_tpu_torch.ops.activations import tanh_y
from p2p_tpu_torch.ops.conv import ConvLayer, UpsampleConvLayer
from p2p_tpu_torch.ops.norm import make_norm_act


def GlobalGenerator(in_channels: int = 3, ngf: int = 64,
                    out_channels: int = 3, n_blocks: int = 9,
                    norm: str = "instance",
                    return_features: bool = False,
                    dtype: Optional[torch.dtype] = None, int8: bool = False,
                    int8_delayed: bool = False,
                    remat: Union[bool, str] = False) -> ResnetGenerator:
    """G1: the ResnetGenerator configured as pix2pixHD's global net."""
    return ResnetGenerator(
        in_channels=in_channels, ngf=ngf, n_blocks=n_blocks,
        out_channels=out_channels, n_downsampling=4, norm=norm,
        max_features=1024, return_features=return_features, dtype=dtype,
        int8=int8, int8_delayed=int8_delayed, remat=remat)


class Pix2PixHDGenerator(nn.Module):
    """G2∘G1: one local enhancer around the global generator."""

    def __init__(self, in_channels: int = 3, ngf: int = 64,
                 out_channels: int = 3, n_blocks_global: int = 9,
                 n_blocks_local: int = 3, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False,
                 remat: Union[bool, str] = False):
        super().__init__()
        self.na = make_norm_act(norm)
        self.n_blocks_local = n_blocks_local
        ub = norm == "none"
        ngf_local = ngf // 2
        self.add_module("global", GlobalGenerator(
            in_channels=in_channels, ngf=ngf, n_blocks=n_blocks_global,
            norm=norm, return_features=True, dtype=dtype, int8=int8,
            int8_delayed=int8_delayed, remat=remat))
        self.ConvLayer_0 = ConvLayer(in_channels, ngf_local, 7, use_bias=ub,
                                     dtype=dtype)
        self.ConvLayer_1 = ConvLayer(ngf_local, ngf, 3, stride=2,
                                     use_bias=ub, dtype=dtype)
        for i in range(n_blocks_local):
            setattr(self, f"ResnetBlock_{i}",
                    ResnetBlock(ngf, norm=norm, dtype=dtype, int8=int8,
                                int8_delayed=int8_delayed, remat=remat))
        self.UpsampleConvLayer_0 = UpsampleConvLayer(
            ngf, ngf_local, 3, upsample=2, use_bias=ub, dtype=dtype)
        self.ConvLayer_2 = ConvLayer(ngf_local, out_channels, 7, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g1_feats = self._modules["global"](avg_pool_downsample(x))
        y = self.na(self.ConvLayer_0(x), act="relu")
        y = self.na(self.ConvLayer_1(y), act="relu")
        y = keep_rows(y + g1_feats, y)
        for i in range(self.n_blocks_local):
            y = getattr(self, f"ResnetBlock_{i}")(y)
        y = self.na(self.UpsampleConvLayer_0(y), act="relu")
        return tanh_y(self.ConvLayer_2(y))
