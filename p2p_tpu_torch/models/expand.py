"""ExpandNetwork, the reference preset's generator (counterpart of
``p2p_tpu/models/expand.py`` ``ResidualBlock`` and ``ExpandNetwork``).

PixelUnshuffle(2) → nearest ×2 → [conv k9 12→ngf, conv k3 s2 ngf→2ngf,
conv k3 s2 2ngf→4ngf], each norm + the shared PReLU → ``n_blocks``
residual blocks → long skip + LeakyReLU(0.2) → [up×2 conv 4ngf→2ngf,
up×2 conv 2ngf→ngf], norm + PReLU each → conv k9 ngf→out → norm → tanh.
Every conv is followed by a norm, so no conv carries a bias (JAX
``ub = legacy_layout or norm == "none"``). One PReLU scalar serves every
call site. Submodule names follow the flax tree. With ``int8`` the
residual blocks' k3-s1 convs run on the int8 path (``ConvLayer(int8=
True)``, stored scales under ``int8_delayed``); the stem, the stride-2
downs, the upsample convs and the head stay in the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from p2p_tpu_torch.ops.activations import PReLU, leaky_relu_y, tanh_y
from p2p_tpu_torch.ops.conv import ConvLayer, UpsampleConvLayer, \
    check_remat, remat_call, upsample_nearest
from p2p_tpu_torch.ops.norm import make_norm, make_norm_act
from p2p_tpu_torch.ops.pixel_shuffle import pixel_unshuffle


def trunk_block(net: nn.Module, name: str) -> nn.Module:
    """The trunk block ``name`` of ``net``; raises when a pipe split moved
    it out (parallel/pp.py ``pp_split_state``: the module then runs only
    with a ``trunk_fn``)."""
    block = getattr(net, name)
    if block is None:
        raise RuntimeError(f"{name} lives in a pipe stage (pp_split_state): "
                           "run this generator with its trunk_fn")
    return block


class ResidualBlock(nn.Module):
    """conv-norm-relu-conv-norm + identity, relu after the add;
    rematerialized per ``remat`` (ops/conv.py ``remat_call``)."""

    def __init__(self, features: int, norm: str = "batch",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False,
                 remat: Union[bool, str] = False):
        super().__init__()
        check_remat(remat)
        self.remat = remat
        ub = norm == "none"
        q = dict(use_bias=ub, dtype=dtype, int8=int8,
                 int8_delayed=int8_delayed)
        self.ConvLayer_0 = ConvLayer(features, features, 3, **q)
        self.BatchNorm_0 = make_norm_act(norm, features)
        self.ConvLayer_1 = ConvLayer(features, features, 3, **q)
        self.BatchNorm_1 = make_norm_act(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat_call(self, self._block, x, mode=self.remat)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.ConvLayer_0(x), act="relu")
        return self.BatchNorm_1(self.ConvLayer_1(y), act="relu", residual=x)


class ExpandNetwork(nn.Module):
    def __init__(self, in_channels: int = 3, ngf: int = 32,
                 n_blocks: int = 9, out_channels: int = 3,
                 norm: str = "batch", dtype: Optional[torch.dtype] = None,
                 int8: bool = False, int8_delayed: bool = False,
                 remat: Union[bool, str] = False):
        super().__init__()
        ub = norm == "none"
        self.n_blocks = n_blocks
        self.PReLU_0 = PReLU()
        widths = [(in_channels * 4, ngf, 9, 1), (ngf, ngf * 2, 3, 2),
                  (ngf * 2, ngf * 4, 3, 2)]
        for i, (cin, f, k, s) in enumerate(widths):
            setattr(self, f"ConvLayer_{i}", ConvLayer(
                cin, f, k, stride=s, use_bias=ub, dtype=dtype))
            setattr(self, f"BatchNorm_{i}", make_norm(norm, f))
        for i in range(n_blocks):
            setattr(self, f"ResidualBlock_{i}",
                    ResidualBlock(ngf * 4, norm=norm, dtype=dtype, int8=int8,
                                  int8_delayed=int8_delayed, remat=remat))
        ups = [(ngf * 4, ngf * 2, 3, 2), (ngf * 2, ngf, 3, 2),
               (ngf, out_channels, 9, 0)]
        for i, (cin, f, k, up) in enumerate(ups):
            setattr(self, f"UpsampleConvLayer_{i}", UpsampleConvLayer(
                cin, f, k, upsample=up, use_bias=ub, dtype=dtype))
            setattr(self, f"BatchNorm_{i + 3}", make_norm(norm, f))

    def forward(self, x: torch.Tensor, trunk_fn=None) -> torch.Tensor:
        act = self.PReLU_0
        y = upsample_nearest(pixel_unshuffle(x, 2), 2)
        for i in range(3):
            y = act(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"ConvLayer_{i}")(y)))
        residual = y
        if trunk_fn is not None:
            y = trunk_fn(y)
        else:
            for i in range(self.n_blocks):
                y = trunk_block(self, f"ResidualBlock_{i}")(y)
        y = leaky_relu_y(y + residual, 0.2)
        for i in range(2):
            y = act(getattr(self, f"BatchNorm_{i + 3}")(
                getattr(self, f"UpsampleConvLayer_{i}")(y)))
        return tanh_y(self.BatchNorm_5(self.UpsampleConvLayer_2(y)))
