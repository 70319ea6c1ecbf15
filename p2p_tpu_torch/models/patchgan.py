"""PatchGAN discriminators (counterpart of ``p2p_tpu/models/patchgan.py:39
avg_pool_downsample``, ``:156 NLayerDiscriminator`` and ``:280
MultiscaleDiscriminator``).

One NLayerDiscriminator with n_layers = 3 has five stages: conv k4 s2 +
LeakyReLU(0.2); three inner convs k4 (s2, s2, s1), spectral-normed when
``use_spectral_norm``, each + the ``norm`` epilogue ``norm → LeakyReLU``
(``"none"``: LeakyReLU alone; ``"pallas_instance"``: #1 + #3 fused); and
the k4 s1 head to one channel. Every conv pads with 2 zeros and carries a
bias; widths double from ``ndf`` up to 512. The norms are stateless and
affine-free, so the parameter tree does not depend on ``norm``. The
forward returns every stage's output (the feature-matching taps), or only
the head's without ``get_interm_feat``. The JAX head's kn2row form
(``_PlainConv`` → ``KN2RowConv``) is an exact rewrite of this one conv, so
here it is a plain conv.

The input is the (input ‖ output) pair concatenated on channels. The JAX
split stem (``_SplitStemConv``, ``split_d_pairs``) computes the same
function on the unconcatenated pair with the same parameter tree; it saves
the 6-channel pair tensor under spatial sharding, which the port does not
have, so the port always concatenates.

The multiscale D runs ``num_D`` of them on the input downsampled 0, 1, …
times; results come finest first and scale i is named
``scale{num_D-1-i}``, as in the flax tree.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.ops.activations import leaky_relu_y
from p2p_tpu_torch.ops.conv import cast_conv
from p2p_tpu_torch.ops.norm import make_norm_act
from p2p_tpu_torch.ops.spectral_norm import SpectralConv

# the norm kinds a discriminator takes: stateless ones only (its train step
# threads no running statistics)
D_NORM_KINDS = ("none", "instance", "pallas_instance")


def check_norm_d(kind: str) -> None:
    """Raise unless ``kind`` is a discriminator norm of the port."""
    if kind not in D_NORM_KINDS:
        raise ValueError(f"norm_d {kind!r} is not a discriminator norm of "
                         f"the port (have {D_NORM_KINDS}: stateless)")


def avg_pool_downsample(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


class _PlainConv(nn.Module):
    """k4 conv with zero padding 2 and a bias (the flax ``_PlainConv``,
    whose ``Conv_0`` is ``conv`` here)."""

    def __init__(self, in_channels: int, features: int, stride: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, 4, stride=stride,
                              padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cast_conv(self.conv, x, self.dtype)


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 6, ndf: int = 64,
                 n_layers: int = 3, use_spectral_norm: bool = True,
                 get_interm_feat: bool = True, norm: str = "none",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_norm_d(norm)
        self.get_interm_feat = get_interm_feat
        self.na = None if norm == "none" else make_norm_act(norm)
        widths = []
        nf = ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            widths.append((nf, 2))
        widths.append((min(nf * 2, 512), 1))
        mods = [_PlainConv(in_channels, ndf, 2, dtype)]
        cin = ndf
        for f, stride in widths:
            mods.append(SpectralConv(cin, f, 4, stride=stride, padding=2,
                                     dtype=dtype) if use_spectral_norm
                        else _PlainConv(cin, f, stride, dtype))
            cin = f
        mods.append(_PlainConv(cin, 1, 1, dtype))
        # flax names each module by its type and creation order
        count = collections.Counter()
        self.stages = []
        for m in mods:
            name = f"{type(m).__name__}_{count[type(m)]}"
            count[type(m)] += 1
            setattr(self, name, m)
            self.stages.append(name)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        y = x
        last = len(self.stages) - 1
        for i, name in enumerate(self.stages):
            y = getattr(self, name)(y)
            if 0 < i < last and self.na is not None:
                y = self.na(y, act="leaky", slope=0.2)
            elif i < last:
                y = leaky_relu_y(y, 0.2)
            feats.append(y)
        return feats if self.get_interm_feat else feats[-1:]


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 6, ndf: int = 64,
                 n_layers: int = 3, num_D: int = 3,
                 use_spectral_norm: bool = True,
                 get_interm_feat: bool = True, norm: str = "none",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"scale{num_D - 1 - i}", NLayerDiscriminator(
                in_channels, ndf, n_layers, use_spectral_norm,
                get_interm_feat, norm, dtype))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"scale{self.num_D - 1 - i}")(x))
            if i != self.num_D - 1:
                x = avg_pool_downsample(x)
        return results
