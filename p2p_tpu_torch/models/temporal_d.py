"""The temporal (video) discriminator (counterpart of
``p2p_tpu/models/temporal_d.py``: ``:36 avg_pool_spatial_3d``, ``:45
_SplitTimeStem``, ``:95 _Conv3D``, ``:175 TemporalDiscriminator`` and
``:216 MultiscaleTemporalDiscriminator``).

A 3-D PatchGAN over clips of (input ‖ frames), NLayerDiscriminator lifted
to 3-D: the stem conv k (3, 4, 4) stride (1, 2, 2) + LeakyReLU(0.2); inner
convs to min(2^i·ndf, 512), stride (1, 2, 2) then (1, 1, 1), each +
LeakyReLU, spectral-normed with ``use_spectral_norm``
(ops/spectral_norm.py ``SpectralConv3D``); the head to one channel at
stride 1. Every conv pads (1, 2, 2) with zeros, so T is kept at every
stage. The forward returns every stage's output (the temporal
feature-matching taps), or only the head's without ``get_interm_feat``.
The multiscale D runs ``num_D`` of them on the clip pooled over H and W
0, 1, … times (T untouched); results come finest first, scale i named
``tscale{num_D-1-i}``, as in the flax tree.

Clips are (N, C, T, H, W) tensors in ``torch.channels_last_3d``, whose
memory is NTHWC: :func:`fold_frames` views one as N·T channels_last
frames and :func:`unfold_frames` views frames back as a clip, both
without a copy. A ``_Conv3D`` whose input has at most
``THIN_STEM_CHANNELS`` channels (the 6-channel pair stem) runs as the JAX
``_SplitTimeStem``: three per-time-tap 2-D convs over the folded frames
of the clip padded by one zero frame at each end, in f32 (input and
kernel), summed in tap order, the bias added, then cast once to the
compute dtype (f32 when none). The f32 convs run under the process's
``torch.backends.cudnn.allow_tf32`` (PyTorch's default: on, so TF32 on
the card outside a check that turns it off). The parameter tree is the
plain conv's either way (``conv.weight`` (O, I, 3, 4, 4), ``conv.bias``:
the flax ``Conv_0/{kernel,bias}``). The other 3-D convs go to cuDNN
through ``F.conv3d``, with input and kernel cast to ``dtype`` and the
bias added in the output's dtype, as flax's ``nn.Conv`` does.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.models.patchgan import avg_pool_downsample
from p2p_tpu_torch.ops.activations import leaky_relu_y
from p2p_tpu_torch.ops.spectral_norm import SpectralConv3D

# the JAX rule (temporal_d.py:101): a 3-D conv on this many input channels
# or fewer is a thin-input stem
THIN_STEM_CHANNELS = 8


def fold_frames(x: torch.Tensor) -> torch.Tensor:
    """A (N, C, T, H, W) clip → (N·T, C, H, W) frames; a view when the
    clip is channels_last_3d (the frames are then channels_last)."""
    n, c, t, h, w = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(n * t, h, w, c).permute(
        0, 3, 1, 2)


def unfold_frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """(N·T, C, H, W) frames → a (N, C, T, H, W) clip; a view when the
    frames are channels_last (the clip is then channels_last_3d)."""
    nt, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, nt // n, h, w, c).permute(
        0, 4, 1, 2, 3)


def avg_pool_spatial_3d(x: torch.Tensor) -> torch.Tensor:
    """AvgPool(3, s2, pad 1, count_include_pad=False) over H and W of a
    clip, frames folded into the batch (patchgan.avg_pool_downsample)."""
    return unfold_frames(avg_pool_downsample(fold_frames(x)), x.shape[0])


def split_time_stem(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], stride_hw: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The k (3, 4, 4) pad (1, 2, 2) stride (1, s, s) conv of ``x`` as
    three f32 per-tap 2-D convs over its folded frames, summed, the bias
    added, cast once to ``dtype`` (f32 when None)."""
    n, c, t, h, w = x.shape
    xp = F.pad(x.permute(0, 2, 3, 4, 1), (0, 0, 0, 0, 0, 0, 1, 1))
    y = None
    for dt in range(3):
        frames = xp[:, dt:dt + t].reshape(n * t, h, w, c).permute(
            0, 3, 1, 2).float()
        part = F.conv2d(frames, weight[:, :, dt].float(), None, stride_hw, 2)
        y = part if y is None else y + part
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return unfold_frames(y.to(dtype or torch.float32), n)


class _Conv3D(nn.Module):
    """The flax ``_Conv3D``: k (3, 4, 4) conv with zero padding (1, 2, 2),
    stride (1, s, s) and a bias (``conv`` holds ``Conv_0``); the split
    stem on a thin input."""

    def __init__(self, in_channels: int, features: int, stride_hw: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv3d(in_channels, features, (3, 4, 4),
                              stride=(1, stride_hw, stride_hw),
                              padding=(1, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        if conv.in_channels <= THIN_STEM_CHANNELS:
            return split_time_stem(x, conv.weight, conv.bias,
                                   conv.stride[1], self.dtype)
        dt = self.dtype or torch.promote_types(x.dtype, conv.weight.dtype)
        y = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                     conv.padding)
        return y + conv.bias.to(y.dtype).view(1, -1, 1, 1, 1)


class TemporalDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 6, ndf: int = 64,
                 n_layers: int = 3, use_spectral_norm: bool = True,
                 get_interm_feat: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.get_interm_feat = get_interm_feat
        widths = []
        nf = ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            widths.append((nf, 2))
        widths.append((min(nf * 2, 512), 1))
        mods = [_Conv3D(in_channels, ndf, 2, dtype)]
        cin = ndf
        for f, stride in widths:
            mods.append(SpectralConv3D(cin, f, stride, dtype=dtype)
                        if use_spectral_norm
                        else _Conv3D(cin, f, stride, dtype))
            cin = f
        mods.append(_Conv3D(cin, 1, 1, dtype))
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
            if i < last:
                y = leaky_relu_y(y, 0.2)
            feats.append(y)
        return feats if self.get_interm_feat else feats[-1:]


class MultiscaleTemporalDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 6, ndf: int = 64,
                 n_layers: int = 3, num_D: int = 2,
                 use_spectral_norm: bool = True,
                 get_interm_feat: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"tscale{num_D - 1 - i}", TemporalDiscriminator(
                in_channels, ndf, n_layers, use_spectral_norm,
                get_interm_feat, dtype))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"tscale{self.num_D - 1 - i}")(x))
            if i != self.num_D - 1:
                x = avg_pool_spatial_3d(x)
        return results
