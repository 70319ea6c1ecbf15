"""The VGG19 feature trunk of the perceptual loss (counterpart of
``p2p_tpu/models/vgg.py:48 VGG19Features``).

The torchvision VGG19 ``features`` through conv5_1, returning the five
activations after relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1. Images go
in as [-1, 1] with no ImageNet normalization unless ``imagenet_norm``. The
trunk is frozen. Its convs compute in the promoted type of input and
weight (flax ``dtype=None``): the f32 weights make it f32 even on a bf16
input, as in the JAX step. Under a spatial mesh the convs and pools run on this
rank's rows (parallel/spatial.py).

The weights are found as the JAX package finds them
(``p2p_tpu/models/vgg.py:78 vgg19_npz_path``): an ``.npz`` of HWIO
``<conv>_kernel`` and ``<conv>_bias`` arrays at ``$P2P_TPU_VGG19_NPZ``, or
at ``p2p_tpu_torch/assets/vgg19.npz`` (:func:`load_vgg19_npz`); unlike
the JAX lookup, a ``$P2P_TPU_VGG19_NPZ`` that names no file raises. No such
file is in the repository and none can be fetched, so without one
:func:`init_vgg19` draws the JAX package's distribution (flax
``lecun_normal``: a normal truncated at 2σ, variance 1/fan_in, zero bias)
from a seed; the CPU tests carry the JAX package's own fixed-seed draw
across with ``convert.py`` instead.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.core.mesh import keep_rows, spatial_mesh
from p2p_tpu_torch.ops.activations import relu_y
from p2p_tpu_torch.ops.conv import cast_conv

# (name, out_channels); "M" = 2×2 max pool
_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), ("M", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("M", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("M", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("M", 0),
    ("conv5_1", 512),
]
_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    def __init__(self, imagenet_norm: bool = False):
        super().__init__()
        self.imagenet_norm = imagenet_norm
        cin = 3
        for name, ch in _CFG:
            if name != "M":
                setattr(self, name, nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.imagenet_norm:
            mean = x.new_tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
            std = x.new_tensor(_IMAGENET_STD).view(1, 3, 1, 1)
            x = keep_rows(((x + 1.0) * 0.5 - mean) / std, x)
        rows = spatial_mesh() is not None
        if rows:
            from p2p_tpu_torch.parallel.spatial import (conv_rows,
                                                        max_pool_rows)
        outs = []
        y = x
        for name, _ in _CFG:
            if name == "M":
                y = max_pool_rows(y) if rows else F.max_pool2d(y, 2, 2)
                continue
            conv = getattr(self, name)
            y = relu_y(conv_rows(y, conv.weight, conv.bias, 1, 1, "zero")
                       if rows else cast_conv(conv, y))
            if name in _TAPS:
                outs.append(y)
        return outs


@torch.no_grad()
def init_vgg19(vgg: VGG19Features, generator: torch.Generator
               ) -> VGG19Features:
    """Random VGG19 weights from ``generator``: flax ``lecun_normal``
    kernels (std √(1/fan_in) / 0.87962566, truncated at ±2 of the base
    normal) and zero biases."""
    for m in vgg.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            m.weight.copy_(w * std)
            m.bias.zero_()
    return vgg


_DEFAULT_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                              "vgg19.npz")


def vgg19_npz_path() -> Optional[str]:
    """The pretrained-weights file: ``$P2P_TPU_VGG19_NPZ``, which must
    exist when it is set, else the package asset when it exists, else
    None (the fixed-seed draw)."""
    p = os.environ.get("P2P_TPU_VGG19_NPZ")
    if p is not None:
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"P2P_TPU_VGG19_NPZ={p!r}: no such file")
        return p
    return _DEFAULT_ASSET if os.path.exists(_DEFAULT_ASSET) else None


@torch.no_grad()
def load_vgg19_npz(vgg: VGG19Features, path: str) -> VGG19Features:
    """Every conv's ``<name>_kernel`` (HWIO) and ``<name>_bias`` from the
    ``.npz`` at ``path``."""
    with np.load(path, allow_pickle=False) as data:
        for name, ch in _CFG:
            if name == "M":
                continue
            conv = getattr(vgg, name)
            kernel = np.asarray(data[f"{name}_kernel"], np.float32)
            if kernel.shape[-1] != ch:
                raise ValueError(f"{path}: {name}_kernel has shape "
                                 f"{kernel.shape}, want {ch} outputs")
            conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)
                                               .copy()))
            conv.bias.copy_(torch.from_numpy(
                np.asarray(data[f"{name}_bias"], np.float32)))
    return vgg
