"""CompressionNetwork, net_c (counterpart of
``p2p_tpu/models/compression.py``): the learned residual pre-filter in
front of the quantizer.

x → conv k5 (3→64) → PReLU → conv k3 (64→64) → BatchNorm → PReLU →
conv k3 s2 (64→12) → pixel shuffle ×2 → per-pixel L2 normalize over the
channels (floor 1e-12) → x + that. Submodule names follow the flax tree.
With ``int8`` all three convs run on the int8 path (``ConvLayer(int8=
True)``, the k5 RGB stem included, as ``p2p_tpu/models/compression.py:
29-60``), with stored scales under ``int8_delayed`` (the JAX
``quant_c``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from p2p_tpu_torch.ops.activations import PReLU
from p2p_tpu_torch.ops.conv import ConvLayer
from p2p_tpu_torch.ops.norm import BatchNorm
from p2p_tpu_torch.ops.pixel_shuffle import pixel_shuffle


class CompressionNetwork(nn.Module):
    def __init__(self, in_channels: int = 3, features: int = 64,
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False):
        super().__init__()
        q = dict(dtype=dtype, int8=int8, int8_delayed=int8_delayed)
        self.ConvLayer_0 = ConvLayer(in_channels, features, 5, **q)
        self.PReLU_0 = PReLU()
        self.ConvLayer_1 = ConvLayer(features, features, 3, **q)
        self.BatchNorm_0 = BatchNorm(features)
        self.PReLU_1 = PReLU()
        self.ConvLayer_2 = ConvLayer(features, 12, 3, stride=2, **q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.PReLU_0(self.ConvLayer_0(x))
        y = self.PReLU_1(self.BatchNorm_0(self.ConvLayer_1(y)))
        y = pixel_shuffle(self.ConvLayer_2(y), 2)
        norm = torch.linalg.vector_norm(y, dim=1, keepdim=True)
        return x + y / torch.maximum(norm, norm.new_full((), 1e-12))
