"""The learned-compression autoencoder (counterpart of
``p2p_tpu/models/compression_ae.py:40 CompressionEncoder``, ``:58
CompressionDecoder`` and ``:92 CompressionAutoencoder``), on channels_last
(N, C, H, W) tensors. No train step or CLI of either package runs it: it
is a model family of the JAX package, ported so the port has every one.

- **Encoder**: c7s1-ngf, then ``n_down`` × [reflect-padded conv k3 s2 +
  instance norm + ReLU] doubling the channels, then a k3 conv to
  ``latent_channels``.
- **Decoder**: instance norm → conv k3 to ngf·2^n_up → instance norm (the
  head), ``n_blocks`` residual blocks with biases (``legacy_layout``) and
  no activation after the add, a long skip from the head, ``n_up`` ×
  [transposed conv k3 s2 + instance norm + ReLU] halving the channels,
  c7s1-3 out.
- **Autoencoder**: decode(quantize(sigmoid(encode(x)))), the quantizer
  (straight-through with ``quant_ste``) only when ``quant_bits`` > 0.

Submodule names follow the flax tree (``ConvLayer_k``, ``ResnetBlock_k``,
``ConvTranspose_k``, ``encoder``, ``decoder``), so convert.py carries the
JAX parameters across. Flax's ``ConvTranspose(k3, s2, "SAME")`` pads the
dilated input by (2, 1); ``nn.ConvTranspose2d(k3, stride 2, padding 0)``
pads it by (2, 2), so its last row and column are cut off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from p2p_tpu_torch.models.resnet_gen import ResnetBlock
from p2p_tpu_torch.ops.activations import relu_y
from p2p_tpu_torch.ops.conv import ConvLayer, cast_conv
from p2p_tpu_torch.ops.norm import instance_norm
from p2p_tpu_torch.ops.quantize import quantize, quantize_ste


class CompressionEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, ngf: int = 60,
                 latent_channels: int = 220, n_down: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_down = n_down
        self.ConvLayer_0 = ConvLayer(in_channels, ngf, 7, dtype=dtype)
        c = ngf
        for i in range(n_down):
            f = ngf * 2 ** (i + 1)
            setattr(self, f"ConvLayer_{i + 1}",
                    ConvLayer(c, f, 3, stride=2, dtype=dtype))
            c = f
        setattr(self, f"ConvLayer_{n_down + 1}",
                ConvLayer(c, latent_channels, 3, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_down + 1):
            y = relu_y(instance_norm(getattr(self, f"ConvLayer_{i}")(y)))
        return getattr(self, f"ConvLayer_{self.n_down + 1}")(y)


class CompressionDecoder(nn.Module):
    def __init__(self, latent_channels: int = 220, ngf: int = 60,
                 n_blocks: int = 8, n_up: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_blocks, self.n_up, self.dtype = n_blocks, n_up, dtype
        f_top = ngf * 2 ** n_up
        self.ConvLayer_0 = ConvLayer(latent_channels, f_top, 3, dtype=dtype)
        for i in range(n_blocks):
            setattr(self, f"ResnetBlock_{i}",
                    ResnetBlock(f_top, norm="instance", legacy_layout=True,
                                dtype=dtype))
        c = f_top
        for j, i in enumerate(reversed(range(n_up))):
            f = ngf * 2 ** i
            setattr(self, f"ConvTranspose_{j}",
                    nn.ConvTranspose2d(c, f, 3, stride=2))
            c = f
        self.ConvLayer_1 = ConvLayer(c, 3, 7, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        head = instance_norm(self.ConvLayer_0(instance_norm(z)))
        y = head
        for i in range(self.n_blocks):
            y = getattr(self, f"ResnetBlock_{i}")(y)
        y = y + head
        for j in range(self.n_up):
            h, w = y.shape[2:]
            y = cast_conv(getattr(self, f"ConvTranspose_{j}"), y,
                          self.dtype)[:, :, :2 * h, :2 * w]
            y = relu_y(instance_norm(y))
        return self.ConvLayer_1(y)


class CompressionAutoencoder(nn.Module):
    """decode(quantize(encode(x))); the latent is squashed to [0, 1] by a
    sigmoid before the bit quantizer (``quant_bits=0`` leaves it as it
    is)."""

    def __init__(self, in_channels: int = 3, ngf: int = 60,
                 latent_channels: int = 220, n_blocks: int = 8,
                 quant_bits: int = 0, quant_ste: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.quant_bits, self.quant_ste = quant_bits, quant_ste
        self.encoder = CompressionEncoder(in_channels, ngf, latent_channels,
                                          dtype=dtype)
        self.decoder = CompressionDecoder(latent_channels, ngf, n_blocks,
                                          dtype=dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        z = self.encoder(x)
        if self.quant_bits > 0:
            q = quantize_ste if self.quant_ste else quantize
            z = q(torch.sigmoid(z), self.quant_bits)
        return z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
