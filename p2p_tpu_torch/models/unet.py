"""The pix2pix U-Net generator (counterpart of ``p2p_tpu/models/unet.py:37
UNetGenerator``).

``num_downs`` stride-2 k4 encoder convs (LeakyReLU(0.2) before each but
the first), widths ngf → 8·ngf (capped), a skip at every level; the
decoder mirrors them with ReLU → a ×2 upsample → norm, concatenates
``[y, skip]`` and ends in tanh. The upsample is ``upsample_mode``'s:
``"deconv"`` ConvTranspose(k4, s2), ``"subpixel"`` the k2-s1 conv to 4·F
channels + shifted interleave (ops/conv.py ``SubpixelDeconv``, its bias
kept at every level: after the interleave it is a per-phase offset that a
norm does not cancel), ``"resize"`` nearest ×2 + reflect-padded k3 conv
(``UpsampleConvLayer``). The outermost and innermost levels carry no
norm, and with a norm the conv biases in front of it are dropped (they
are cancelled exactly; ``legacy_layout`` keeps them). The norm is any
kind of ops/norm.py: ``"pallas_instance"`` runs #1 + #2 at each of them.
With ``thin_head`` the deconv image head ``up0`` is the subpixel form,
when ``16·out_channels ≤`` its input width; with ``head_pallas`` as well,
its conv runs through the Hopper kernels #6/#7. The config's
``thin_stem`` selects the JAX package's im2col form of the RGB stem
``down0``, an exact rewrite of the same conv for the TPU's matrix unit
with the same parameters; here the stem is the one ``nn.Conv2d`` either
way, so the option does not reach this module.

int8 (``p2p_tpu/models/unet.py:113-207``): with ``int8`` the encoder
convs ``down{i}``, i > 0, are ``ops.int8.QuantConv`` k4 s2 p1 (their
biases dropped in front of a norm, as the plain ones), ``int8_stem`` adds
``down0``; ``int8_decoder`` makes ``up{i}``, i > 0, a
``QuantSubpixelDeconv`` (bias kept, as the subpixel form's), while the
image head ``up0`` keeps its form; ``int8_delayed`` gives each of them a
stored scale ``amax_x``. The registry passes ``int8`` only with
``upsample_mode == "deconv"``, as the JAX registry does.

The JAX module clamps the depth to the factor-of-2 content of the input's
H and W when it traces; here the depth is fixed at construction from the
image size (:func:`unet_levels`), and a forward on another size raises.

Dropout (``use_dropout``): 0.5 on decoder levels ``num_downs−4 ≤ i <
num_downs−1``, after the norm, kept values scaled by 2, in training only.
The noise comes from the ``torch.Generator`` the caller passes (the train
step seeds one per step); the JAX mask cannot be reproduced bitwise.

Names follow the flax tree: ``down{i}``, ``up{i}`` (``up0.conv`` is the
subpixel head's ``Conv_0``) and the BatchNorms ``BatchNorm_0`` … in
creation order (encoder levels 1…num_downs−2, then decoder levels
num_downs−1…1), which keeps convert.py a direct mapping.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from p2p_tpu_torch.core.mesh import current_mesh
from p2p_tpu_torch.ops.activations import leaky_relu_y, relu_y, tanh_y
from p2p_tpu_torch.ops.conv import (SubpixelDeconv, UpsampleConvLayer,
                                    cast_conv)
from p2p_tpu_torch.ops.int8 import QuantConv, QuantSubpixelDeconv
from p2p_tpu_torch.ops.norm import make_norm

DROPOUT_RATE = 0.5


def _pow2_levels(n: int) -> int:
    k = 0
    while n % 2 == 0 and n > 1:
        n //= 2
        k += 1
    return k


def unet_levels(num_downs: int, h: int, w: int) -> int:
    """The depth the JAX module uses at an (h, w) input: ``num_downs``
    clamped to the factor-of-2 content of h and w."""
    return min(num_downs, _pow2_levels(h), _pow2_levels(w))


def dropout(y: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keep each element with probability 0.5 and scale it by 2 (flax
    ``nn.Dropout(0.5)``), drawing the mask from ``generator``. Inside a
    data-parallel step (a mesh made visible by ``core/mesh.mesh_context``)
    the mask is drawn for the global batch and this rank keeps its rows,
    so W ranks apply the masks one rank does at the global batch."""
    n, c, h, w = y.shape
    mesh = current_mesh()
    shards = 1 if mesh is None else mesh.batch_shards
    u = torch.rand((n * shards, h, w, c), generator=generator,
                   device=y.device)
    if shards > 1:
        u = u[mesh.batch_rank * n:(mesh.batch_rank + 1) * n]
    u = u.permute(0, 3, 1, 2)
    keep = 1.0 - DROPOUT_RATE
    return torch.where(u < keep, y / keep, torch.zeros((), dtype=y.dtype,
                                                       device=y.device))


class UNetGenerator(nn.Module):
    def __init__(self, in_channels: int = 3, ngf: int = 64,
                 out_channels: int = 3,
                 image_hw: Tuple[int, int] = (256, 256), num_downs: int = 8,
                 norm: str = "batch", use_dropout: bool = False,
                 upsample_mode: str = "deconv", legacy_layout: bool = False,
                 thin_head: bool = False, head_pallas: bool = False,
                 int8: bool = False, int8_decoder: bool = False,
                 int8_delayed: bool = False, int8_stem: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if upsample_mode not in ("deconv", "subpixel", "resize"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}; "
                             "expected 'deconv', 'subpixel', or 'resize'")
        if head_pallas and (not thin_head or legacy_layout):
            raise ValueError(
                "head_pallas requires thin_head (the subpixel head form) "
                "and the default (non-legacy) layout")
        self.max_downs = num_downs
        self.num_downs = nd = unet_levels(num_downs, *image_hw)
        self.dtype = dtype
        normed = norm != "none" and not legacy_layout
        feats = [min(ngf * 2 ** i, ngf * 8) for i in range(nd)]
        self.norms: List = [None] * (2 * nd)   # [encoder i, nd + decoder i]
        n_modules = 0

        def mk(slot: int, features: int) -> None:
            nonlocal n_modules
            m = make_norm(norm, features)
            if isinstance(m, nn.Module):
                setattr(self, f"{type(m).__name__}_{n_modules}", m)
                n_modules += 1
            self.norms[slot] = m

        cin = in_channels
        for i, f in enumerate(feats):
            norm_after = 0 < i < nd - 1
            bias = not (normed and norm_after)
            if int8 and (i > 0 or int8_stem):
                down = QuantConv(cin, f, 4, stride=2, padding=1, bias=bias,
                                 dtype=dtype, delayed=int8_delayed)
            else:
                down = nn.Conv2d(cin, f, 4, stride=2, padding=1, bias=bias)
            setattr(self, f"down{i}", down)
            if norm_after:
                mk(i, f)
            cin = f
        for i in reversed(range(nd)):
            f = out_channels if i == 0 else feats[i - 1]
            cin = feats[i] if i == nd - 1 else 2 * feats[i]
            if upsample_mode == "subpixel":
                up = SubpixelDeconv(cin, f, dtype=dtype)
            elif upsample_mode == "resize":
                up = UpsampleConvLayer(cin, f, 3, upsample=2,
                                       use_bias=not (normed and i > 0),
                                       dtype=dtype)
            elif int8 and int8_decoder and i > 0:
                up = QuantSubpixelDeconv(cin, f, dtype=dtype,
                                         delayed=int8_delayed)
            elif i == 0 and thin_head and not legacy_layout \
                    and 16 * f <= cin:
                up = SubpixelDeconv(cin, f, pallas=head_pallas, dtype=dtype)
            else:
                up = nn.ConvTranspose2d(cin, f, 4, stride=2, padding=1,
                                        bias=not (normed and i > 0))
            setattr(self, f"up{i}", up)
            if i > 0:
                mk(nd + i, f)
        self.dropout_levels = frozenset(
            i for i in range(1, nd)
            if use_dropout and nd - 4 <= i < nd - 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` channels_last (N, C, H, W); ``generator`` draws the
        dropout masks in training (required there when ``use_dropout``)."""
        nd = self.num_downs
        if unet_levels(self.max_downs, x.shape[2], x.shape[3]) != nd:
            raise ValueError(f"this U-Net was built for {nd} levels; a "
                             f"{x.shape[2]}x{x.shape[3]} input needs "
                             f"another depth")
        drop = self.training and bool(self.dropout_levels)
        if drop and generator is None:
            raise ValueError("U-Net dropout in training needs a "
                             "torch.Generator")
        skips = []
        y = x
        for i in range(nd):
            if i > 0:
                y = leaky_relu_y(y, 0.2)
            down = getattr(self, f"down{i}")
            y = down(y) if isinstance(down, QuantConv) \
                else cast_conv(down, y, self.dtype)
            if self.norms[i] is not None:
                y = self.norms[i](y)
            skips.append(y)
        for i in reversed(range(nd)):
            y = relu_y(y)
            up = getattr(self, f"up{i}")
            y = up(y) if isinstance(up, (SubpixelDeconv, UpsampleConvLayer,
                                         QuantSubpixelDeconv)) \
                else cast_conv(up, y, self.dtype)
            if i > 0:
                y = self.norms[nd + i](y)
                if drop and i in self.dropout_levels:
                    y = dropout(y, generator)
                y = torch.cat([y, skips[i - 1]], dim=1)
        return tanh_y(y)
