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
the head's without ``get_interm_feat``. The JAX head's bf16 kn2row form
(``_PlainConv`` → ``KN2RowConv``) is an exact rewrite of this one conv, so
here it is a plain conv.

The input is the (input ‖ output) pair concatenated on channels. The JAX
split stem (``_SplitStemConv``, ``split_d_pairs``) computes the same
function on the unconcatenated pair with the same parameter tree; it saves
the 6-channel pair tensor under spatial sharding, which the port does not
have, so the port always concatenates.

Under a spatial mesh (every activation one rank's block of rows) the
convs, the pools and the norms run their sharded forms (parallel/
spatial.py, ops/instance_norm.py): each output row of the D's uneven maps
(H → H/2 + 1 at stride 2, H → H + 1 at stride 1) has one owner.

The multiscale D runs ``num_D`` of them on the input downsampled 0, 1, …
times; results come finest first and scale i is named
``scale{num_D-1-i}``, as in the flax tree.

int8 (``p2p_tpu/models/patchgan.py:99-277``): with ``int8`` the three
inner convs are ``ops.int8.QuantConv`` (``conv`` of ``_PlainConv_{1,2,3}``,
so the state dict keeps its keys, plus ``conv.amax_x`` under
``int8_delayed``), or, under spectral norm, ``SpectralConv(int8=True)``
(only w/σ is quantized). ``int8_stem`` quantizes the concatenated
6-channel stem; ``int8_head`` runs the logits head on the int8 kn2row
path (``QuantKN2RowConv``) when it is thin (stride 1, 16·features ≤ its
input width), else as a ``QuantConv``. With ``int8_fused_epilogue``
(needs ``int8_delayed`` and an instance-family norm) inner conv 1 takes
its input raw, inner convs 2 and 3 take the previous conv's raw output
through the quantize-fused epilogue ``norm + LeakyReLU + clip/round +
amax`` (#1 + #4 under ``"pallas_instance"``), spectral-normed or not, and
their feature taps are the dequantized surrogate ``sx·q``; the last inner
epilogue stays unfused.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.core.mesh import spatial_mesh
from p2p_tpu_torch.ops.activations import leaky_relu_y
from p2p_tpu_torch.ops.conv import cast_conv
from p2p_tpu_torch.ops.int8 import QuantConv, QuantKN2RowConv
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
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False), output
    channels_last. It pools an NCHW copy: PyTorch's CUDA backward of this
    overlapping pool on a channels_last input is wrong (0.81–0.98 of the
    gradient's largest entry off an f64 CPU reference, with either
    count_include_pad, torch 2.11.0+cu128 on an H100,
    scripts/torch_pool_backward_check.py; the NCHW kernel is right), and
    the input gradient of every D scale after the first flows through
    it. Under a spatial mesh this rank's rows of it (parallel/spatial.py
    ``avg_pool_rows``: the same NCHW pooling)."""
    if spatial_mesh() is not None:
        from p2p_tpu_torch.parallel.spatial import avg_pool_rows

        return avg_pool_rows(x)
    y = F.avg_pool2d(x.contiguous(), 3, stride=2, padding=1,
                     count_include_pad=False)
    return y.contiguous(memory_format=torch.channels_last)


class _PlainConv(nn.Module):
    """k4 conv with zero padding 2 and a bias (the flax ``_PlainConv``,
    whose ``Conv_0`` is ``conv`` here); with ``int8`` a
    ``QuantKN2RowConv`` when thin (stride 1, 16·features ≤ in_channels),
    else a ``QuantConv``."""

    def __init__(self, in_channels: int, features: int, stride: int,
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False,
                 epilogue: Optional[Callable] = None,
                 epilogue_tap: bool = False):
        super().__init__()
        self.dtype = dtype
        self.int8 = int8
        if int8 and stride == 1 and 16 * features <= in_channels:
            self.conv = QuantKN2RowConv(in_channels, features, 4, 2,
                                        dtype=dtype, delayed=int8_delayed)
        elif int8:
            self.conv = QuantConv(in_channels, features, 4, stride=stride,
                                  padding=2, dtype=dtype,
                                  delayed=int8_delayed, epilogue=epilogue,
                                  epilogue_tap=epilogue_tap)
        else:
            self.conv = nn.Conv2d(in_channels, features, 4, stride=stride,
                                  padding=2)

    def forward(self, x: torch.Tensor):
        if spatial_mesh() is not None:
            if self.int8:
                raise NotImplementedError("the int8 D convs have no form "
                                          "under a spatial mesh")
            from p2p_tpu_torch.parallel.spatial import conv_rows

            c = self.conv
            return conv_rows(x, c.weight, c.bias, c.stride[0], 2, "zero",
                             self.dtype)
        if self.int8:
            return self.conv(x)
        return cast_conv(self.conv, x, self.dtype)


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 6, ndf: int = 64,
                 n_layers: int = 3, use_spectral_norm: bool = True,
                 get_interm_feat: bool = True, norm: str = "none",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False, int8_stem: bool = False,
                 int8_head: bool = False, int8_fused_epilogue: bool = False):
        super().__init__()
        check_norm_d(norm)
        self.fused_q = int8 and int8_delayed and int8_fused_epilogue
        if self.fused_q and norm not in ("instance", "pallas_instance"):
            raise ValueError(
                "int8_fused_epilogue needs a stateless instance-family "
                f"discriminator norm (norm_d), got {norm!r}")
        self.get_interm_feat = get_interm_feat
        self.na = None if norm == "none" else make_norm_act(norm)
        widths = []
        nf = ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            widths.append((nf, 2))
        widths.append((min(nf * 2, 512), 1))
        mods = [_PlainConv(in_channels, ndf, 2, dtype, int8 and int8_stem,
                           int8_delayed)]
        cin = ndf
        for i, (f, stride) in enumerate(widths):
            ep = self._quant_epilogue if self.fused_q and i else None
            if use_spectral_norm:
                mods.append(SpectralConv(
                    cin, f, 4, stride=stride, padding=2, dtype=dtype,
                    int8=int8, int8_delayed=int8_delayed, epilogue=ep,
                    epilogue_tap=ep is not None))
            else:
                mods.append(_PlainConv(cin, f, stride, dtype, int8,
                                       int8_delayed, ep, ep is not None))
            cin = f
        mods.append(_PlainConv(cin, 1, 1, dtype, int8 and int8_head,
                               int8_delayed))
        # flax names each module by its type and creation order
        count = collections.Counter()
        self.stages = []
        for m in mods:
            name = f"{type(m).__name__}_{count[type(m)]}"
            count[type(m)] += 1
            setattr(self, name, m)
            self.stages.append(name)

    def _quant_epilogue(self, y: torch.Tensor, sx: torch.Tensor):
        return self.na(y, act="leaky", slope=0.2, quant_scale=sx)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.fused_q:
            if spatial_mesh() is not None:
                raise NotImplementedError(
                    "the quantize-fused D epilogue has no form under a "
                    "spatial mesh")
            return self._forward_fused(x)
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

    def _forward_fused(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Each inner conv after the first takes the previous one's raw
        output through its quantize-fused epilogue; its tap (the
        dequantized surrogate) stands where the float activation would."""
        stem, *inner, head = (getattr(self, n) for n in self.stages)
        y = leaky_relu_y(stem(x), 0.2)
        feats = [y]
        raw = inner[0](y)
        for conv in inner[1:]:
            raw, tap = conv(raw)
            feats.append(tap)
        y = self.na(raw, act="leaky", slope=0.2)
        feats += [y, head(y)]
        return feats if self.get_interm_feat else feats[-1:]


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 6, ndf: int = 64,
                 n_layers: int = 3, num_D: int = 3,
                 use_spectral_norm: bool = True,
                 get_interm_feat: bool = True, norm: str = "none",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False, int8_stem: bool = False,
                 int8_head: bool = False, int8_fused_epilogue: bool = False):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"scale{num_D - 1 - i}", NLayerDiscriminator(
                in_channels, ndf, n_layers, use_spectral_norm,
                get_interm_feat, norm, dtype, int8, int8_delayed, int8_stem,
                int8_head, int8_fused_epilogue))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"scale{self.num_D - 1 - i}")(x))
            if i != self.num_D - 1:
                x = avg_pool_downsample(x)
        return results
