"""Model factories (counterparts of ``p2p_tpu/models/registry.py:25
define_C``, ``:33 define_G`` and ``:109 define_D``) and the reference
weight init.

``dtype`` is the compute dtype of the trained networks (flax ``dtype=``,
on f32 parameters and statistics). The ResNet-family generators
(``pix2pixhd``, ``pix2pixhd_global``, ``resnet``) take one in training;
the serving engine serves them as a whole-model cast copy built without
one (serve/engine.py). The int8 flags follow the JAX registry: G takes
``int8 and int8_generator`` (the U-Net only with ``upsample_mode ==
"deconv"``), net_c ``int8 and int8_compression``, D ``int8`` with its
stem and head knobs; all take ``int8_delayed``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from p2p_tpu_torch.core.config import ModelConfig
from p2p_tpu_torch.ops.conv import SubpixelConv
from p2p_tpu_torch.ops.norm import BatchNorm
from p2p_tpu_torch.ops.spectral_norm import (SpectralConv, SpectralConv3D,
                                             l2normalize)

# generators served with a compute dtype on f32 masters (their BatchNorm
# statistics stay f32); the others are served as a copy cast to the
# serving dtype
COMPUTE_DTYPE_GENERATORS = ("expand", "unet")


def define_G(cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
             image_hw: Optional[Tuple[int, int]] = None) -> nn.Module:
    """The generator ``cfg.generator`` names, on the CPU in f32.
    ``image_hw`` is the input size, which fixes the U-Net's depth."""
    q = dict(int8=cfg.int8 and cfg.int8_generator,
             int8_delayed=cfg.int8_delayed)
    if cfg.generator == "expand":
        from p2p_tpu_torch.models.expand import ExpandNetwork

        return ExpandNetwork(
            in_channels=cfg.input_nc, ngf=cfg.ngf, n_blocks=cfg.n_blocks,
            out_channels=cfg.output_nc, norm=cfg.norm, dtype=dtype, **q)
    if cfg.generator == "unet":
        from p2p_tpu_torch.models.unet import UNetGenerator

        if image_hw is None:
            raise ValueError("the U-Net needs image_hw: its depth follows "
                             "the input size")
        return UNetGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf,
            out_channels=cfg.output_nc, image_hw=image_hw, norm=cfg.norm,
            use_dropout=cfg.use_dropout, upsample_mode=cfg.upsample_mode,
            legacy_layout=cfg.legacy_layout, thin_head=cfg.thin_head,
            head_pallas=cfg.head_pallas,
            int8=q["int8"] and cfg.upsample_mode == "deconv",
            int8_decoder=cfg.int8_decoder, int8_delayed=cfg.int8_delayed,
            int8_stem=cfg.int8_stem, dtype=dtype)
    if cfg.generator == "pix2pixhd":
        from p2p_tpu_torch.models.pix2pixhd import Pix2PixHDGenerator

        return Pix2PixHDGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf,
            out_channels=cfg.output_nc, n_blocks_global=cfg.n_blocks,
            norm=cfg.norm, dtype=dtype, **q)
    if cfg.generator == "pix2pixhd_global":
        from p2p_tpu_torch.models.pix2pixhd import GlobalGenerator

        return GlobalGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf,
            out_channels=cfg.output_nc, n_blocks=cfg.n_blocks,
            norm=cfg.norm, dtype=dtype, **q)
    if cfg.generator == "resnet":
        from p2p_tpu_torch.models.resnet_gen import ResnetGenerator

        return ResnetGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf, n_blocks=cfg.n_blocks,
            out_channels=cfg.output_nc, norm=cfg.norm, dtype=dtype, **q)
    raise ValueError(f"generator {cfg.generator!r} is not ported yet")


def define_C(cfg: ModelConfig, dtype: Optional[torch.dtype] = None
             ) -> nn.Module:
    """net_c, the compression pre-filter (int8 with ``int8_compression``)."""
    from p2p_tpu_torch.models.compression import CompressionNetwork

    return CompressionNetwork(in_channels=cfg.input_nc, dtype=dtype,
                              int8=cfg.int8 and cfg.int8_compression,
                              int8_delayed=cfg.int8_delayed)


def define_D(cfg: ModelConfig, dtype: Optional[torch.dtype] = None
             ) -> nn.Module:
    """The multiscale PatchGAN on concatenated (input ‖ output) pairs, with
    ``norm_d`` on its inner convs and the int8 flags of ``cfg``."""
    from p2p_tpu_torch.models.patchgan import MultiscaleDiscriminator

    return MultiscaleDiscriminator(
        in_channels=cfg.input_nc + cfg.output_nc, ndf=cfg.ndf,
        n_layers=cfg.n_layers_D, num_D=cfg.num_D,
        use_spectral_norm=cfg.use_spectral_norm,
        get_interm_feat=cfg.get_interm_feat, norm=cfg.norm_d, dtype=dtype,
        int8=cfg.int8, int8_delayed=cfg.int8_delayed,
        int8_stem=cfg.int8_stem, int8_head=cfg.int8_head,
        int8_fused_epilogue=cfg.int8_fused_epilogue)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Reference init (networks.py:131 via ``normal_init``), drawn from
    ``generator``: every conv kernel (plain, transposed, spectral-norm,
    subpixel, 3-D) ~ N(0, std) and every conv bias 0; BatchNorm γ ~ N(1,
    0.02) and β = 0; a spectral-norm ``u`` ~ N(0, 1), normalized. PReLU
    keeps its 0.25."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d,
                          SpectralConv, SpectralConv3D, SubpixelConv)):
            kernel = m.kernel if isinstance(m, SubpixelConv) else m.weight
            kernel.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        if isinstance(m, (SpectralConv, SpectralConv3D)):
            m.u.copy_(l2normalize(m.u.normal_(generator=generator)))
        elif isinstance(m, BatchNorm):
            m.scale.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
    return module
