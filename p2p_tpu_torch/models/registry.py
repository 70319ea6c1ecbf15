"""Generator factory (counterpart of ``p2p_tpu/models/registry.py:33
define_G``) and the reference weight init."""

from __future__ import annotations

import torch
from torch import nn

from p2p_tpu_torch.core.config import ModelConfig


def define_G(cfg: ModelConfig) -> nn.Module:
    """The generator ``cfg.generator`` names, on the CPU in f32."""
    if cfg.generator == "pix2pixhd":
        from p2p_tpu_torch.models.pix2pixhd import Pix2PixHDGenerator

        return Pix2PixHDGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf,
            out_channels=cfg.output_nc, n_blocks_global=cfg.n_blocks,
            norm=cfg.norm)
    if cfg.generator == "pix2pixhd_global":
        from p2p_tpu_torch.models.pix2pixhd import GlobalGenerator

        return GlobalGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf,
            out_channels=cfg.output_nc, n_blocks=cfg.n_blocks,
            norm=cfg.norm)
    if cfg.generator == "resnet":
        from p2p_tpu_torch.models.resnet_gen import ResnetGenerator

        return ResnetGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf, n_blocks=cfg.n_blocks,
            out_channels=cfg.output_nc, norm=cfg.norm)
    raise ValueError(f"generator {cfg.generator!r} is not ported yet")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Reference init (networks.py:131 via ``normal_init``): every conv
    kernel ~ N(0, std), every bias 0, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return module
