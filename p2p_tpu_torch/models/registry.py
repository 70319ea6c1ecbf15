"""Model factories (counterparts of ``p2p_tpu/models/registry.py:25
define_C``, ``:33 define_G`` and ``:109 define_D``), the reference weight
init and the ``init_type`` re-draw (``:118-160``).

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

import math
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from p2p_tpu_torch.convert import kernel_to_flax, kernel_to_port
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
             image_hw: Optional[Tuple[int, int]] = None,
             remat: Union[bool, str] = False) -> nn.Module:
    """The generator ``cfg.generator`` names, on the CPU in f32.
    ``image_hw`` is the input size, which fixes the U-Net's depth;
    ``remat`` (``ParallelConfig.remat``) rematerializes the residual
    blocks of the ExpandNetwork and of the ResNet-family trunks."""
    q = dict(int8=cfg.int8 and cfg.int8_generator,
             int8_delayed=cfg.int8_delayed)
    if cfg.generator == "expand":
        from p2p_tpu_torch.models.expand import ExpandNetwork

        return ExpandNetwork(
            in_channels=cfg.input_nc, ngf=cfg.ngf, n_blocks=cfg.n_blocks,
            out_channels=cfg.output_nc, norm=cfg.norm, dtype=dtype,
            remat=remat, **q)
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
            norm=cfg.norm, dtype=dtype, remat=remat, **q)
    if cfg.generator == "pix2pixhd_global":
        from p2p_tpu_torch.models.pix2pixhd import GlobalGenerator

        return GlobalGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf,
            out_channels=cfg.output_nc, n_blocks=cfg.n_blocks,
            norm=cfg.norm, dtype=dtype, remat=remat, **q)
    if cfg.generator == "resnet":
        from p2p_tpu_torch.models.resnet_gen import ResnetGenerator

        return ResnetGenerator(
            in_channels=cfg.input_nc, ngf=cfg.ngf, n_blocks=cfg.n_blocks,
            out_channels=cfg.output_nc, norm=cfg.norm, dtype=dtype,
            remat=remat, **q)
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


# modules whose ``weight`` is a flax ``kernel`` (int8 convs subclass these)
_KERNEL_OWNERS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, SpectralConv,
                  SpectralConv3D)
# flax's truncated normal at ±2: its std is 0.87962566 of the base normal's
_TRUNC_STD = 0.87962566103423978
INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def jax_kernels(module: nn.Module
                ) -> Iterator[Tuple[str, nn.Parameter, nn.Module]]:
    """``(name, parameter, owner)`` of every conv kernel of ``module`` (the
    flax leaves named ``kernel``), in ``named_parameters`` order:
    ``convert.kernel_to_flax(parameter, owner)`` is its flax (HWIO, DHWIO)
    layout."""
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        if (leaf == "kernel" and p.dim() >= 2) or (
                leaf == "weight" and isinstance(owner, _KERNEL_OWNERS)):
            yield name, p, owner


def kernel_fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """flax's ``_compute_fans`` of a kernel of flax shape ``shape``: the
    receptive field times the input axis and times the output axis."""
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def draw_kernel(init_type: str, shape: Tuple[int, ...], gain: float,
                generator: torch.Generator) -> torch.Tensor:
    """A kernel of flax shape ``shape`` from flax's law for ``init_type``:
    ``xavier`` (``xavier_normal``: variance 2/(fan_in + fan_out)) and
    ``kaiming`` (``kaiming_normal``: variance 2/fan_in) as normals
    truncated at ±2σ′, σ′ = σ/0.87962566 so that the std is σ, ``gain``
    unused; ``orthogonal``: the (H·W·I, O) matrix with orthonormal columns
    (rows where it is wide: Q of the QR of a normal matrix, its columns'
    signs those of R's diagonal) times ``gain``. Drawn in f32 (the QR in
    f64) on the generator's device."""
    dev = generator.device
    if init_type in ("xavier", "kaiming"):
        fan_in, fan_out = kernel_fans(shape)
        var = (2.0 / (fan_in + fan_out) if init_type == "xavier"
               else 2.0 / fan_in)
        w = torch.empty(shape, device=dev)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w * (math.sqrt(var) / _TRUNC_STD)
    if init_type == "orthogonal":
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        wide = n_rows < n_cols
        a = torch.randn((n_cols, n_rows) if wide else (n_rows, n_cols),
                        generator=generator, dtype=torch.float64,
                        device=dev)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if wide:
            q = q.T
        return (gain * q).reshape(shape).float()
    raise ValueError(f"unknown init type {init_type!r} (have {INIT_TYPES})")


def init_generator(seed: int, net: int, leaf: int,
                   device: Union[str, torch.device] = "cpu"
                   ) -> torch.Generator:
    """The stream of one re-drawn kernel on ``device``: leaf ``leaf`` of
    network ``net`` of a state seeded with ``seed`` (the triple hashed by
    numpy's ``SeedSequence``)."""
    mixed = np.random.SeedSequence([seed, net, leaf]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


@torch.no_grad()
def apply_init_type(module: nn.Module, seed: int, net: int,
                    init_type: str = "normal", gain: float = 0.02
                    ) -> nn.Module:
    """Re-draw every conv kernel of ``module`` from :func:`draw_kernel`'s
    law for ``init_type``, each from its own :func:`init_generator` stream
    on the kernel's device (``p2p_tpu/models/registry.py:133
    apply_init_type``); biases, norm affines, PReLU slopes and the
    spectral-norm ``u`` keep their values. ``normal`` keeps the reference
    init (the module as it is)."""
    if init_type == "normal":
        return module
    if init_type not in INIT_TYPES:
        raise ValueError(f"unknown init type {init_type!r} (have "
                         f"{INIT_TYPES})")
    for i, (_, p, owner) in enumerate(jax_kernels(module)):
        shape = tuple(kernel_to_flax(p, owner).shape)
        w = draw_kernel(init_type, shape, gain,
                        init_generator(seed, net, i, p.device))
        p.copy_(kernel_to_port(w, owner))
    return module
