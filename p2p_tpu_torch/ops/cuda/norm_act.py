"""The fused instance-norm apply + activation (+ residual): the Hopper kernel
and its plain version.

``norm_act(x, mean, rstd, scale, bias, residual, act, slope)`` computes
``act((x − mean)·rstd·γ + β [+ residual])`` in f32 and stores it in x's
dtype, for a channels_last (N, C, H, W) x and (N, C) f32 statistics. The
residual is added before the activation; ``act`` is ``"none"``, ``"relu"``
or ``"leaky"`` (slope > 0); the affine is optional.

Replaces ``p2p_tpu/ops/pallas/norm_act.py:_norm_act_local`` (kernel bodies
``_norm_act_kernel`` and ``_norm_act_res_kernel``). The kernel is
``csrc/norm_act.cu``: it is bound by device-memory bytes (x and the
residual read once, y written once; 3.35 TB/s on an H100 SXM), so it is
one flat pass of 16-byte vector loads and stores along C, with the
activation and the residual compiled in as template parameters.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from p2p_tpu_torch.ops.cuda import build

REPLACES = "p2p_tpu/ops/pallas/norm_act.py:92 (_norm_act_local)"
SOURCE = "p2p_tpu_torch/ops/cuda/csrc/norm_act.cu"
ACTS = ("none", "relu", "leaky")

THREADS = 256
# grid-stride cap: 132 SMs × 8 resident blocks of 256 threads × 4 rounds
_MAX_BLOCKS = 132 * 8 * 4


def check_act(act: str, slope: float) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if act == "leaky" and slope <= 0:
        raise ValueError(f"leaky needs slope > 0 (got {slope})")


def norm_act_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in the kernel's op order."""
    check_act(act, slope)
    y = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    if scale is not None:
        y = y * scale[None, :, None, None] + bias[None, :, None, None]
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.where(y < 0, 0.0, y)
    elif act == "leaky":
        y = torch.where(y < 0, slope * y, y)
    return y.to(x.dtype)


def _check_vector(t: torch.Tensor, shape, device, what: str) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous f32 tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def check_apply_args(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                     scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], what: str) -> None:
    """What the normalize kernels take (this one and #2's): a channels_last
    CUDA x, (N, C) f32 statistics and an optional (C,) f32 affine on its
    device. Raises on anything else."""
    build.check_activation(x, what)
    n, c = x.shape[:2]
    _check_vector(mean, (n, c), x.device, f"{what}: mean")
    _check_vector(rstd, (n, c), x.device, f"{what}: rstd")
    if (scale is None) != (bias is None):
        raise ValueError(f"{what}: pass both scale and bias, or neither")
    if scale is not None:
        _check_vector(scale, (c,), x.device, f"{what}: scale")
        _check_vector(bias, (c,), x.device, f"{what}: bias")


def grid_blocks(numel: int, vec: int) -> int:
    """Blocks of the flat grid-stride pass: one vector per thread, capped."""
    return max(1, min(-(-numel // (vec * THREADS)), _MAX_BLOCKS))


def norm_act(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
             scale: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None,
             act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """``act((x − mean)·rstd·γ + β [+ residual])`` in x's dtype."""
    if x.device.type == "cpu":
        return norm_act_plain(x, mean, rstd, scale, bias, residual, act,
                              slope)
    check_act(act, slope)
    check_apply_args(x, mean, rstd, scale, bias, "norm_act")
    n, c, h, w = x.shape
    tensors = [x]
    if residual is not None:
        build.check_activation(residual, "norm_act residual")
        if residual.shape != x.shape or residual.dtype != x.dtype \
                or residual.device != x.device:
            raise ValueError("norm_act: residual must match x in shape, "
                             "dtype and device")
        tensors.append(residual)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    tensors.append(y)
    vec = build.vector_width(c, *tensors)
    numel = x.numel()
    lib, fn = build.load("norm_act", "p2p_norm_act")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 y.data_ptr(), build.DTYPE_CODES[x.dtype], numel,
                 h * w * c, c, vec, ACTS.index(act), slope,
                 grid_blocks(numel, vec), THREADS,
                 build.stream_handle(x.device))
    build.check(lib, err, "norm_act")
    norm_act.launches += 1
    return y


norm_act.launches = 0
