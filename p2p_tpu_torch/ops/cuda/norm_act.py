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

``norm_act_quant(x, mean, rstd, scale, bias, sx, act, slope)`` (#4) is the
quantize-fused form of the delayed-int8 discriminator: the same epilogue
without a residual, its value rounded through x's dtype (``yc``), then
``q = clip(round(yc / sx), −127, 127)`` stored in x's dtype and
``max|yc|`` as a 0-d f32 tensor, from one launch. ``sx`` is a 0-d f32
tensor on x's device (never read on the host). It replaces
``norm_act.py:_norm_act_quant_local`` (kernel body
``_norm_act_quant_kernel``): the ``p2p_norm_act_quant`` entry point of the
same library. Each block folds its max|yc| into one 32-bit word with
``atomicMax`` on the float's bits and takes a ticket on an arrival counter
beside it; the last block moves the word to amax. Word and counter are one
pair per device and stream, which the last block sets back to 0, so a
launch needs no fill before it.

#4 and #2 (``instance_norm_kernel.instance_norm_apply``, the same
library's ``p2p_instance_norm_apply``) are launched as programmatic
dependents of the launch before them and share one launch plan,
``apply_plan``: one wave of 256-thread blocks at the main path's shapes,
16-byte vectors along C, across pixels at C = 3 (#2 only), or one element
at a time. With ``x_ready=True`` (the launch just before on the stream
does not write x: ``ops/instance_norm.py`` launches #1 of the same x right
before) each block issues its loads of x before it waits for that launch
to end (the rule is in ``csrc/norm_act.cu``).

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from p2p_tpu_torch.ops.cuda import build

REPLACES = "p2p_tpu/ops/pallas/norm_act.py:92 (_norm_act_local)"
SOURCE = "p2p_tpu_torch/ops/cuda/csrc/norm_act.cu"
REPLACES_QUANT = "p2p_tpu/ops/pallas/norm_act.py:277 (_norm_act_quant_local)"
ACTS = ("none", "relu", "leaky")

THREADS = 256
SMS = 132                  # an H100's streaming multiprocessors
RESIDENT_THREADS = 2048    # threads an SM holds
# grid-stride cap: 132 SMs × 8 resident blocks of 256 threads × 4 rounds
_MAX_BLOCKS = SMS * 8 * 4
# paths of #2 and #4 (csrc/norm_act.cu ApplyPath): 16-byte vectors along C,
# 16-byte vectors over the flat array at C = 3, one element at a time
APPLY_PATHS = ("channels", "flat3", "element")
PER_THREAD = (1, 2, 4)


def check_act(act: str, slope: float) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if act == "leaky" and slope <= 0:
        raise ValueError(f"leaky needs slope > 0 (got {slope})")


def affine_fma(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """``y·γ + β`` over C of an (N, C, H, W) f32 tensor, rounded once, as a
    fused multiply-add: XLA contracts the JAX expression into one, and the
    kernels use ``fmaf``. The f32 product is exact in f64; the f64 sum
    rounds to f32 as the fused result does unless it lands exactly on an
    f32 midpoint (a chance of about 2⁻²⁹ per element)."""
    y64 = y.double() * scale.double()[None, :, None, None]
    return (y64 + bias.double()[None, :, None, None]).float()


def norm_act_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in the kernel's op order."""
    check_act(act, slope)
    y = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    if scale is not None:
        y = affine_fma(y, scale, bias)
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


class ApplyPlan(NamedTuple):
    path: str        # one of APPLY_PATHS
    vec: int         # elements a load
    per_thread: int  # K: thread t of block b takes the vectors
                     # (b·K + k)·THREADS + t, k < K
    blocks: int


def apply_plan(numel: int, hwc: int, c: int, element_size: int,
               aligned: bool, flat3: bool = True) -> ApplyPlan:
    """Launch plan of #2 and #4 over an (N, H, W, C) activation of
    ``numel`` elements (``hwc`` = H·W·C) whose x and y are 16-byte aligned
    when ``aligned``. The path: 16-byte vectors along C where C divides
    into them; else, with ``flat3`` (#2), 16-byte vectors over the flat
    array where C = 3 and H·W·C divides into them (no vector spans two
    samples); else one element at a time. Then the fewest vectors a thread,
    K in ``PER_THREAD``, that fit the grid into one wave of
    ``SMS × RESIDENT_THREADS`` threads, so every block is resident and
    issues its loads before the wait; beyond 4 a wave, K = 4 and the blocks
    past the first wave run after it."""
    vec = 16 // element_size
    if aligned and c % vec == 0:
        path = "channels"
    elif aligned and flat3 and c == 3 and hwc % vec == 0:
        path = "flat3"
    else:
        path, vec = "element", 1
    vecs = numel // vec
    wave = SMS * RESIDENT_THREADS
    per_thread = next((k for k in PER_THREAD if vecs <= k * wave),
                      PER_THREAD[-1])
    return ApplyPlan(path, vec, per_thread,
                     -(-vecs // (per_thread * THREADS)))


def plan_for(x: torch.Tensor, y: torch.Tensor, flat3: bool = True
             ) -> ApplyPlan:
    """``apply_plan`` of a channels_last x and its output y; raises at
    2³¹ elements or more (the kernels index in 32 bits)."""
    _, c, h, w = x.shape
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{tuple(x.shape)}: #2 and #4 take fewer than 2^31 "
                         "elements")
    return apply_plan(x.numel(), h * w * c, c, x.element_size(),
                      x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0,
                      flat3)


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


def norm_act_quant_plain(x: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         sx: Optional[torch.Tensor] = None,
                         act: str = "none", slope: float = 0.2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of #4, in the kernel's op order:
    ``(q in x's dtype, amax 0-d f32)``."""
    yc = norm_act_plain(x, mean, rstd, scale, bias, None, act,
                        slope).float()
    q = torch.clamp(torch.round(yc / sx), -127.0, 127.0)
    return q.to(x.dtype), yc.abs().amax()


@functools.cache
def _arrival_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed pair of #4's launches on ``stream``: the block-arrival
    counter and the word that holds the max of the bits of |yc|. The
    launches on one stream run in order, and each leaves both at 0."""
    return torch.zeros((2,), dtype=torch.int32, device=device)


def norm_act_quant(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   sx: Optional[torch.Tensor] = None,
                   act: str = "none", slope: float = 0.2, *,
                   x_ready: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q = clip(round(act((x − mean)·rstd·γ + β) in x's dtype / sx),
    ±127)`` in x's dtype and ``max|act(...)|`` (0-d f32), for (N, C) f32
    statistics, an optional (C,) f32 affine and a 0-d f32 ``sx > 0``.
    ``x_ready=True`` says that the launch just before this one on the
    stream does not write x (so x was complete before it began; #1 of this
    x, as in ``ops/instance_norm.py``): the kernel then reads x before it
    waits for that launch to end."""
    if x.device.type == "cpu":
        return norm_act_quant_plain(x, mean, rstd, scale, bias, sx, act,
                                    slope)
    check_act(act, slope)
    check_apply_args(x, mean, rstd, scale, bias, "norm_act_quant")
    _check_vector(sx, (), x.device, "norm_act_quant: sx")
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = plan_for(x, y, flat3=False)
    stream = build.stream_handle(x.device)
    sync = _arrival_counter(x.device, stream)
    amax = torch.empty((), dtype=torch.float32, device=x.device)
    lib, fn = build.load("norm_act", "p2p_norm_act_quant")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), sx.data_ptr(),
                 y.data_ptr(), sync.data_ptr(), amax.data_ptr(),
                 build.DTYPE_CODES[x.dtype], x.numel(), h * w * c, c,
                 APPLY_PATHS.index(plan.path), plan.per_thread,
                 ACTS.index(act), slope, plan.blocks, THREADS,
                 int(x_ready), stream)
    build.check(lib, err, "norm_act_quant")
    norm_act_quant.launches += 1
    return y, amax


norm_act_quant.launches = 0
