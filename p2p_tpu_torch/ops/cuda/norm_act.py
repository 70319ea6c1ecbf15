"""The fused instance-norm apply + activation (+ residual): the Hopper kernel
and its plain version.

``norm_act(x, mean, rstd, scale, bias, residual, act, slope)`` computes
``act((x − mean)·rstd·γ + β [+ residual])`` in f32 and stores it in x's
dtype, for a channels_last (N, C, H, W) x and (N, C) f32 statistics. The
residual is added before the activation; ``act`` is ``"none"``, ``"relu"``
or ``"leaky"`` (slope > 0); the affine is optional.

Replaces ``p2p_tpu/ops/pallas/norm_act.py:_norm_act_local`` (kernel bodies
``_norm_act_kernel`` and ``_norm_act_res_kernel``). The kernel is
``csrc/norm_act.cu`` (``p2p_norm_act``): it is bound by device-memory
bytes (x and the residual read once, y written once; 3.35 TB/s on an H100
SXM), so it moves 16-byte vectors along C, with the activation and the
residual compiled in as template parameters; most of its launches on the
main path are small, so it is launched as #2 and #4 are (below).

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

#3, #4 and #2 (``instance_norm_kernel.instance_norm_apply``, the same
library's ``p2p_instance_norm_apply``) are launched as programmatic
dependents of the launch before them and share one launch plan,
``apply_plan``: one wave of 256-thread blocks up to a wave's worth of
vectors, 16-byte vectors along C, across pixels at C = 3 (#2 only), or one
element at a time. With ``x_ready=True`` (no launch that may still run
writes x or the residual: ``ops/instance_norm.py`` launches #1 of the same
x right before, whose finalize is a dependent of its pass 1) each block
issues its loads of x, and of #3's residual, before it waits for that
launch to end (the rule is in ``csrc/norm_act.cu``).

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
# paths of #2, #3 and #4 (csrc/norm_act.cu ApplyPath): 16-byte vectors along
# C, 16-byte vectors over the flat array at C = 3 (#2), one element at a
# time
APPLY_PATHS = ("channels", "flat3", "element")
PER_THREAD = (1, 2, 4)
# #3's vectors a thread: at K = 4 its kernel took 71-95 registers (two or
# three blocks an SM), so one wave of its blocks held no more vectors than
# at K = 1, and its 16-134 MB launches ran 5-8% slower than the grid-stride
# pass it replaced (PERF.md §6); the kernel takes K = 1 only
NORM_ACT_MAX_PER_THREAD = 1


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
    """What the normalize kernels take (#2, #3 and #4): a channels_last
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


class ApplyPlan(NamedTuple):
    path: str        # one of APPLY_PATHS
    vec: int         # elements a load
    per_thread: int  # K: thread t of block b takes the vectors
                     # (b·K + k)·THREADS + t, k < K
    blocks: int


def apply_plan(numel: int, hwc: int, c: int, element_size: int,
               aligned: bool, flat3: bool = True,
               max_per_thread: int = PER_THREAD[-1]) -> ApplyPlan:
    """Launch plan of #2, #3 and #4 over an (N, H, W, C) activation of
    ``numel`` elements (``hwc`` = H·W·C) whose x and y (and #3's residual)
    are 16-byte aligned when ``aligned``. The path: 16-byte vectors along
    C where C divides into them; else, with ``flat3`` (#2), 16-byte
    vectors over the flat array where C = 3 and H·W·C divides into them
    (no vector spans two samples); else one element at a time. Then the
    fewest vectors a thread, K in ``PER_THREAD`` up to ``max_per_thread``,
    that fit the grid into one wave of ``SMS × RESIDENT_THREADS`` threads,
    so every block is resident and issues its loads before the wait;
    beyond that, K = ``max_per_thread`` and the blocks past the first wave
    run after it."""
    vec = 16 // element_size
    if aligned and c % vec == 0:
        path = "channels"
    elif aligned and flat3 and c == 3 and hwc % vec == 0:
        path = "flat3"
    else:
        path, vec = "element", 1
    vecs = numel // vec
    wave = SMS * RESIDENT_THREADS
    ks = [k for k in PER_THREAD if k <= max_per_thread]
    per_thread = next((k for k in ks if vecs <= k * wave), ks[-1])
    return ApplyPlan(path, vec, per_thread,
                     -(-vecs // (per_thread * THREADS)))


def plan_for(x: torch.Tensor, y: torch.Tensor, flat3: bool = True,
             residual: Optional[torch.Tensor] = None,
             max_per_thread: int = PER_THREAD[-1]) -> ApplyPlan:
    """``apply_plan`` of a channels_last x, its output y and #3's residual
    (None without one); raises at 2³¹ elements or more (the kernels index
    in 32 bits)."""
    _, c, h, w = x.shape
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{tuple(x.shape)}: #2, #3 and #4 take fewer than "
                         "2^31 elements")
    tensors = (x, y) if residual is None else (x, y, residual)
    return apply_plan(x.numel(), h * w * c, c, x.element_size(),
                      all(t.data_ptr() % 16 == 0 for t in tensors), flat3,
                      max_per_thread)


def norm_act(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
             scale: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None,
             act: str = "none", slope: float = 0.2, *,
             x_ready: bool = False) -> torch.Tensor:
    """``act((x − mean)·rstd·γ + β [+ residual])`` in x's dtype.
    ``x_ready=True`` says that no launch that may still run writes x or the
    residual (the launch just before this one on the stream is #1 of this
    x, as in ``ops/instance_norm.py``): the kernel then reads both before
    it waits for that launch to end."""
    if x.device.type == "cpu":
        return norm_act_plain(x, mean, rstd, scale, bias, residual, act,
                              slope)
    check_act(act, slope)
    check_apply_args(x, mean, rstd, scale, bias, "norm_act")
    n, c, h, w = x.shape
    if residual is not None:
        build.check_activation(residual, "norm_act residual")
        if residual.shape != x.shape or residual.dtype != x.dtype \
                or residual.device != x.device:
            raise ValueError("norm_act: residual must match x in shape, "
                             "dtype and device")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = plan_for(x, y, flat3=False, residual=residual,
                    max_per_thread=NORM_ACT_MAX_PER_THREAD)
    lib, fn = build.load("norm_act", "p2p_norm_act")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 y.data_ptr(), build.DTYPE_CODES[x.dtype], x.numel(),
                 h * w * c, c, APPLY_PATHS.index(plan.path),
                 plan.per_thread, ACTS.index(act), slope, plan.blocks,
                 THREADS, int(x_ready), build.stream_handle(x.device))
    build.check(lib, err, "norm_act")
    build.count_launch(norm_act)
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
    build.count_launch(norm_act_quant)
    return y, amax


norm_act_quant.launches = 0
