"""Instance norm's two passes: the Hopper kernels and their plain versions.

``instance_norm_stats(x, eps)`` (#1) returns the per-(sample, channel) mean
and rstd of a channels_last (N, C, H, W) activation as two (N, C) f32
tensors: ``mean = Σx / HW``, ``var = max(Σx² / HW − mean², 0)``,
``rstd = rsqrt(var + eps)``, accumulated in f32. It replaces
``p2p_tpu/ops/pallas/instance_norm_kernel.py:_stats_local`` (the stats
pass, kernel body ``_stats_kernel``) and the mean/rstd arithmetic of
``p2p_tpu/ops/pallas/norm_act.py:_fwd_impl``. The kernel is
``csrc/instance_norm_stats.cu``: it is bound by device-memory bytes (x read
once, 2·N·C floats written; 3.35 TB/s on an H100 SXM), so it reads x in
16-byte vectors along C, splits H×W into chunks across blocks so the
largest extents fill every SM, and sums the per-chunk partials in a second
short pass in a fixed order: no float atomics, the same bits on every run.

``instance_norm_apply(x, mean, rstd, scale, bias)`` (#2) is the act-free
normalize pass ``y = (x − mean)·rstd·γ + β``, computed in f32 and stored
in x's dtype. It replaces ``instance_norm_kernel.py:_norm_local`` (kernel
body ``_norm_kernel``): the ``p2p_instance_norm_apply`` entry point of
``csrc/norm_act.cu``. Like #3 it is bound by bytes (x read once, y written
once), but its launches are small and follow #1's finalize, so it is
launched as a programmatic dependent of the launch before it, in one wave
of 16-byte vectors (``norm_act.apply_plan``: along C, across pixels at
C = 3, the ExpandNetwork's head, or one element at a time), and with
``x_ready=True`` reads x before it waits for #1 to end.

Under a spatial mesh (x one rank's block of rows, ops/instance_norm.py)
#1 is split at the collective: ``instance_norm_sums(x)`` stops at the
fixed-order (N, C) f32 Σx and Σx² of pass 1 (``p2p_instance_norm_sums``),
the caller all-reduces them over the spatial group, and
``instance_norm_finalize(s1, s2, count, eps)`` turns the global sums and
the global count (Σ of the ranks' H·W) into mean and rstd with #1's
arithmetic (``p2p_instance_norm_finalize``, an ordinary launch after the
collective). Replaces the sharded ``_fwd_impl`` of
``instance_norm_kernel.py:115-130`` and ``norm_act.py:102-112``.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from p2p_tpu_torch.ops.cuda import build
from p2p_tpu_torch.ops.cuda.norm_act import APPLY_PATHS, THREADS, \
    affine_fma, check_apply_args, plan_for

REPLACES = "p2p_tpu/ops/pallas/instance_norm_kernel.py:79 (_stats_local)"
SOURCE = "p2p_tpu_torch/ops/cuda/csrc/instance_norm_stats.cu"
REPLACES_SUMS = ("p2p_tpu/ops/pallas/instance_norm_kernel.py:188 "
                 "(instance_norm_fused_sharded, _stats_local + psum)")
REPLACES_FINALIZE = ("p2p_tpu/ops/pallas/instance_norm_kernel.py:115 "
                     "(_fwd_impl, the sharded mean/rstd)")
REPLACES_APPLY = "p2p_tpu/ops/pallas/instance_norm_kernel.py:105 (_norm_local)"
SOURCE_APPLY = "p2p_tpu_torch/ops/cuda/csrc/norm_act.cu"

# blocks of pass 1 to aim for: about eight per SM of the 132 on an H100
_TARGET_BLOCKS = 1024
_THREADS = 256


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: same sums, same formula."""
    x32 = x.float()
    count = float(x.shape[2] * x.shape[3])
    mean = x32.sum(dim=(2, 3)) / count
    var = ((x32 * x32).sum(dim=(2, 3)) / count - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm_sums_plain(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) Σx and Σx² over H×W in f32, (N, C) each."""
    x32 = x.float()
    return x32.sum(dim=(2, 3)), (x32 * x32).sum(dim=(2, 3))


def instance_norm_finalize_plain(s1: torch.Tensor, s2: torch.Tensor,
                                 count: float, eps: float = 1e-5
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mean = s1 / count``, ``var = max(s2 / count − mean², 0)``,
    ``rstd = rsqrt(var + eps)``; the count a 0-d tensor, so that a CUDA
    tensor divides by it as the kernel does (not by its reciprocal)."""
    n = s1.new_full((), count)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


class StatsGeometry(NamedTuple):
    vec: int      # elements per thread access along C
    tx: int       # threads along C
    ty: int       # threads along pixels
    cblocks: int  # blocks along C
    num_p: int    # pixel chunks (blocks along H×W)
    chunk: int    # pixels per chunk


def stats_geometry(n: int, hw: int, c: int, vec: int) -> StatsGeometry:
    """Launch shape of pass 1: 256 threads, as many along C as one 16-byte
    vector each covers (at most 32), the rest along pixels; then enough
    pixel chunks that N·cblocks·P reaches ``_TARGET_BLOCKS``, with at least
    two loads per thread in each chunk (fewer would make the partials a
    large share of the bytes moved)."""
    cv = -(-c // vec)
    tx = min(cv, 32)
    ty = _THREADS // tx
    cblocks = -(-cv // tx)
    want = -(-_TARGET_BLOCKS // (n * cblocks))
    num_p = max(1, min(want, -(-hw // (2 * ty)), 65535))
    chunk = -(-hw // num_p)
    return StatsGeometry(vec, tx, ty, cblocks, -(-hw // chunk), chunk)


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) mean and rstd of x (N, C, H, W) as (N, C) f32."""
    if x.device.type == "cpu":
        return instance_norm_stats_plain(x, eps)
    build.check_activation(x, "instance_norm_stats")
    n, c, h, w = x.shape
    g = stats_geometry(n, h * w, c, build.vector_width(c, x))
    part = torch.empty((2, n, g.num_p, c), device=x.device,
                       dtype=torch.float32)
    mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    lib, fn = build.load("instance_norm_stats", "p2p_instance_norm_stats")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), build.DTYPE_CODES[x.dtype], n, h * w, c,
                 g.vec, g.tx, g.ty, g.cblocks, g.num_p, g.chunk,
                 part[0].data_ptr(), part[1].data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), eps, build.stream_handle(x.device))
    build.check(lib, err, "instance_norm_stats")
    build.count_launch(instance_norm_stats)
    return mean, rstd


instance_norm_stats.launches = 0


def instance_norm_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) Σx and Σx² of x (N, C, H, W) over its H×W, as (N, C) f32
    (pass 1 of #1 and the fixed-order sum of its partials)."""
    if x.device.type == "cpu":
        return instance_norm_sums_plain(x)
    build.check_activation(x, "instance_norm_sums")
    n, c, h, w = x.shape
    g = stats_geometry(n, h * w, c, build.vector_width(c, x))
    part = torch.empty((2, n, g.num_p, c), device=x.device,
                       dtype=torch.float32)
    sums = torch.empty((2, n, c), device=x.device, dtype=torch.float32)
    lib, fn = build.load("instance_norm_stats", "p2p_instance_norm_sums")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), build.DTYPE_CODES[x.dtype], n, h * w, c,
                 g.vec, g.tx, g.ty, g.cblocks, g.num_p, g.chunk,
                 part[0].data_ptr(), part[1].data_ptr(), sums[0].data_ptr(),
                 sums[1].data_ptr(), build.stream_handle(x.device))
    build.check(lib, err, "instance_norm_sums")
    build.count_launch(instance_norm_sums)
    return sums[0], sums[1]


instance_norm_sums.launches = 0


def instance_norm_finalize(s1: torch.Tensor, s2: torch.Tensor, count: float,
                           eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and rstd, (N, C) f32, from the global (N, C) f32 sums and the
    global count (a host number: no read of the device)."""
    if s1.device.type == "cpu":
        return instance_norm_finalize_plain(s1, s2, count, eps)
    for t, what in ((s1, "s1"), (s2, "s2")):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != s1.shape:
            raise ValueError(f"instance_norm_finalize: {what} must be a "
                             "contiguous f32 CUDA tensor of s1's shape")
    mean = torch.empty_like(s1)
    rstd = torch.empty_like(s1)
    lib, fn = build.load("instance_norm_stats", "p2p_instance_norm_finalize")
    with torch.cuda.device(s1.device):
        err = fn(s1.data_ptr(), s2.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), s1.numel(), float(count), eps,
                 build.stream_handle(s1.device))
    build.check(lib, err, "instance_norm_finalize")
    build.count_launch(instance_norm_finalize)
    return mean, rstd


instance_norm_finalize.launches = 0


def instance_norm_apply_plain(x: torch.Tensor, mean: torch.Tensor,
                              rstd: torch.Tensor,
                              scale: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version of #2, in the kernel's op order."""
    y = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    if scale is not None:
        y = affine_fma(y, scale, bias)
    return y.to(x.dtype)


def instance_norm_apply(x: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None, *,
                        x_ready: bool = False) -> torch.Tensor:
    """``(x − mean)·rstd·γ + β`` in x's dtype, for (N, C) f32 statistics
    and an optional (C,) f32 affine. ``x_ready=True`` says that the
    launch just before this one on the stream does not write x (so x was
    complete before it began; #1 of this x, as in
    ``ops/instance_norm.py``): the kernel then reads x before it waits for
    that launch to end."""
    if x.device.type == "cpu":
        return instance_norm_apply_plain(x, mean, rstd, scale, bias)
    check_apply_args(x, mean, rstd, scale, bias, "instance_norm_apply")
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = plan_for(x, y)
    lib, fn = build.load("norm_act", "p2p_instance_norm_apply")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 build.DTYPE_CODES[x.dtype], x.numel(), h * w * c, c,
                 APPLY_PATHS.index(plan.path), plan.per_thread, plan.blocks,
                 THREADS, int(x_ready), build.stream_handle(x.device))
    build.check(lib, err, "instance_norm_apply")
    build.count_launch(instance_norm_apply)
    return y


instance_norm_apply.launches = 0
