"""Normalization (counterparts of ``p2p_tpu/ops/norm.py:37 dual_moments``,
``:86 _FastBatchNorm``, ``:224 make_norm_act`` and ``:288 make_norm``).

Kinds in this port: ``"batch"`` (BatchNorm with running statistics, its
moments through the Hopper kernel ops/cuda/batch_moments.py),
``"pallas_instance"`` (instance norm through the Hopper kernels with the
closed-form backward, ops/instance_norm.py: #1 + #2 for the norm, #1 + #3
for the fused epilogue), ``"instance"`` (plain PyTorch, the op order of the
JAX ``InstanceNorm`` module) and ``"none"``. The stateless kinds
are plain functions on tensors; ``"batch"`` is a module, built per call
site with its channel count, so the factories take ``features`` for it.

Sync-BatchNorm (``ParallelConfig.sync_batchnorm``, on by default): inside
a data-parallel step (a mesh made visible by ``core/mesh.mesh_context``)
each rank runs kernel #5 on its own (M/W, C) rows, then ONE all-reduce
(SUM) of the (2, C) f32 buffer (Σx, Σx²) over the batch group; mean and
variance divide by the global count, so the running statistics move
identically on every rank. Its backward all-reduces the cotangents of the
two sums before the closed form ``dxc = ds + 2·xc·dss``: each rank's
gradient then carries every rank's loss terms, which the gradient average
(parallel/dp.py) divides by the world size. Each of the two all-reduces
is counted (``sync_moments.allreduces``, ``sync_moments.backward_
allreduces``). Under a spatial mesh the moments are summed over data ×
fsdp × spatial (the world) with the rank's row count
riding in the same buffer, so the count is exact on uneven rows.

Under a spatial mesh (x one rank's block of rows) the plain
``instance_norm`` computes its two-pass statistics as ``jnp.mean`` and
``jnp.var`` do under GSPMD: the sum of x over the spatial group, the mean,
then the sum of (x − μ)² over the group (two differentiable all-reduces),
each divided by the global count. Every epilogue passes its input's row
layout on (core/mesh.keep_rows).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from p2p_tpu_torch.core.mesh import (current_mesh, keep_rows, rows_of,
                                     spatial_mesh)
from p2p_tpu_torch.ops.conv import taped

from p2p_tpu_torch.ops.activations import leaky_relu_y, relu_y
from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments
from p2p_tpu_torch.ops.instance_norm import instance_norm_act, \
    instance_norm_act_quant, instance_norm_fused

EpilogueFn = Callable[..., torch.Tensor]
# the kinds of make_norm / make_norm_act
NORM_KINDS = ("batch", "instance", "pallas_instance", "none")


class _DualMoments(torch.autograd.Function):
    """(Σxc, Σxc²) per column of an (M, C) tensor through the kernel
    wrapper, with the closed-form VJP of the JAX ``dual_moments``
    (``p2p_tpu/ops/norm.py:77-80``): ``dxc = ds + 2·xc·dss`` in f32, cast
    to xc's dtype."""

    @staticmethod
    def forward(ctx, xc):
        ctx.save_for_backward(xc)
        return taped(lambda: batch_moments(xc))

    @staticmethod
    def backward(ctx, ds, dss):
        (xc,) = ctx.saved_tensors
        dxc = ds[None, :] + 2.0 * xc.float() * dss[None, :]
        return dxc.to(xc.dtype)


def dual_moments(xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σxc, Σxc²) of an (M, C) tensor in f32, one read of xc
    (the Hopper kernel on a CUDA tensor, the plain version on the CPU)."""
    return _DualMoments.apply(xc)


_SYNC_BN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "p2p_tpu_torch_sync_batchnorm", default=True)


@contextlib.contextmanager
def sync_batchnorm(enabled: bool) -> Iterator[None]:
    """Whether BatchNorm sums its moments over the active mesh's batch
    group (``ParallelConfig.sync_batchnorm``; False: each rank's own)."""
    token = _SYNC_BN.set(bool(enabled))
    try:
        yield
    finally:
        _SYNC_BN.reset(token)


class _SyncMoments(torch.autograd.Function):
    """The all-reduce (SUM) of a rank's (Σx, Σx²) over ``group`` as one
    (2, C) f32 buffer; the backward all-reduces the two cotangents the
    same way."""

    @staticmethod
    def forward(ctx, s1, s2, group, count):
        ctx.group = group

        def reduce():
            if count is None:
                buf = torch.stack([s1, s2])
            else:
                buf = torch.cat([s1, s2, s1.new_full((1,), float(count))])
            dist.all_reduce(buf, group=group)
            sync_moments.allreduces += 1
            if count is None:
                return buf[0], buf[1]
            c = s1.shape[0]
            return buf[:c], buf[c:2 * c], buf[2 * c:]

        return taped(reduce)

    @staticmethod
    def backward(ctx, ds, dss, *_):
        buf = torch.stack([ds, dss])
        dist.all_reduce(buf, group=ctx.group)
        sync_moments.backward_allreduces += 1
        return buf[0], buf[1], None, None


def sync_moments(xc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(Σxc, Σxc², count)`` of an (M, C) tensor over the global batch:
    :func:`dual_moments` on this rank's rows, then, inside a
    data-parallel step with sync-BatchNorm on, one all-reduce over the
    mesh's batch group (``count`` is then M times the batch shards)."""
    s1, s2 = dual_moments(xc)
    mesh = current_mesh()
    if mesh is None or not _SYNC_BN.get():
        return s1, s2, xc.shape[0]
    if mesh.spatial > 1:
        # data x fsdp x spatial, the world; the rows differ by rank on
        # uneven maps
        s1, s2, n = _SyncMoments.apply(s1, s2, None, xc.shape[0])
        return s1, s2, n.reshape(())
    s1, s2 = _SyncMoments.apply(s1, s2, mesh.batch_group, None)
    return s1, s2, xc.shape[0] * mesh.batch_shards


sync_moments.allreduces = 0
sync_moments.backward_allreduces = 0


class BatchNorm(nn.Module):
    """The JAX ``_FastBatchNorm`` over (N, H, W) of an (N, C, H, W) tensor.

    In training the moments are shifted by the running mean ``c`` (cast to
    x's dtype, no gradient): ``xc = x − c``, ``mean = Σxc/n + c``
    (Σ and n over the global batch under sync-BatchNorm),
    ``var = max(Σxc²/n − (Σxc/n)², 0)`` (biased), and the running
    statistics move as ``r ← 0.9·r + 0.1·stat`` (flax momentum 0.9, torch
    momentum 0.1) in place. The folded affine ``a = γ·rsqrt(var + ε)``,
    ``b = β − mean·a`` is computed in f32 and applied as ``x·a + b`` in x's
    dtype. Names are flax's: ``scale`` (γ ~ N(1, 0.02) at init), ``bias``,
    and the buffers ``mean`` and ``var``.
    """

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        if self.training:
            shift = self.mean.to(x.dtype)
            xc = x - shift.view(1, c, 1, 1)
            s1, s2, n = sync_moments(xc.permute(0, 2, 3, 1).reshape(-1, c))
            mean_c = s1 / n
            mean = mean_c + shift.float()
            var = torch.maximum(s2 / n - mean_c * mean_c, s2.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        a = self.scale * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        return keep_rows(x * a.to(x.dtype).view(1, c, 1, 1)
                         + b.to(x.dtype).view(1, c, 1, 1), x)


def _epilogue(z: torch.Tensor, act: str, slope: float,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    """[+ residual] → activation, the JAX reference chain's order."""
    if residual is not None:
        z = keep_rows(z + residual, z)
    if act == "relu":
        return relu_y(z)
    if act == "leaky":
        return leaky_relu_y(z, slope)
    if act != "none":
        raise ValueError(f"unknown act {act!r}")
    return z


def _refuse_quant(kind: str) -> None:
    raise ValueError("quant_scale needs a stateless instance-family norm "
                     f"with no residual (kind={kind!r})")


class BatchNormAct(BatchNorm):
    """The ``"batch"`` kind of :func:`make_norm_act`: a BatchNorm whose
    call takes the epilogue's ``act``, ``slope`` and ``residual``."""

    def forward(self, y: torch.Tensor, act: str = "none", slope: float = 0.2,
                residual: Optional[torch.Tensor] = None,
                quant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        if quant_scale is not None:
            _refuse_quant("batch")
        return _epilogue(super().forward(y), act, slope, residual)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel norm over H, W with statistics in f32 and
    the result in x's dtype (the JAX ``InstanceNorm`` without affine)."""
    x32 = x.float()
    if spatial_mesh() is not None:
        from p2p_tpu_torch.parallel.spatial import all_reduce_sum

        count = rows_of(x) * x.shape[3]
        mean = all_reduce_sum(x32.sum(dim=(2, 3), keepdim=True)) / count
        var = all_reduce_sum((x32 - mean).square().sum(
            dim=(2, 3), keepdim=True)) / count
        return keep_rows(((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype),
                         x)
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _need_features(kind: str, features: Optional[int]) -> int:
    if features is None:
        raise ValueError(f"norm kind {kind!r} needs the channel count")
    return features


def make_norm(kind: str, features: Optional[int] = None
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The norm of ``kind`` as a callable on one tensor (a module for
    ``"batch"``, which needs ``features``)."""
    if kind == "batch":
        return BatchNorm(_need_features(kind, features))
    if kind == "instance":
        return instance_norm
    if kind == "pallas_instance":
        return instance_norm_fused
    if kind == "none":
        return lambda x: x
    raise ValueError(f"unknown norm kind {kind!r}")


def make_norm_act(kind: str, features: Optional[int] = None) -> EpilogueFn:
    """The post-conv epilogue ``apply(y, act="none", slope=0.2,
    residual=None, quant_scale=None)`` = act(norm(y) [+ residual]).
    ``pallas_instance`` fuses the chain into the kernels' normalize pass;
    ``"batch"`` is a :class:`BatchNormAct` module (needs ``features``); the
    other kinds run norm → residual add → activation in y's dtype, as the
    JAX reference chain does. With ``quant_scale`` (a 0-d f32 stored
    scale) the instance kinds return the quantize-fused ``(q, amax)``
    (ops/instance_norm.py ``instance_norm_act_quant``: #1 + #4 for
    ``pallas_instance``, the lax reference for ``instance``); it takes no
    residual, and the other kinds refuse it."""
    if kind == "batch":
        return BatchNormAct(_need_features(kind, features))
    if kind == "pallas_instance":
        def apply_fused(y: torch.Tensor, act: str = "none",
                        slope: float = 0.2,
                        residual: Optional[torch.Tensor] = None,
                        quant_scale: Optional[torch.Tensor] = None):
            if quant_scale is not None:
                if residual is not None:
                    raise ValueError(
                        "quant_scale does not compose with residual (no "
                        "quantized resblock tail in the zoo)")
                return instance_norm_act_quant(y, quant_scale, act=act,
                                               slope=slope)
            return instance_norm_act(y, residual=residual, act=act,
                                     slope=slope)

        return apply_fused

    norm = make_norm(kind)

    def apply_ref(y: torch.Tensor, act: str = "none", slope: float = 0.2,
                  residual: Optional[torch.Tensor] = None,
                  quant_scale: Optional[torch.Tensor] = None):
        if quant_scale is not None:
            if kind != "instance" or residual is not None:
                _refuse_quant(kind)
            return instance_norm_act_quant(y, quant_scale, act=act,
                                           slope=slope, use_kernel=False)
        return _epilogue(norm(y), act, slope, residual)

    return apply_ref
