"""The fused instance-norm seam: ``norm(x)·γ+β`` and the whole post-conv
epilogue ``act(norm(x)·γ+β [+ residual])``, each with its closed-form
backward.

Counterparts of ``p2p_tpu/ops/pallas/instance_norm_kernel.py:
instance_norm_fused`` (``_in_fused`` / ``_in_fused_bwd``: the statistics
kernel #1, then the normalize kernel #2) and ``p2p_tpu/ops/pallas/
norm_act.py:instance_norm_act_fused`` (``_in_act_fused`` /
``_in_act_fused_bwd``: #1, then the fused normalize + activation kernel
#3). Every call goes through a ``torch.autograd.Function``, on the CPU and
on the card alike: its forward calls the kernel wrappers (the kernel on a
CUDA tensor, the plain version on a CPU one), and its backward is the
closed form of the JAX package in plain PyTorch, in f32, cast once at the
end. The JAX package has no backward kernel for #1, #2 or #3: its VJPs
are XLA closed forms.

Backward, with ``count = H·W``, ``xhat = (x − μ)·rstd`` and the upstream
cotangent ``g`` in f32: ``dxhat = g·γ``; ``m1 = Σ_HW dxhat / count``;
``m2 = Σ_HW dxhat·xhat / count``; ``dx = rstd·(dxhat − m1 − xhat·m2)``;
with the affine, ``dγ = Σ_NHW g·xhat`` and ``dβ = Σ_NHW g``. The epilogue
form saves its OUTPUT ``y`` (not the pre-activation) and masks ``g`` from
it first: relu ``y > 0``, leaky ``y >= 0 ? g : slope·g`` (sign-preserving
activations only); the residual's cotangent is that masked ``g``, cast to
the residual's dtype.

The quantize-fused epilogue (``instance_norm_act_quant``, counterpart of
``p2p_tpu/ops/pallas/norm_act.py:instance_norm_act_quant`` with its
``_in_act_quant`` VJP) returns ``(q, amax)``: #1, then #4 with a stored
scale ``sx``; with ``use_kernel=False`` the JAX lax reference instead
(two-pass mean and variance, plain PyTorch), under the same backward. Its
backward is the straight-through law of the delayed-int8 path: the
cotangent of q is w.r.t. the dequantized surrogate ``sx·q`` and passes
clip/round unchanged; the activation mask comes from the recomputed
pre-activation ``h = xhat·γ + β`` (relu ``h > 0``, leaky ``h >= 0``),
since round() erased the sign near zero; then the closed form above.
``sx`` and ``amax`` get no gradient.

Under a spatial mesh (x one rank's block of rows, core/mesh.spatial_mesh;
the JAX ``instance_norm_fused_sharded`` and ``instance_norm_act_fused_
sharded``, ``p2p_tpu/ops/pallas/instance_norm.py:67-131``): #1's sums
entry on the rank's rows, ONE all-reduce (SUM) of the (2, N, C) sums over
the spatial group, #1's finalize with the global count (the map's global
height times W: Σ of the ranks' H·W), then #2 or #3 on the rank's rows
fed the global statistics; in the backward m1 and m2 are summed the same
way (one all-reduce of (2, N, C)) and divided by the global count, and dγ
and dβ stay this rank's, which the step's gradient sum over the spatial
group adds up. Each all-reduce is counted (``sharded_stats.allreduces``,
``sharded_stats.backward_allreduces``). The quantize-fused form (#4) has
no sharded form in JAX either and refuses a spatial mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

import torch.distributed as dist

from p2p_tpu_torch.core.mesh import (SPATIAL_AXIS, keep_rows, rows_of,
                                     spatial_mesh)
from p2p_tpu_torch.ops.conv import taped
from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
    instance_norm_apply, instance_norm_finalize, instance_norm_stats,
    instance_norm_sums)
from p2p_tpu_torch.ops.cuda.norm_act import norm_act, norm_act_quant, \
    norm_act_quant_plain


def sharded_stats(x: torch.Tensor, eps: float):
    """``(mean, rstd, mesh)`` of x: #1 on one device (mesh None), or
    under a spatial mesh the sums entry, one all-reduce of the (2, N, C)
    sums over the spatial group and the finalize with the global count."""
    mesh = spatial_mesh()
    if mesh is None:
        mean, rstd = taped(lambda: instance_norm_stats(x, eps))
        return mean, rstd, None
    group = mesh.group(SPATIAL_AXIS)
    s1, s2 = instance_norm_sums(x)
    buf = torch.stack([s1, s2])
    dist.all_reduce(buf, group=group)
    sharded_stats.allreduces += 1
    mean, rstd = instance_norm_finalize(buf[0], buf[1],
                                        float(rows_of(x) * x.shape[3]), eps)
    return mean, rstd, mesh


sharded_stats.allreduces = 0
sharded_stats.backward_allreduces = 0


def _norm_backward(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   scale: Optional[torch.Tensor], g32: torch.Tensor,
                   mesh=None, count: Optional[float] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """(dx in x's dtype, dγ, dβ) of ``(x − μ)·rstd·γ + β`` from the f32
    cotangent ``g32``; dγ and dβ are None without the affine. With a
    spatial ``mesh`` m1 and m2 are summed over its spatial group and
    divided by the global ``count``."""
    mean = mean[:, :, None, None]
    rstd = rstd[:, :, None, None]
    xhat = (x.float() - mean) * rstd
    dxhat = g32 if scale is None else g32 * scale.float()[None, :, None,
                                                          None]
    if mesh is None:
        count = float(x.shape[2] * x.shape[3])
        m1 = dxhat.sum(dim=(2, 3), keepdim=True) / count
        m2 = (dxhat * xhat).sum(dim=(2, 3), keepdim=True) / count
    else:
        buf = torch.stack([dxhat.sum(dim=(2, 3), keepdim=True),
                           (dxhat * xhat).sum(dim=(2, 3), keepdim=True)])
        dist.all_reduce(buf, group=mesh.group(SPATIAL_AXIS))
        sharded_stats.backward_allreduces += 1
        m1, m2 = buf[0] / count, buf[1] / count
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    if scale is None:
        return dx, None, None
    dscale = (g32 * xhat).sum(dim=(0, 2, 3)).to(scale.dtype)
    return dx, dscale, g32.sum(dim=(0, 2, 3)).to(scale.dtype)


class _InstanceNorm(torch.autograd.Function):
    """#1 then #2; saves x, the statistics and γ."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, rstd, mesh = sharded_stats(x, eps)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.mesh, ctx.count = mesh, _count(x, mesh)
        return instance_norm_apply(x, mean, rstd, scale, bias,
                                   x_ready=True)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        dx, dscale, dbias = _norm_backward(x, mean, rstd, scale, g.float(),
                                           ctx.mesh, ctx.count)
        return dx, dscale, dbias, None


class _InstanceNormAct(torch.autograd.Function):
    """#1 then #3; saves x, the statistics, γ and the output y."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, act, slope, eps):
        mean, rstd, mesh = sharded_stats(x, eps)
        y = norm_act(x, mean, rstd, scale, bias, residual, act, slope,
                     x_ready=True)
        ctx.save_for_backward(x, mean, rstd, scale, y)
        ctx.mesh, ctx.count = mesh, _count(x, mesh)
        ctx.act, ctx.slope = act, slope
        ctx.res_dtype = None if residual is None else residual.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale, y = ctx.saved_tensors
        g32 = g.float()
        if ctx.act == "relu":
            g32 = torch.where(y > 0, g32, 0.0)
        elif ctx.act == "leaky":
            g32 = torch.where(y >= 0, g32, ctx.slope * g32)
        dx, dscale, dbias = _norm_backward(x, mean, rstd, scale, g32,
                                           ctx.mesh, ctx.count)
        dres = None if ctx.res_dtype is None else g32.to(ctx.res_dtype)
        return dx, dscale, dbias, dres, None, None, None


def _count(x: torch.Tensor, mesh) -> Optional[float]:
    """The global H·W of a spatial norm (None on one device)."""
    return None if mesh is None else float(rows_of(x) * x.shape[3])


def instance_norm_fused(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over H×W of a channels_last (N, C, H, W) tensor, with
    an optional (C,) f32 affine; the output has x's dtype (#1 + #2)."""
    return keep_rows(_InstanceNorm.apply(x, scale, bias, eps), x)


def instance_norm_act(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      act: str = "none", slope: float = 0.2,
                      eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over H×W of a channels_last (N, C, H, W) tensor with
    the whole post-conv epilogue fused; the output has x's dtype (#1 +
    #3)."""
    return keep_rows(_InstanceNormAct.apply(x, scale, bias, residual, act,
                                            slope, eps), x)


class _InstanceNormActQuant(torch.autograd.Function):
    """#1 then #4 (``use_kernel``), or the lax reference; saves x, the
    statistics and the affine."""

    @staticmethod
    def forward(ctx, x, scale, bias, sx, act, slope, eps, use_kernel):
        sx = sx.float().clamp_min(1e-12)
        if use_kernel:
            mean, rstd = taped(lambda: instance_norm_stats(x, eps))
            q, amax = norm_act_quant(x, mean, rstd, scale, bias, sx, act,
                                     slope, x_ready=True)
        else:
            x32 = x.float()
            m = x32.mean(dim=(2, 3), keepdim=True)
            var = (x32 - m).square().mean(dim=(2, 3), keepdim=True)
            mean, rstd = m[:, :, 0, 0], torch.rsqrt(var + eps)[:, :, 0, 0]
            q, amax = norm_act_quant_plain(x, mean, rstd, scale, bias, sx,
                                           act, slope)
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.act, ctx.slope = act, slope
        ctx.mark_non_differentiable(amax)
        return q, amax

    @staticmethod
    def backward(ctx, g, _g_amax):
        x, mean, rstd, scale, bias = ctx.saved_tensors
        g32 = g.float()
        if ctx.act != "none":
            xhat = (x.float() - mean[:, :, None, None]) * rstd[:, :, None,
                                                               None]
            h = xhat if scale is None else (
                xhat * scale.float()[None, :, None, None]
                + bias.float()[None, :, None, None])
            if ctx.act == "relu":
                g32 = torch.where(h > 0, g32, 0.0)
            else:
                g32 = torch.where(h >= 0, g32, ctx.slope * g32)
        dx, dscale, dbias = _norm_backward(x, mean, rstd, scale, g32)
        return dx, dscale, dbias, None, None, None, None, None


def instance_norm_act_quant(x: torch.Tensor, sx: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None,
                            act: str = "none", slope: float = 0.2,
                            eps: float = 1e-5, use_kernel: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-fused ``act(instance_norm(x)·γ+β)`` of a channels_last
    (N, C, H, W) tensor: ``(q, amax)``, q the activation clipped and
    rounded onto the int8 grid with the stored scale ``sx`` (0-d f32),
    carried in x's dtype, and amax its max |value| (0-d f32). Feed q to
    ``ops.int8.int8_conv_pq`` with the same ``sx``. Refuses a spatial mesh
    (the JAX package has no sharded form of #4)."""
    if spatial_mesh() is not None:
        raise NotImplementedError(
            "the quantize-fused epilogue (#4) has no form under a spatial "
            "mesh: the JAX package runs it on whole maps only")
    return _InstanceNormActQuant.apply(x, scale, bias, sx, act, slope, eps,
                                       use_kernel)
