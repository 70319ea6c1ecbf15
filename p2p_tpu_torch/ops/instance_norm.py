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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from p2p_tpu_torch.ops.conv import taped
from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
    instance_norm_apply, instance_norm_stats)
from p2p_tpu_torch.ops.cuda.norm_act import norm_act, norm_act_quant, \
    norm_act_quant_plain


def _norm_backward(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   scale: Optional[torch.Tensor], g32: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """(dx in x's dtype, dγ, dβ) of ``(x − μ)·rstd·γ + β`` from the f32
    cotangent ``g32``; dγ and dβ are None without the affine."""
    count = float(x.shape[2] * x.shape[3])
    mean = mean[:, :, None, None]
    rstd = rstd[:, :, None, None]
    xhat = (x.float() - mean) * rstd
    dxhat = g32 if scale is None else g32 * scale.float()[None, :, None,
                                                          None]
    m1 = dxhat.sum(dim=(2, 3), keepdim=True) / count
    m2 = (dxhat * xhat).sum(dim=(2, 3), keepdim=True) / count
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    if scale is None:
        return dx, None, None
    dscale = (g32 * xhat).sum(dim=(0, 2, 3)).to(scale.dtype)
    return dx, dscale, g32.sum(dim=(0, 2, 3)).to(scale.dtype)


class _InstanceNorm(torch.autograd.Function):
    """#1 then #2; saves x, the statistics and γ."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, rstd = taped(lambda: instance_norm_stats(x, eps))
        ctx.save_for_backward(x, mean, rstd, scale)
        return instance_norm_apply(x, mean, rstd, scale, bias,
                                   x_ready=True)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        dx, dscale, dbias = _norm_backward(x, mean, rstd, scale, g.float())
        return dx, dscale, dbias, None


class _InstanceNormAct(torch.autograd.Function):
    """#1 then #3; saves x, the statistics, γ and the output y."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, act, slope, eps):
        mean, rstd = taped(lambda: instance_norm_stats(x, eps))
        y = norm_act(x, mean, rstd, scale, bias, residual, act, slope,
                     x_ready=True)
        ctx.save_for_backward(x, mean, rstd, scale, y)
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
        dx, dscale, dbias = _norm_backward(x, mean, rstd, scale, g32)
        dres = None if ctx.res_dtype is None else g32.to(ctx.res_dtype)
        return dx, dscale, dbias, dres, None, None, None


def instance_norm_fused(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over H×W of a channels_last (N, C, H, W) tensor, with
    an optional (C,) f32 affine; the output has x's dtype (#1 + #2)."""
    return _InstanceNorm.apply(x, scale, bias, eps)


def instance_norm_act(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      act: str = "none", slope: float = 0.2,
                      eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over H×W of a channels_last (N, C, H, W) tensor with
    the whole post-conv epilogue fused; the output has x's dtype (#1 +
    #3)."""
    return _InstanceNormAct.apply(x, scale, bias, residual, act, slope, eps)


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
    ``ops.int8.int8_conv_pq`` with the same ``sx``."""
    return _InstanceNormActQuant.apply(x, scale, bias, sx, act, slope, eps,
                                       use_kernel)
