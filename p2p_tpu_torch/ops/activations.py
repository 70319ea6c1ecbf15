"""Activations (counterparts of ``p2p_tpu/ops/activations.py:26 PReLU`` and
``:44-102`` ``leaky_relu_y``, ``relu_y`` and ``tanh_y``).

``relu_y``, ``leaky_relu_y`` and ``tanh_y`` carry the JAX package's
gradients, which are computed from the OUTPUT: the mask ``y > 0`` (relu),
``y >= 0`` (leaky, slope > 0 preserves the sign) and ``1 − y²`` (tanh). The
backward then keeps the output, which the next layer holds anyway, instead
of the input. Under a spatial mesh each keeps its input's row layout
(core/mesh.keep_rows).

``PReLU`` is one learned scalar (init 0.25) shared over all channels;
ExpandNetwork builds one and calls it at every site, as the reference does.
"""

from __future__ import annotations

import torch
from torch import nn

from p2p_tpu_torch.core.mesh import keep_rows


class _ReluY(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g, torch.zeros_like(g))


class _LeakyReluY(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        y = torch.where(x >= 0, x, slope * x)
        ctx.save_for_backward(y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, g, ctx.slope * g), None


class _TanhY(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (1 - y * y)


def relu_y(x: torch.Tensor) -> torch.Tensor:
    return keep_rows(_ReluY.apply(x), x)


def leaky_relu_y(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    if slope <= 0:
        raise ValueError(f"leaky_relu_y needs slope > 0 (got {slope})")
    return keep_rows(_LeakyReluY.apply(x, slope), x)


def tanh_y(x: torch.Tensor) -> torch.Tensor:
    return keep_rows(_TanhY.apply(x), x)


class PReLU(nn.Module):
    """``max(x, 0) + α·min(x, 0)`` with one f32 scalar α cast to x's dtype.
    ``torch.maximum``/``minimum`` split the gradient at x = 0 as ``jnp``'s
    do."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        zero = x.new_zeros(())
        return (torch.maximum(x, zero)
                + self.alpha.to(x.dtype) * torch.minimum(x, zero))
