"""The bit-depth quantizer (counterpart of ``p2p_tpu/ops/quantize.py:33
quantize`` and ``:40 quantize_ste``): ``round(clamp(x, 0, 1)·(2^b − 1)) /
(2^b − 1)``, rounding half to even as ``jnp.round`` and ``torch.round`` do.

``quantize`` has the reference's zero gradient through the round;
``quantize_ste`` passes the gradient straight through inside the clamp
range and zeroes it outside (the JAX custom VJP, ``:45-49``).
"""

from __future__ import annotations

import torch


def _levels(bits: int) -> float:
    return float(2 ** bits - 1)


def quantize(x: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Reference-exact quantizer in x's dtype."""
    n = _levels(bits)
    return torch.round(torch.clamp(x, 0.0, 1.0) * n) / n


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        ctx.save_for_backward(x)
        return quantize(x, bits)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x >= 0.0) & (x <= 1.0)
        return torch.where(inside, g, torch.zeros_like(g)), None


def quantize_ste(x: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """:func:`quantize` with a straight-through gradient estimator."""
    return _QuantizeSTE.apply(x, bits)
