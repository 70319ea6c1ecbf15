"""Forward activations of the generator epilogues (counterparts of
``p2p_tpu/ops/activations.py`` ``relu_y``, ``leaky_relu_y`` and ``tanh_y``).

The JAX versions carry output-masked gradients; serving needs only the
forward, which is the plain function.
"""

from __future__ import annotations

import torch


def relu_y(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu_y(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    if slope <= 0:
        raise ValueError(f"leaky_relu_y needs slope > 0 (got {slope})")
    return torch.where(x >= 0, x, slope * x)


def tanh_y(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)
