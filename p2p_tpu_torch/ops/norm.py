"""Normalization factories (counterparts of ``p2p_tpu/ops/norm.py:224
make_norm_act`` and ``:288 make_norm``).

Kinds in this port: ``"pallas_instance"`` (the fused epilogue through the
Hopper kernels, ops/instance_norm.py), ``"instance"`` (plain PyTorch, the
op order of the JAX ``InstanceNorm`` module) and ``"none"``. The norms are
stateless and affine-free, as in the JAX generators, so a factory returns
plain functions on tensors. ``"batch"`` comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from p2p_tpu_torch.ops.activations import leaky_relu_y, relu_y
from p2p_tpu_torch.ops.instance_norm import instance_norm_act

EpilogueFn = Callable[..., torch.Tensor]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel norm over H, W with statistics in f32 and
    the result in x's dtype (the JAX ``InstanceNorm`` without affine)."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The norm of ``kind`` as a function of one tensor."""
    if kind == "instance":
        return instance_norm
    if kind == "pallas_instance":
        return instance_norm_act
    if kind == "none":
        return lambda x: x
    raise ValueError(f"unknown norm kind {kind!r}")


def make_norm_act(kind: str) -> EpilogueFn:
    """The post-conv epilogue ``apply(y, act="none", slope=0.2,
    residual=None)`` = act(norm(y) [+ residual]). ``pallas_instance``
    fuses the chain into the kernels' normalize pass; the other kinds run
    norm → residual add → activation in y's dtype, as the JAX reference
    chain does."""
    if kind == "pallas_instance":
        def apply_fused(y: torch.Tensor, act: str = "none",
                        slope: float = 0.2,
                        residual: Optional[torch.Tensor] = None):
            return instance_norm_act(y, residual=residual, act=act,
                                     slope=slope)

        return apply_fused

    norm = make_norm(kind)

    def apply_ref(y: torch.Tensor, act: str = "none", slope: float = 0.2,
                  residual: Optional[torch.Tensor] = None):
        z = norm(y)
        if residual is not None:
            z = z + residual
        if act == "relu":
            return relu_y(z)
        if act == "leaky":
            return leaky_relu_y(z, slope)
        if act != "none":
            raise ValueError(f"unknown act {act!r}")
        return z

    return apply_ref
