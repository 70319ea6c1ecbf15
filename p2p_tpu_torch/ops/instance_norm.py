"""The fused instance-norm epilogue seam: ``act(norm(x)·γ+β [+ residual])``.

Counterpart of ``p2p_tpu/ops/pallas/instance_norm.py:202
pallas_instance_norm_act``: two passes over x, the statistics kernel
(ops/cuda/instance_norm_kernel.py) and the fused normalize + activation
kernel (ops/cuda/norm_act.py). Each wrapper picks its route from the
tensor: a CPU tensor takes the plain PyTorch version, a CUDA tensor the
kernel, and anything else raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from p2p_tpu_torch.ops.cuda.instance_norm_kernel import instance_norm_stats
from p2p_tpu_torch.ops.cuda.norm_act import norm_act


def instance_norm_act(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      act: str = "none", slope: float = 0.2,
                      eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over H×W of a channels_last (N, C, H, W) tensor with
    the whole post-conv epilogue fused; the output has x's dtype."""
    mean, rstd = instance_norm_stats(x, eps)
    return norm_act(x, mean, rstd, scale, bias, residual, act, slope)
