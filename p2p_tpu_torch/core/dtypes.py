"""Compute dtypes of the port (counterpart of ``p2p_tpu/core/dtypes.py`` and
``p2p_tpu/serve/engine.py:49 _resolve_dtype``): serving runs the generator
in bf16 (activations and weights; convolutions accumulate in f32 and the
norm statistics are f32) or in f32; training keeps f32 master parameters
and computes in bf16 or f32 (:func:`train_dtype`)."""

from __future__ import annotations

from typing import Optional

import torch

_DTYPES = {None: torch.float32, "f32": torch.float32,
           "float32": torch.float32, "bf16": torch.bfloat16,
           "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Optional[str]) -> torch.dtype:
    """``"bf16"``/``"bfloat16"`` → bf16; ``None``/``"f32"``/``"float32"``
    → f32."""
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r} (use 'bf16' or 'f32')")
    return _DTYPES[dtype]


def train_dtype(mixed_precision: bool) -> Optional[torch.dtype]:
    """The training policy (counterpart of ``p2p_tpu/core/dtypes.py:44
    default_policy`` as ``train/loop.py`` applies it): parameters, optimizer
    state, norm statistics and loss reductions stay f32; with
    ``mixed_precision`` the networks compute in bf16 (each conv casts its
    input and weight, flax's ``dtype=``), otherwise in f32 (None: the
    promoted type of input and weight)."""
    return torch.bfloat16 if mixed_precision else None


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 when it is f64: the losses that the JAX
    package computes in f32 (ops/sobel.py, losses/style.py) keep an f64
    input in f64, so the card checks can hold them against f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
