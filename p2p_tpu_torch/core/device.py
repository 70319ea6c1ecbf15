"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; the CPU only when the caller asks for it. Raises
    when CUDA is asked for (or defaulted to) and there is no CUDA device:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the plain PyTorch versions of the kernels")
    return dev
