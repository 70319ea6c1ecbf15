"""Generator inference (counterpart of ``p2p_tpu/train/step.py:940
make_infer_forward``), the serving half: ingest → G → pred, without the
compression net and without the PSNR/SSIM tail (both come with later
slices)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.utils.images import ingest

InferFn = Callable[[nn.Module, Dict[str, np.ndarray]],
                   Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_infer_forward(cfg: Config, dtype: Optional[torch.dtype] = None,
                       with_metrics: bool = False) -> InferFn:
    """``fwd(generator, batch) -> (pred, metrics)``. ``batch["input"]`` is
    an NHWC host batch (uint8 [0, 255] or float [-1, 1]); it goes to the
    generator's device, is normalized there and cast to ``dtype``, and
    runs as a channels_last (N, C, H, W) tensor. ``pred`` is NHWC on the
    device; ``metrics`` is empty."""
    if with_metrics:
        raise NotImplementedError("PSNR/SSIM are not ported yet")
    if cfg.model.use_compression_net:
        raise NotImplementedError(
            "presets with a compression net are not ported yet")

    def fwd(generator: nn.Module, batch: Dict[str, np.ndarray]):
        device = next(generator.parameters()).device
        x = torch.as_tensor(batch["input"]).to(device, non_blocking=True)
        # an NHWC tensor viewed as (N, C, H, W) is channels_last already
        x = ingest(x.permute(0, 3, 1, 2), dtype)
        with torch.inference_mode():
            pred = generator(x)
        return pred.permute(0, 2, 3, 1), {}

    return fwd
