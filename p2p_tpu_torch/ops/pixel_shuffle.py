"""Pixel shuffle / unshuffle (counterpart of ``p2p_tpu/ops/pixel_shuffle.py
:20 pixel_unshuffle`` and ``:33 pixel_shuffle``).

The JAX functions are NHWC reshape/transposes whose channel order is
``c·r² + dy·r + dx``, the order of ``F.pixel_unshuffle`` /
``F.pixel_shuffle`` (pinned against the JAX functions in
tests/test_torch_reference_models.py), so here they are those calls on
(N, C, H, W) tensors.
"""

import torch.nn.functional as F

pixel_unshuffle = F.pixel_unshuffle   # (N, C, H, W) → (N, C·r², H/r, W/r)
pixel_shuffle = F.pixel_shuffle       # (N, C·r², H, W) → (N, C, H·r, W·r)
