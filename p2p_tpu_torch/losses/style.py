"""Gram-matrix style loss (counterpart of ``p2p_tpu/losses/style.py:23
gram_matrix`` and ``:30 style_loss``).

Per image, G = FᵀF / (H·W·C) of the (H·W, C) matrix of a feature map, in
f32; the loss is Σ_i w_i · mean|G(VGG_i(fake)) − G(VGG_i(real))| over the
five VGG19 taps with the perceptual loss's weights, the real side
detached. The JAX ``style_loss`` runs VGG on both images; here the taps
come in (the train step computes the fake's once for the perceptual and
the style terms, and the real's under no gradient).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from p2p_tpu_torch.core.dtypes import at_least_f32
from p2p_tpu_torch.losses.perceptual import VGG_SLICE_WEIGHTS


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C, C) normalized Gram matrices, in f32 (f64 for
    an f64 input). A
    channels_last map is read as the (N, H·W, C) view it is in memory."""
    n, c, h, w = feats.shape
    f = at_least_f32(feats).permute(0, 2, 3, 1).reshape(n, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / float(h * w * c)


def style_loss(fake_feats: Sequence[torch.Tensor],
               real_feats: Sequence[torch.Tensor],
               weights: Optional[List[float]] = None) -> torch.Tensor:
    """Σ_i w_i · L1(Gram(fake_i), Gram(real_i)), the real Grams detached."""
    total = fake_feats[0].new_zeros(
        (), dtype=torch.promote_types(fake_feats[0].dtype, torch.float32))
    for wi, ff, rf in zip(weights or VGG_SLICE_WEIGHTS, fake_feats,
                          real_feats):
        gr = gram_matrix(rf).detach()
        total = total + wi * (gram_matrix(ff) - gr).abs().mean()
    return total
