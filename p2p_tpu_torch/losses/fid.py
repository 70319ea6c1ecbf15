"""Fréchet distance of feature statistics, VFID (counterpart of
``p2p_tpu/losses/fid.py``).

``gaussian_stats``, ``RunningStats`` and ``frechet_distance`` are the JAX
package's, in numpy and float64 (the first in f32 on the features'
device). :func:`make_vgg_feature_fn` embeds images as the five VGG19 tap
activations each mean-pooled over the spatial axes in f32 and
concatenated (D = 64 + 128 + 256 + 512 + 512 = 1472). VGG runs in f32
(its weights' dtype) with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` False for the call, then
restored), under ``inference_mode``.
:class:`FIDEvaluator` accumulates real and fake statistics batch by batch
on the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

FEATURE_DIM = 1472


def gaussian_stats(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and covariance of (N, D) features, in f32."""
    f = feats.float()
    mu = f.mean(dim=0)
    centered = f - mu
    return mu, centered.T @ centered / (f.shape[0] - 1)


class RunningStats:
    """Host-side incremental accumulator of activation statistics, in
    float64."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d² = |μ1−μ2|² + tr(C1 + C2 − 2·(C1·C2)^½), with tr (C1·C2)^½ =
    tr (S1·C2·S1)^½ for S1 = (C1 + ε·I)^½ from a symmetric
    eigendecomposition; clipped at 0."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)
    diff = mu1 - mu2

    def _sym_sqrt(m):
        vals, vecs = np.linalg.eigh(m)
        vals = np.clip(vals, 0, None)
        return (vecs * np.sqrt(vals)) @ vecs.T

    s1 = _sym_sqrt(cov1 + eps * np.eye(len(cov1)))
    inner = s1 @ cov2 @ s1
    vals = np.linalg.eigvalsh((inner + inner.T) / 2)
    tr_sqrt = np.sqrt(np.clip(vals, 0, None)).sum()
    d2 = diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt
    return float(max(d2, 0.0))


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def make_vgg_feature_fn(vgg: nn.Module
                        ) -> Callable[[torch.Tensor], np.ndarray]:
    """``images → (N, 1472)`` float32 numpy features: ``vgg``'s five taps
    of (N, C, H, W) [-1, 1] images (any float dtype; cast to the trunk's
    f32), each mean-pooled over H and W and concatenated."""
    dtype = next(vgg.parameters()).dtype

    def fn(images: torch.Tensor) -> np.ndarray:
        with torch.inference_mode(), _tf32_off():
            feats = vgg(images.to(dtype))
            pooled = [f.float().mean(dim=(2, 3)) for f in feats]
            return torch.cat(pooled, dim=1).cpu().numpy()

    return fn


class FIDEvaluator:
    """Accumulate real and fake feature statistics batch by batch, then
    the distance:

    >>> ev = FIDEvaluator(make_vgg_feature_fn(vgg))
    >>> for real, fake in batches: ev.update(real, fake)
    >>> ev.compute()
    """

    def __init__(self, feature_fn, dim: int = FEATURE_DIM):
        self.feature_fn = feature_fn
        self.real = RunningStats(dim)
        self.fake = RunningStats(dim)

    def update(self, real_images, fake_images) -> None:
        self.real.update(self.feature_fn(real_images))
        self.fake.update(self.feature_fn(fake_images))

    def compute(self) -> float:
        mu_r, cov_r = self.real.finalize()
        mu_f, cov_f = self.fake.finalize()
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)
