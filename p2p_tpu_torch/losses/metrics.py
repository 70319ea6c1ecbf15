"""Image quality metrics: PSNR and SSIM on the device (counterpart of
``p2p_tpu/losses/metrics.py:20 to_uint8_space``, ``:33 psnr`` and ``:71
ssim``).

Images are NHWC tensors in [-1, 1], as the inference forward returns them.
They are scored in the [0, 255] space, (x + 1)/2·255 clipped and rounded
half to even (``torch.round``, as ``jnp.round``), or in the reference's
distorted x·255 space with ``ref_buggy_scale``. PSNR is f32 throughout,
as in the JAX package.

SSIM is computed exactly up to its last divisions. The images it scores
are integers in 0..255, so the window sums of x, x² and x·y are integers
below 2^24, exact in f32 whatever the order of the sum (``F.avg_pool2d``
with no divisor, on the CUDA cores: no TF32); the moments are formed from
them in f64, where the products are exact too. The JAX package reaches the
same quantity in f32 through per-image shifted moments (its window means
at ``Precision.HIGHEST``, since a TF32-like mean errs by ~0.3 at the
0..255 scale); its result is within about 1e-5 of the f64 value, this
one within about 1e-7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_uint8_space(x: torch.Tensor, ref_buggy_scale: bool = False,
                   quantize_uint8: bool = True) -> torch.Tensor:
    """Map [-1, 1] images to the [0, 255] space the metrics use."""
    x = x.float()
    if ref_buggy_scale:
        y = torch.clamp(x * 255.0, 0, 255)
    else:
        y = torch.clamp((x + 1.0) * 0.5 * 255.0, 0, 255)
    if quantize_uint8:
        y = torch.round(y)
    return y


def psnr(target: torch.Tensor, pred: torch.Tensor,
         ref_buggy_scale: bool = False, max_db: float = 60.0,
         per_image: bool = False) -> torch.Tensor:
    """10·log10(255²/MSE), clamped to ``max_db``; one value per image
    (a reduction over H, W and C) with ``per_image``."""
    t = to_uint8_space(target, ref_buggy_scale)
    p = to_uint8_space(pred, ref_buggy_scale)
    dims = tuple(range(1, t.dim())) if per_image else None
    mse = ((t - p) ** 2).mean(dim=dims)
    # a tensor numerator: ``number / tensor`` multiplies by the reciprocal
    val = 10.0 * torch.log10(mse.new_tensor(255.0 ** 2)
                             / torch.clamp(mse, min=1e-12))
    return torch.clamp(val, max=max_db)


def _window_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Sum over win×win windows per channel of an NHWC tensor, VALID."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1,
                     divisor_override=1)
    return y.permute(0, 2, 3, 1)


def ssim(target: torch.Tensor, pred: torch.Tensor,
         ref_buggy_scale: bool = False, win: int = 7,
         per_image: bool = False) -> torch.Tensor:
    """Mean SSIM with a uniform win×win window (skimage's defaults for
    uint8: L = 255, K1 = 0.01, K2 = 0.03, unbiased covariance), the
    channels averaged; one value per image with ``per_image``. f32 out."""
    t = to_uint8_space(target, ref_buggy_scale)
    p = to_uint8_space(pred, ref_buggy_scale)
    L = 255.0
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    n = win * win
    s_t, s_p, s_tt, s_pp, s_tp = (
        _window_sum(x, win).double() for x in (t, p, t * t, p * p, t * p))
    mu_t = s_t / n
    mu_p = s_p / n
    # the unbiased (co)variances, cov_norm·(E[xy] − E[x]E[y]) with
    # cov_norm = n/(n − 1), from exact integer numerators
    d = n * (n - 1.0)
    var_t = (n * s_tt - s_t * s_t) / d
    var_p = (n * s_pp - s_p * s_p) / d
    cov = (n * s_tp - s_t * s_p) / d
    num = (2 * mu_t * mu_p + c1) * (2 * cov + c2)
    den = (mu_t * mu_t + mu_p * mu_p + c1) * (var_t + var_p + c2)
    smap = num / den
    if per_image:
        return smap.mean(dim=tuple(range(1, smap.dim()))).float()
    return smap.mean().float()
