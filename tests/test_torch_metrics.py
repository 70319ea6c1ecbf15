"""The port's PSNR and SSIM (``p2p_tpu_torch/losses/metrics.py``) against
the JAX package's (``p2p_tpu/losses/metrics.py``) on the same images, made
from a seed with numpy: procedural targets, their 3-bit copies, noisy
copies and copies pushed outside [-1, 1], per image and as the batch mean,
in the corrected (x + 1)/2·255 space and the reference's x·255 space
(``ref_buggy_scale``).

Tolerance: rtol 1e-5. PSNR is the same f32 arithmetic in both (the means
may sum in another order; measured: 1.8e-7 relative at most). The port's
SSIM is exact up to its last f64 divisions (integer window sums), the JAX
package's is f32 with shifted moments; they differ by the JAX value's
rounding (measured: 1.7e-6 relative at most).
Identical images give PSNR = ``max_db`` (60) and SSIM = 1 exactly in the
port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu.losses import metrics as jm
from p2p_tpu_torch.data.synthetic import synthetic_batch
from p2p_tpu_torch.losses import metrics as tm

RTOL = 1e-5


def _pairs(size, seed):
    """(target, pred) NHWC f32 pairs: the quantized copy, a noisy copy and
    a copy that leaves [-1, 1]."""
    b = synthetic_batch(3, size, seed=seed)
    t = b["target"]
    rng = np.random.default_rng(seed)
    noisy = np.clip(t + rng.normal(0, 0.05, t.shape), -1, 1)
    wide = t * 1.3 + rng.normal(0, 0.2, t.shape)
    return [(t, b["input"]), (t, noisy.astype(np.float32)),
            (t, wide.astype(np.float32))]


def _both(fn, t, p, **kw):
    got = getattr(tm, fn)(torch.from_numpy(t), torch.from_numpy(p), **kw)
    want = getattr(jm, fn)(jnp.asarray(t), jnp.asarray(p), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("size,seed", [(16, 0), (32, 1), (48, 2)])
@pytest.mark.parametrize("buggy", [False, True])
@pytest.mark.parametrize("fn", ["psnr", "ssim"])
def test_metric_matches_the_jax_package(fn, buggy, size, seed):
    for t, p in _pairs(size, seed):
        for per_image in (True, False):
            got, want = _both(fn, t, p, ref_buggy_scale=buggy,
                              per_image=per_image)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_to_uint8_space_matches_the_jax_package():
    t, p = _pairs(16, 3)[2]
    for buggy in (False, True):
        for q in (False, True):
            got = tm.to_uint8_space(torch.from_numpy(p), buggy, q).numpy()
            want = np.asarray(jm.to_uint8_space(jnp.asarray(p), buggy, q))
            np.testing.assert_array_equal(got, want)
    # halves round to even in both
    x = (np.arange(0, 256, dtype=np.float32) + 0.5) / 127.5 - 1.0
    got = tm.to_uint8_space(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jm.to_uint8_space(jnp.asarray(x))))


@pytest.mark.parametrize("buggy", [False, True])
def test_identical_images_clamp_psnr_and_give_ssim_one(buggy):
    t = synthetic_batch(2, 32, seed=4)["target"]
    tt = torch.from_numpy(t)
    psnr = tm.psnr(tt, tt, ref_buggy_scale=buggy, per_image=True)
    assert psnr.tolist() == [60.0, 60.0]
    assert float(tm.psnr(tt, tt, max_db=45.0)) == 45.0
    assert tm.ssim(tt, tt, ref_buggy_scale=buggy, per_image=True
                   ).tolist() == [1.0, 1.0]
    want = np.asarray(jm.psnr(jnp.asarray(t), jnp.asarray(t),
                              ref_buggy_scale=buggy, per_image=True))
    np.testing.assert_array_equal(psnr.numpy(), want)
    np.testing.assert_allclose(
        np.asarray(jm.ssim(jnp.asarray(t), jnp.asarray(t), per_image=True)),
        1.0, rtol=RTOL)


def test_psnr_clamps_at_max_db_for_a_one_level_difference():
    """A difference of one level (128 → 129) in one value of 32·32·3 is
    83.0 dB, clamped to 60 in both packages."""
    t = np.zeros((1, 32, 32, 3), np.float32)
    p = t.copy()
    p[0, 0, 0, 0] = 1.5 / 127.5
    got, want = _both("psnr", t, p, per_image=True)
    assert got.tolist() == [60.0] and want.tolist() == [60.0]
    got, want = _both("psnr", t, p, max_db=100.0, per_image=True)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert 82.9 < float(got[0]) < 83.1
