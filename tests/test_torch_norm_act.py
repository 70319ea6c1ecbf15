"""The port's instance-norm kernels (their plain versions, which is what a
CPU tensor runs) against the JAX package: the Pallas kernels in interpret
mode and the lax reference. Inputs are made with numpy from a seed.

Tolerance: f32, atol = rtol = 1e-5 — the two sides differ only in the
order of the sums.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops.pallas.instance_norm import (  # noqa: E402
    _xla_instance_norm_act)
from p2p_tpu.ops.pallas.instance_norm_kernel import _stats_local  # noqa: E402
from p2p_tpu.ops.pallas.norm_act import instance_norm_act_fused  # noqa: E402
from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (  # noqa: E402
    instance_norm_stats, stats_geometry)
from p2p_tpu_torch.ops.cuda.norm_act import norm_act  # noqa: E402
from p2p_tpu_torch.ops.instance_norm import instance_norm_act  # noqa: E402

ATOL = RTOL = 1e-5
EPS = 1e-5
# (N, H, W, C): a narrow and a wide channel count, odd H and W
SHAPES = [(2, 7, 6, 8), (1, 5, 3, 1024)]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 1.5 + 0.25).astype(np.float32)


def _t(x_nhwc):
    """NHWC numpy → channels_last (N, C, H, W) torch (a view, no copy)."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_stats_plain_matches_pallas_stats_pass(shape):
    x = _x(shape, 0)
    s1, s2 = _stats_local(jnp.asarray(x), interpret=True)
    count = jnp.float32(shape[1] * shape[2])
    mean = s1 / count
    var = jnp.maximum(s2 / count - mean * mean, 0.0)
    rstd = jax.lax.rsqrt(var + EPS)

    got_mean, got_rstd = instance_norm_stats(_t(x), EPS)
    assert got_mean.shape == (shape[0], shape[3])
    assert got_mean.dtype == torch.float32
    np.testing.assert_allclose(got_mean.numpy(),
                               np.asarray(mean).reshape(shape[0], -1),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_rstd.numpy(),
                               np.asarray(rstd).reshape(shape[0], -1),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_norm_act_plain_matches_pallas_and_lax(act, residual, affine):
    for i, shape in enumerate(SHAPES):
        c = shape[3]
        x = _x(shape, 10 + i)
        r = _x(shape, 20 + i) if residual else None
        rng = np.random.default_rng(30 + i)
        s = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32) \
            if affine else None
        b = (0.1 * rng.normal(size=c)).astype(np.float32) if affine else None

        def j(a):
            return None if a is None else jnp.asarray(a)

        pallas = instance_norm_act_fused(j(x), j(s), j(b), j(r), act=act,
                                         slope=0.2, eps=EPS, interpret=True)
        lax = _xla_instance_norm_act(j(x), j(s), j(b), j(r), act, 0.2, EPS)
        got = instance_norm_act(
            _t(x), None if s is None else torch.from_numpy(s),
            None if b is None else torch.from_numpy(b),
            None if r is None else _t(r), act=act, slope=0.2, eps=EPS)
        assert got.dtype == torch.float32
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(got), np.asarray(pallas),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(_nhwc(got), np.asarray(lax),
                                   atol=ATOL, rtol=RTOL)


def test_norm_act_rejects_unknown_act_and_nonpositive_slope():
    x = _t(_x((1, 4, 4, 8), 0))
    mean, rstd = instance_norm_stats(x)
    with pytest.raises(ValueError):
        norm_act(x, mean, rstd, act="gelu")
    with pytest.raises(ValueError):
        norm_act(x, mean, rstd, act="leaky", slope=-0.1)


PATH_SHAPES = [(16, 32, 1024), (32, 64, 512), (64, 128, 256),
               (128, 256, 128), (256, 512, 64), (512, 1024, 32)]


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("hwc", PATH_SHAPES)
def test_stats_geometry_covers_every_pixel_and_fills_the_card(hwc, elt):
    """The host side of the stats kernel at every epilogue shape of the
    1024×512 pix2pixHD path: the chunks tile H×W exactly, the threads tile
    C, and pass 1 has at least one block per SM of an H100 (132)."""
    h, w, c = hwc
    hw = h * w
    g = stats_geometry(1, hw, c, 16 // elt)
    assert g.tx * g.ty == 256
    assert g.cblocks * g.tx * g.vec >= c > (g.cblocks - 1) * g.tx * g.vec
    assert g.num_p * g.chunk >= hw > (g.num_p - 1) * g.chunk
    assert g.cblocks * g.num_p >= 128
    assert g.chunk >= min(hw, 2 * g.ty)
