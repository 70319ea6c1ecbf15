"""The port's conv layers and pix2pixHD generator against the JAX package,
with the same weights (flax init, converted by ``p2p_tpu_torch.convert``)
and the same inputs (numpy, from a seed).

The conv cases include shapes at which the JAX layers take their dispatch
forms (PatchesConv, ThinHeadConv, _NearestUp2Conv): exact rewrites of the
one conv the port runs. The whole generator runs on the lax route and,
with ``P2P_TPU_FORCE_PALLAS=1``, on the interpret-mode Pallas route.

Tolerance: f32, atol = rtol = 2e-4 (the bound of tests/test_torch_parity.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.registry import define_G as jax_define_G  # noqa: E402
from p2p_tpu.ops import conv as jconv  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.ops import conv as tconv  # noqa: E402

ATOL = RTOL = 2e-4


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, size=shape).astype(np.float32)


def _t(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_layer(layer, x):
    params = jax.jit(layer.init)(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    y = jax.jit(layer.apply)({"params": params}, jnp.asarray(x))
    return params, np.asarray(y)


def _torch_layer(layer, params, x):
    layer.load_state_dict(state_from_flax(params), strict=True)
    with torch.no_grad():
        return _nhwc(layer(_t(x)))


@pytest.mark.parametrize("case", [
    # (name, input NHWC, flax layer, torch layer, JAX dispatch predicate)
    ("k7 stem", (1, 32, 40, 3),
     lambda: jconv.ConvLayer(8, kernel_size=7),
     lambda: tconv.ConvLayer(3, 8, 7), None),
    ("k3 s2 down", (2, 17, 16, 8),
     lambda: jconv.ConvLayer(16, kernel_size=3, stride=2, use_bias=False),
     lambda: tconv.ConvLayer(8, 16, 3, stride=2, use_bias=False), None),
    ("PatchesConv k7 3->16", (1, 512, 600, 3),
     lambda: jconv.ConvLayer(16, kernel_size=7, use_bias=False),
     lambda: tconv.ConvLayer(3, 16, 7, use_bias=False),
     lambda x: jconv._thin_stem_eligible(x, 16, 1)),
    ("ThinHeadConv k7 32->3", (1, 512, 600, 32),
     lambda: jconv.ConvLayer(3, kernel_size=7),
     lambda: tconv.ConvLayer(32, 3, 7),
     lambda x: jconv._thin_head_eligible(x, 3, 7, 1)),
    ("up x2 k3", (1, 8, 10, 6),
     lambda: jconv.UpsampleConvLayer(4, kernel_size=3, upsample=2),
     lambda: tconv.UpsampleConvLayer(6, 4, 3, upsample=2), None),
    ("_NearestUp2Conv 4->4", (1, 256, 300, 4),
     lambda: jconv.UpsampleConvLayer(4, kernel_size=3, upsample=2,
                                     use_bias=False),
     lambda: tconv.UpsampleConvLayer(4, 4, 3, upsample=2, use_bias=False),
     lambda x: 4 * x.shape[1] * x.shape[2]
     >= jconv._THIN_DISPATCH_MIN_PIXELS),
], ids=lambda c: c[0])
def test_conv_layers_match_jax(case):
    _, shape, jlayer, tlayer, dispatch = case
    x = _x(shape, 0)
    if dispatch is not None:
        # the JAX layer takes its dispatch form at this shape (its
        # predicates see the reflect-padded input, except the up-conv)
        pad = 3 if "k7" in case[0] else 0
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        assert dispatch(xp)
    params, want = _jax_layer(jlayer(), x)
    got = _torch_layer(tlayer(), params, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _small_cfgs():
    jcfg = jax_preset("pix2pixhd")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, ngf=8,
                                                  n_blocks=1))
    tcfg = get_preset("pix2pixhd")
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, ngf=8,
                                                  n_blocks=1))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def small_generator():
    jcfg, tcfg = _small_cfgs()
    g = jax_define_G(jcfg.model)
    x = _x((2, 64, 128, 3), 1)
    params = jax.jit(lambda k: g.init(k, jnp.asarray(x), False))(
        jax.random.key(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tg = define_G(tcfg.model)
    tg.load_state_dict(state_from_flax(params), strict=True)
    tg = tg.to(memory_format=torch.channels_last).eval()
    return g, params, tg, x


@pytest.mark.parametrize("route", ["lax", "pallas_interpret"])
def test_pix2pixhd_generator_matches_jax(small_generator, monkeypatch, route):
    g, params, tg, x = small_generator
    if route == "pallas_interpret":
        monkeypatch.setenv("P2P_TPU_FORCE_PALLAS", "1")
    # a fresh jit per route: the dispatch reads the env var at trace time
    want = np.asarray(jax.jit(lambda p, a: g.apply({"params": p}, a, False))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tg(_t(x)))
    assert got.shape == (2, 64, 128, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_generator_parameter_count_matches_jax_preset():
    """Full-width pix2pixhd: the port has exactly the JAX preset's
    parameters (182,679,939, all convs)."""
    jcfg = jax_preset("pix2pixhd")
    shapes = jax.eval_shape(
        lambda k: jax_define_G(jcfg.model).init(
            k, jnp.zeros((1, 64, 128, 3)), False), jax.random.key(0))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_torch = sum(p.numel() for p in
                  define_G(get_preset("pix2pixhd").model).parameters())
    assert n_jax == n_torch == 182_679_939
