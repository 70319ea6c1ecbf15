"""The ``reference`` preset's modules in the port against the JAX package
on the CPU, with the same weights (flax init, carried across by
``p2p_tpu_torch.convert``) and the same inputs (numpy, from seeds):
CompressionNetwork, ExpandNetwork (ngf 8, 2 blocks, 32²),
MultiscaleDiscriminator (ndf 8: every tap and the updated spectral u),
VGG19Features (32²), the quantizer's straight-through gradient, pixel
(un)shuffle, PReLU and the output-masked activations, the losses, the
schedule and the presets. JAX runs with ``P2P_PALLAS_BN`` unset.

Tolerance: f32, atol = rtol = 2e-4 on activations and gradients (the bound
of tests/test_torch_parity.py); exact where both sides do the same
elementwise arithmetic (pixel shuffles, quantizer, schedule, config).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core import config as jconfig  # noqa: E402
from p2p_tpu.losses import (  # noqa: E402
    feature_matching_loss as jax_fm, gan_loss as jax_gan)
from p2p_tpu.models.compression import CompressionNetwork as JaxC  # noqa: E402
from p2p_tpu.models.expand import ExpandNetwork as JaxG  # noqa: E402
from p2p_tpu.models.patchgan import MultiscaleDiscriminator as JaxD  # noqa: E402
from p2p_tpu.models.vgg import VGG19Features as JaxVGG  # noqa: E402
from p2p_tpu.models.vgg import load_vgg19_params  # noqa: E402
from p2p_tpu.ops import activations as jact  # noqa: E402
from p2p_tpu.ops.pixel_shuffle import (  # noqa: E402
    pixel_shuffle as jax_pixel_shuffle,
    pixel_unshuffle as jax_pixel_unshuffle)
from p2p_tpu.ops.quantize import quantize as jax_quantize  # noqa: E402
from p2p_tpu.ops.quantize import quantize_ste as jax_quantize_ste  # noqa: E402
from p2p_tpu.ops.tv import total_variation_loss as jax_tv  # noqa: E402
from p2p_tpu.train.schedules import make_schedule as jax_schedule  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402
from p2p_tpu_torch.core import config as tconfig  # noqa: E402
from p2p_tpu_torch.losses.feature_matching import (  # noqa: E402
    feature_matching_loss)
from p2p_tpu_torch.losses.gan import gan_loss  # noqa: E402
from p2p_tpu_torch.models.compression import CompressionNetwork  # noqa: E402
from p2p_tpu_torch.models.expand import ExpandNetwork  # noqa: E402
from p2p_tpu_torch.models.patchgan import MultiscaleDiscriminator  # noqa: E402
from p2p_tpu_torch.models.vgg import VGG19Features  # noqa: E402
from p2p_tpu_torch.ops import activations as tact  # noqa: E402
from p2p_tpu_torch.ops import pixel_shuffle as tps  # noqa: E402
from p2p_tpu_torch.ops.quantize import quantize, quantize_ste  # noqa: E402
from p2p_tpu_torch.ops.tv import total_variation_loss  # noqa: E402
from p2p_tpu_torch.train.schedules import make_schedule  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _u(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _t(x_nhwc, grad=False):
    return torch.from_numpy(np.array(x_nhwc).transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last).requires_grad_(grad)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _xla_path():
    assert os.environ.get("P2P_PALLAS_BN", "0") != "1"


def _train_mode_pair(jax_mod, torch_mod, x, g, seed=0):
    """Init the flax module, carry its variables into the torch module and
    run both in train mode on x; the JAX side also pulls the cotangent g
    back to x. Returns (jax out, torch out, jax dx, the torch input, the
    JAX updated collections)."""
    xj = jnp.asarray(x)
    variables = _np(jax.jit(lambda k: jax_mod.init(k, xj))(
        jax.random.key(seed)))
    colls = [k for k in variables if k != "params"]

    @jax.jit
    def run(xx, gg):
        y, vjp, upd = jax.vjp(
            lambda a: jax_mod.apply(variables, a, mutable=colls), xx,
            has_aux=True)
        return y, vjp(gg)[0], upd

    yj, dxj, upd = run(xj, g)
    torch_mod.load_state_dict(state_from_flax(
        *(variables[k] for k in variables)), strict=True)
    torch_mod.train()
    xt = _t(x, grad=True)
    yt = torch_mod(xt)
    return yj, yt, np.asarray(dxj), xt, _np(upd)


def test_compression_network_forward_gradient_and_stats():
    x = _u((2, 32, 32, 3), 0)
    g = _u((2, 32, 32, 3), 1)
    yj, yt, dxj, xt, upd = _train_mode_pair(
        JaxC(), CompressionNetwork(), x, jnp.asarray(g))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), **TOL)
    (yt * _t(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), dxj, **TOL)


@pytest.fixture
def _one_thread_full_f32():
    """Torch on one thread with full-precision f32 convs and matmuls, the
    settings restored afterwards: the comparison does not depend on what
    the test process carries (its thread count, a lowered f32 precision)."""
    saved = (torch.get_num_threads(), torch.get_float32_matmul_precision())
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(saved[0])
    torch.set_float32_matmul_precision(saved[1])


@pytest.mark.usefixtures("_one_thread_full_f32")
@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_expand_network_forward_gradient_and_stat_updates(norm):
    """Measured here (``batch``): the port's dx is the same at 1 to 8 torch
    threads, max |dx − JAX| 3.5e-5 (0.12 of the band); 3.6e-5 at 12 to 32
    threads. One run of the whole suite with 6 workers put 68 of the
    3,072 elements of the port's dx outside the band (differences up to
    7.2e-4; the JAX side unchanged), which runs of this file alone, of the
    torch files under 6 workers and after tests/test_obs.py did not
    repeat; so the test pins the settings a worker could carry instead of
    widening the band."""
    x = _u((1, 32, 32, 3), 2, 0.0, 1.0)
    g = _u((1, 32, 32, 3), 3)
    tg = ExpandNetwork(ngf=8, n_blocks=2, norm=norm)
    yj, yt, dxj, xt, upd = _train_mode_pair(
        JaxG(ngf=8, n_blocks=2, norm=norm), tg, x, jnp.asarray(g))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), **TOL)
    (yt * _t(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), dxj, **TOL)
    bufs = dict(tg.named_buffers())
    want = state_from_flax(upd.get("batch_stats", {}))
    assert set(bufs) == set(want)
    assert len(want) == (2 * 10 if norm == "batch" else 0)
    for k, v in want.items():
        np.testing.assert_allclose(bufs[k].numpy(), v.numpy(), **TOL)


def test_expand_network_eval_mode_reads_running_stats():
    x = _u((1, 32, 32, 3), 4, 0.0, 1.0)
    jg = JaxG(ngf=8, n_blocks=2)
    variables = _np(jax.jit(lambda k: jg.init(k, jnp.asarray(x), False))(
        jax.random.key(1)))
    want = jax.jit(lambda a: jg.apply(variables, a, False))(jnp.asarray(x))
    tg = ExpandNetwork(ngf=8, n_blocks=2)
    tg.load_state_dict(state_from_flax(variables["params"],
                                       variables["batch_stats"]))
    with torch.no_grad():
        got = tg.eval()(_t(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("sn,interm", [(True, True), (False, False)])
def test_multiscale_discriminator_every_tap_and_spectral_u(sn, interm):
    x = _u((1, 32, 32, 6), 5)
    kw = dict(ndf=8, use_spectral_norm=sn, get_interm_feat=interm)
    jd = JaxD(**kw)
    xj = jnp.asarray(x)
    variables = _np(jax.jit(lambda k: jd.init(k, xj))(jax.random.key(2)))
    want, upd = jax.jit(lambda a: jd.apply(variables, a,
                                           mutable=["spectral"]))(xj)
    td = MultiscaleDiscriminator(**kw)
    td.load_state_dict(state_from_flax(*variables.values()), strict=True)
    got = td.train()(_t(x))
    assert len(got) == len(want) == 3
    for scale_t, scale_j in zip(got, want):
        assert len(scale_t) == len(scale_j) == (5 if interm else 1)
        for t, j in zip(scale_t, scale_j):
            np.testing.assert_allclose(_nhwc(t), np.asarray(j), **TOL)
    bufs = dict(td.named_buffers())
    assert len(bufs) == (9 if sn else 0)
    for k, v in state_from_flax(_np(upd.get("spectral", {}))).items():
        np.testing.assert_allclose(bufs[k].numpy(), v.numpy(), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("imagenet_norm", [False, True])
def test_vgg19_features_every_tap(imagenet_norm):
    params = _np(jax.jit(lambda: load_vgg19_params(seed=190))())
    x = _u((1, 32, 32, 3), 6)
    want = jax.jit(lambda a: JaxVGG(imagenet_norm=imagenet_norm).apply(
        {"params": params}, a))(jnp.asarray(x))
    vgg = VGG19Features(imagenet_norm)
    vgg.load_state_dict(state_from_flax(params), strict=True)
    with torch.no_grad():
        got = vgg(_t(x))
    assert [tuple(t.shape[1:]) for t in got] == [
        (64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4), (512, 2, 2)]
    for t, j in zip(got, want):
        np.testing.assert_allclose(_nhwc(t), np.asarray(j), **TOL)


@pytest.mark.parametrize("ste", [True, False])
def test_quantizer_values_and_gradient(ste):
    """The straight-through gradient, or the reference's zero gradient
    through the round."""
    x = np.linspace(-0.3, 1.3, 1001).astype(np.float32)
    g = _u((1001,), 7)
    jq, tq = (jax_quantize_ste, quantize_ste) if ste else (
        jax_quantize, quantize)
    yj, vjp = jax.vjp(lambda a: jq(a, 3), jnp.asarray(x))
    (dj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tq(xt, 3)
    (yt * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dj))


def test_pixel_shuffles_use_the_jax_channel_order():
    x = _u((2, 4, 6, 12), 8)
    np.testing.assert_array_equal(
        _nhwc(tps.pixel_unshuffle(_t(x), 2)),
        np.asarray(jax_pixel_unshuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        _nhwc(tps.pixel_shuffle(_t(x), 2)),
        np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("name", ["relu_y", "leaky_relu_y", "tanh_y",
                                  "PReLU"])
def test_activations_values_and_gradients(name):
    x = _u((2, 3, 4, 5), 9, -2.0, 2.0)
    x[0, 0, 0, :2] = 0.0          # the activations' kink
    g = _u((2, 3, 4, 5), 10)
    if name == "PReLU":
        jm = jact.PReLU()
        # the flax field ``init`` (α's start) shadows Module.init
        _, params = jm.init_with_output(jax.random.key(0), jnp.asarray(x))
        yj, vjp = jax.vjp(lambda p, a: jm.apply(p, a), params,
                          jnp.asarray(x))
        dpj, dxj = vjp(jnp.asarray(g))
        tm = tact.PReLU()
        xt = _t(x, grad=True)
        yt = tm(xt)
        (yt * _t(g)).sum().backward()
        np.testing.assert_allclose(float(tm.alpha.grad),
                                   float(dpj["params"]["alpha"]), **TOL)
    else:
        yj, vjp = jax.vjp(getattr(jact, name), jnp.asarray(x))
        (dxj,) = vjp(jnp.asarray(g))
        xt = _t(x, grad=True)
        yt = getattr(tact, name)(xt)
        (yt * _t(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dxj), **TOL)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "hinge"])
def test_losses_match(mode):
    preds = [[_u((1, 4, 4, 8), 11 + 3 * s + i) for i in range(3)]
             + [_u((1, 4, 4, 1), 20 + s)] for s in range(3)]
    reals = [[_u(p.shape, 30 + 4 * s + i) for i, p in enumerate(sc)]
             for s, sc in enumerate(preds)]
    jp = jax.tree_util.tree_map(jnp.asarray, preds)
    jr = jax.tree_util.tree_map(jnp.asarray, reals)
    tp = [[_t(p) for p in sc] for sc in preds]
    tr = [[_t(p) for p in sc] for sc in reals]
    for real in (True, False):
        for for_d in (True, False):
            np.testing.assert_allclose(
                float(gan_loss(tp, real, mode, for_d)),
                float(jax_gan(jp, real, mode, for_d)), **TOL)
    np.testing.assert_allclose(float(feature_matching_loss(tp, tr)),
                               float(jax_fm(jp, jr)), **TOL)
    img = _u((1, 8, 8, 3), 40)
    np.testing.assert_allclose(float(total_variation_loss(_t(img))),
                               float(jax_tv(jnp.asarray(img))), **TOL)


def test_lambda_schedule_matches_jax():
    cfg = tconfig.OptimConfig(niter=2, niter_decay=3)
    jcfg = jconfig.OptimConfig(niter=2, niter_decay=3)
    for epoch_count in (1, 3):
        mult = make_schedule(cfg, steps_per_epoch=2, epoch_count=epoch_count)
        jsched = jax_schedule(jcfg, steps_per_epoch=2,
                              epoch_count=epoch_count)
        for step in range(14):
            assert cfg.lr * mult(step) == pytest.approx(
                float(jsched(step)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("name", ["reference", "pix2pixhd", "facades_int8"])
def test_presets_match_the_jax_presets(name):
    j, t = jconfig.get_preset(name), tconfig.get_preset(name)
    for section in ("model", "loss", "optim", "data", "train", "health"):
        port = getattr(t, section)
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(
                getattr(j, section), f.name), (section, f.name)
    assert t.image_hw == j.image_hw
