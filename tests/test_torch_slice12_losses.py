"""Slice 12's losses and VFID against the JAX package at 16² on the CPU:
``ops/sobel.py`` (``sobel_edges``, ``angular_loss``: value and gradient),
``losses/style.py`` (``gram_matrix``, ``style_loss``), ``losses/fid.py``
(the VGG features, ``RunningStats``, ``frechet_distance``, ``FIDEvaluator``)
on one seeded VGG19 draw (numpy, flax's HWIO tree, carried across by
``convert.py``), and
``make_g_loss_fn`` with the style, angular and Sobel terms at the steps 0,
``steps_per_epoch`` and 3 · ``steps_per_epoch`` of the Sobel warm-up:
every part, the total and the gradient with respect to ``fake_b`` (the
JAX ``style_loss`` through its ``g_style``).

Tolerances: f32 on both sides, different summation orders; values within
1e-5 relative (the VGG-based ones 1e-4), gradients within 1e-4 of their
largest entry, the float64 statistics within 1e-9 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.losses import fid as jfid
from p2p_tpu.losses.style import gram_matrix as jax_gram
from p2p_tpu.models.vgg import _CFG as VGG_CFG
from p2p_tpu.ops.sobel import angular_loss as jax_angular
from p2p_tpu.ops.sobel import sobel_edges as jax_sobel
from p2p_tpu.train.step import make_g_loss_fn as jax_g_loss_fn
from p2p_tpu_torch.convert import state_from_flax
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.losses import fid
from p2p_tpu_torch.losses.perceptual import vgg_loss
from p2p_tpu_torch.losses.style import gram_matrix, style_loss
from p2p_tpu_torch.models.vgg import VGG19Features
from p2p_tpu_torch.ops.sobel import angular_loss, sobel_edges
from p2p_tpu_torch.train.step import make_g_loss_fn

torch.set_num_threads(1)
N, S = 2, 16
SPE = 3                       # steps per epoch of the warm-up checks


def vgg_tree(seed: int):
    """A VGG19 parameter tree in flax's layout: HWIO kernels of std
    sqrt(1/fan_in) (flax's lecun scale), small biases."""
    rng = np.random.default_rng(seed)
    tree, cin = {}, 3
    for name, ch in VGG_CFG:
        if name == "M":
            continue
        tree[name] = {
            "kernel": rng.standard_normal((3, 3, cin, ch), np.float32)
            * np.float32(1 / np.sqrt(9 * cin)),
            "bias": rng.standard_normal(ch, np.float32) * np.float32(0.01)}
        cin = ch
    return tree


def _nhwc(seed, c=3, lo=-1.0, hi=1.0, n=N, s=S):
    return np.random.default_rng(seed).uniform(lo, hi, (n, s, s, c)).astype(
        np.float32)


def _t(x, grad=False):
    """NHWC numpy → channels_last (N, C, H, W) tensor."""
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    return t.requires_grad_(grad) if grad else t


def _close(got, want, rtol=1e-5, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _grad_close(got, want, rtol_of_max=1e-4):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol_of_max * np.abs(want).max(), err


def test_sobel_edges_value_and_gradient_match_jax():
    x = _nhwc(1)
    # a flat patch: the ε under the root keeps its gradient finite
    x[0, :6, :6, 0] = 0.25
    t = _t(x, grad=True)
    got = sobel_edges(t)
    assert got.shape == (N, 1, S, S) and got.dtype == torch.float32
    w = _nhwc(2, c=1)
    value, want = jax.jit(jax.value_and_grad(
        lambda v: jnp.sum(jax_sobel(v) * w)))(jnp.asarray(x))
    _close(got.mul(_t(w)).sum().item(), value)
    _close(got.detach().permute(0, 2, 3, 1),
           jax.jit(jax_sobel)(jnp.asarray(x)))
    got.mul(_t(w)).sum().backward()
    assert np.isfinite(t.grad.numpy()).all()
    _grad_close(t.grad.permute(0, 2, 3, 1), want)


def test_angular_loss_value_and_gradient_match_jax():
    a, b = _nhwc(3), _nhwc(4)
    b[0, 0, 0] = 0.0                  # a zero vector: ε under both roots
    b[1, 1, 1] = a[1, 1, 1] * 2.0     # parallel: the clamp at 0.99999
    ta, tb = _t(a, grad=True), _t(b, grad=True)
    got = angular_loss(ta, tb)
    got.backward()
    want, (ga, gb) = jax.jit(jax.value_and_grad(jax_angular, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    _close(got.item(), want)
    _grad_close(ta.grad.permute(0, 2, 3, 1), ga)
    _grad_close(tb.grad.permute(0, 2, 3, 1), gb)


def _preds(seed, n_scales=2):
    """A multiscale D output of 2 taps and a prediction map per scale."""
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(N, 5 - i, 5 - i, 8)).astype(np.float32),
             rng.normal(size=(N, 3, 3, 16)).astype(np.float32),
             rng.normal(size=(N, 2, 2, 1)).astype(np.float32)]
            for i in range(n_scales)]


# the JAX side without the perceptual term (its parity is the train-step
# files'; here it would double the VGG graph to compile): the port's
# shared fake taps are held against separate calls in the last test
OVER = dict(lambda_style=2.0, lambda_sobel=3.0, sobel_warmup_epochs=2,
            lambda_angular=0.5, lambda_l1=1.5, lambda_tv=1.0,
            lambda_vgg=0.0, lambda_feat=10.0)
STEPS = (0, SPE, 3 * SPE)


@pytest.fixture(scope="module", autouse=True)
def _blas_on_one_thread():
    """VFID's eigendecompositions of 1472² matrices spin-wait 20× slower
    on many BLAS threads when the suite's other workers hold the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def case():
    """The inputs, the port's VGG and the JAX side's results (one
    compile): the VFID features of 2 real and 2 fake batches and, at each of
    ``STEPS``, the JAX ``make_g_loss_fn``'s total, parts (its ``g_style``
    is JAX's ``style_loss`` times ``lambda_style``) and gradient with
    respect to fake_b."""
    params = vgg_tree(190)
    tvgg = VGG19Features()
    tvgg.load_state_dict(state_from_flax(params), strict=True)
    c = dict(
        tvgg=tvgg.eval(),
        real=[_nhwc(10 + i) for i in range(2)],
        fake=[np.tanh(2.0 * _nhwc(20 + i)) for i in range(2)],
        g=(np.tanh(2.0 * _nhwc(30)), _nhwc(31), np.tanh(2.0 * _nhwc(32))),
        pf=_preds(33), pr=_preds(34))
    fake, real_a, real_b = c["g"]
    real_a[0, :3, :3] = 0.0           # illumination quotients at max(., ε)
    real_b[1, :3, :3] = -0.5
    j = jax_preset("reference")
    jloss = jax_g_loss_fn(j.replace(loss=dataclasses.replace(j.loss, **OVER)),
                          params, steps_per_epoch=SPE)
    feats = jfid.make_vgg_feature_fn(params)
    # one compile: the loss and its gradient at a step, and one feature
    # call on the 4 batches together (rows are independent)
    jax_side = jax.jit(lambda v, step, images: (jax.value_and_grad(
        lambda f: jloss(f, c["pf"], c["pr"], jnp.asarray(real_a),
                        jnp.asarray(real_b), step), has_aux=True)(v),
        feats(images)))
    images = jnp.asarray(np.concatenate(c["real"] + c["fake"]))
    runs = [jax.tree_util.tree_map(np.asarray, jax_side(
        jnp.asarray(fake), jnp.int32(s), images)) for s in STEPS]
    c["jax_g"] = [g for g, _ in runs]
    c["jax_feats"] = np.split(runs[0][1], 4)
    return c


def test_gram_and_style_loss_match_jax(case):
    f = _nhwc(5, c=16, s=8)
    _close(gram_matrix(_t(f)), jax_gram(jnp.asarray(f)))
    fake, _, real = case["g"]
    with torch.no_grad():
        got = style_loss(case["tvgg"](_t(fake)), case["tvgg"](_t(real)))
    (_, jparts), _ = case["jax_g"][0]
    _close(got.item() * OVER["lambda_style"], jparts["g_style"], rtol=1e-4)


def test_vfid_features_stats_and_distance_match_jax(case):
    tfn = fid.make_vgg_feature_fn(case["tvgg"])
    want = case["jax_feats"]
    got_f = tfn(_t(case["real"][0]))
    assert got_f.shape == (N, fid.FEATURE_DIM) and got_f.dtype == np.float32
    _close(got_f, want[0], rtol=1e-4, atol=1e-6)
    jev = jfid.FIDEvaluator(iter(want).__next__)
    tev = fid.FIDEvaluator(tfn)
    for r, f in zip(case["real"], case["fake"]):
        tev.update(_t(r), _t(f))
    for i in range(2):
        jev.real.update(want[i])
        jev.fake.update(want[2 + i])
    assert tev.real.n == jev.real.n == 2 * N
    _close(tev.compute(), jev.compute(), rtol=1e-4)
    # the float64 host statistics on the same features
    feats = np.random.default_rng(8).normal(size=(7, 5))
    js, ts = jfid.RunningStats(5), fid.RunningStats(5)
    for part in (feats[:3], feats[3:]):
        js.update(part)
        ts.update(part)
    (jm, jc), (tm, tc) = js.finalize(), ts.finalize()
    _close(tm, jm, rtol=1e-12)
    _close(tc, jc, rtol=1e-12)
    other = fid.RunningStats(5)
    other.update(feats[::-1] * 1.5 + 0.25)
    _close(fid.frechet_distance(tm, tc, *other.finalize()),
           jfid.frechet_distance(jm, jc, *other.finalize()), rtol=1e-9)
    mu, cov = fid.gaussian_stats(torch.from_numpy(feats.astype(np.float32)))
    jmu, jcov = jfid.gaussian_stats(jnp.asarray(feats, jnp.float32))
    _close(mu, jmu, rtol=1e-5, atol=1e-7)
    _close(cov, jcov, rtol=1e-5, atol=1e-6)


def test_g_loss_with_style_angular_and_sobel_matches_jax(case):
    fake, real_a, real_b = case["g"]
    t = get_preset("reference")
    tloss = make_g_loss_fn(t.replace(loss=dataclasses.replace(t.loss, **OVER)),
                           case["tvgg"], steps_per_epoch=SPE)
    tb = _t(real_b)
    with torch.no_grad():
        real_feats = case["tvgg"](tb)
    keys = ("g_gan", "g_feat", "g_style", "g_tv", "g_angular", "g_sobel",
            "g_l1")
    sobel = []
    for step, ((jtotal, jparts), jgrad) in zip(STEPS, case["jax_g"]):
        tf = _t(fake, grad=True)
        total, parts = tloss(
            tf, [[_t(x) for x in s] for s in case["pf"]],
            [[_t(x) for x in s] for s in case["pr"]], _t(real_a), tb,
            real_feats, step)
        total.backward()
        assert tuple(parts) == keys and set(jparts) == set(keys)
        for k in keys:
            _close(parts[k].item(), jparts[k], rtol=1e-4)
        _close(total.item(), jtotal, rtol=1e-5)
        _grad_close(tf.grad.permute(0, 2, 3, 1), jgrad)
        sobel.append(parts["g_sobel"].item())
    # the warm-up: half the weight in epoch 1, the whole from epoch 2 on
    assert sobel[1] == pytest.approx(2 * sobel[0], rel=1e-6)
    assert sobel[2] == pytest.approx(sobel[1], rel=1e-6)


def test_perceptual_and_style_share_the_fake_taps(case):
    """With both VGG terms on, one VGG forward of fake_b serves both: the
    parts equal separate ``vgg_loss`` and ``style_loss`` calls."""
    fake, real_a, real_b = case["g"]
    t = get_preset("reference")
    tcfg = t.replace(loss=dataclasses.replace(
        t.loss, **{**OVER, "lambda_vgg": 10.0}))
    tloss = make_g_loss_fn(tcfg, case["tvgg"], steps_per_epoch=SPE)
    tf, tb = _t(fake, grad=True), _t(real_b)
    with torch.no_grad():
        real_feats = case["tvgg"](tb)
    total, parts = tloss(
        tf, [[_t(x) for x in s] for s in case["pf"]],
        [[_t(x) for x in s] for s in case["pr"]], _t(real_a), tb,
        real_feats, 0)
    with torch.no_grad():
        want_vgg = vgg_loss(case["tvgg"], tf, real_feats) * 10.0
        want_style = style_loss(case["tvgg"](tf), real_feats) * OVER[
            "lambda_style"]
    assert torch.equal(parts["g_vgg"].detach(), want_vgg)
    assert torch.equal(parts["g_style"].detach(), want_style)
    total.backward()
    assert tf.grad is not None and torch.isfinite(tf.grad).all()
