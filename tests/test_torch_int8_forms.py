"""The int8 forms of the port's last int8 slice (``p2p_tpu_torch/ops/int8.py``,
``ops/conv.py`` ``ConvLayer(int8=True)``, ``ops/spectral_norm.py``)
against ``p2p_tpu.ops`` on the CPU, on the same inputs (numpy, from
seeds), each through ``jax.vjp``: the kn2row pair, the lhs-dilated and
asymmetrically padded int8 conv, ``QuantConvTranspose``,
``QuantSubpixelDeconv`` with its amax update, ``ConvLayer`` int8 (k5, k3,
k3-s2) and ``SpectralConv`` int8 in its three forms.

Tolerances. Every int8 contraction is exact in int32 on both sides and
its dequantization is the same f32 arithmetic, so the forwards, the int8
dgrads and the int8 wgrads are held bitwise (op-level forward products on
the same int8 operands). The bf16 forms (the stride-2 dgrad, the
transposed conv's wgrad, the kn2row dgrad) multiply the same bf16-rounded
operands exactly but sum them in another order: atol 1e-6 + 1e-5 of the
tensor's largest entry, as tests/test_torch_int8.py. A bias gradient,
and the reflect pad's gradient at the border, are f32 sums in another
order: 1e-6 of the tensor's largest entry (measured 4e-7). Under spectral norm
σ comes from an f32 power iteration whose sums run in another order, so
w/σ and every result after it move in their last bits: 2e-6 of each
tensor's largest entry (measured below 3e-7), ``u`` within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops import int8 as J  # noqa: E402
from p2p_tpu.ops.conv import ConvLayer as JaxConvLayer  # noqa: E402
from p2p_tpu.ops.spectral_norm import SpectralConv as JaxSpectral  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402
from p2p_tpu_torch.ops import int8 as T  # noqa: E402
from p2p_tpu_torch.ops.conv import ConvLayer  # noqa: E402
from p2p_tpu_torch.ops.spectral_norm import SpectralConv  # noqa: E402

BF16_ATOL, BF16_RTOL_OF_MAX = 1e-6, 1e-5
SUM_RTOL_OF_MAX = 1e-6
SN_RTOL_OF_MAX, U_ATOL = 2e-6, 1e-6


def _t4(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _n4(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _tw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nw(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


def _close(got, want, rtol_of_max=BF16_RTOL_OF_MAX, atol=BF16_ATOL):
    want = np.asarray(want)
    limit = atol + rtol_of_max * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= limit


def _x(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _vjp(f, args, ct_fn):
    """``(out, cotangents of args)`` of ``f`` under ``jax.vjp`` with the
    cotangent ``ct_fn(out)``. Eager: under ``jit`` XLA divides by 127 as a
    multiply by its reciprocal, one bit off the eager quotient the port
    reproduces, so jitted scales would not test bitwise equality."""
    out, vjp = jax.vjp(f, *args)
    return out, vjp(ct_fn(out))


@pytest.mark.parametrize("delayed", [False, True])
def test_kn2row_pair_forward_and_its_own_backward(delayed):
    """D's thin head (k4 → 1 channel, pad 2): the forward bitwise, the
    bf16 dgrad within the bf16 band, the int8 wgrad (Q(bf16(g)) at
    absmax(bf16(g)), no 4096 window) bitwise, and with a stored scale the
    amax of the quantize pass."""
    rng = np.random.default_rng(0)
    x, w = _x(rng, (2, 9, 9, 32)), 0.1 * _x(rng, (4, 4, 32, 1))
    sx = np.float32(0.8 * np.abs(x).max() / 127.0)
    if delayed:
        f = lambda a, b: J.int8_kn2row_conv_ds(a, b, jnp.asarray(sx), 2)  # noqa
    else:
        f = lambda a, b: J.int8_kn2row_conv(a, b, 2)  # noqa: E731
    g = _x(rng, (2, 10, 10, 1))
    ct = (lambda o: (jnp.asarray(g), jnp.zeros((), jnp.float32))) \
        if delayed else (lambda o: jnp.asarray(g))
    out, (dxj, dwj) = _vjp(f, (jnp.asarray(x), jnp.asarray(w)), ct)
    yj = out[0] if delayed else out
    xt, wt = _t4(x).requires_grad_(), _tw(w).requires_grad_()
    if delayed:
        yt, at = T.int8_kn2row_conv_ds(xt, wt, torch.tensor(sx), 2)
        assert float(at) == float(out[1]) == float(np.abs(x).max())
    else:
        yt = T.int8_kn2row_conv(xt, wt, 2)
    yt.backward(_t4(g))
    np.testing.assert_array_equal(_n4(yt), np.asarray(yj))
    _close(_n4(xt.grad), dxj)
    np.testing.assert_array_equal(_nw(wt.grad), np.asarray(dwj))


# (strides, padding, lhs_dilation, H): asymmetric pads at stride 1 (int8
# dgrad) and 2 (bf16 dgrad), and an lhs-dilated (transposed) form whose
# dgrad stays int8 and whose wgrad is bf16 (QuantConvTranspose below
# takes the symmetric (2, 2) one)
GENERAL = [
    ((1, 1), ((2, 1), (0, 3)), (1, 1), 8),
    ((2, 2), ((1, 2), (2, 0)), (1, 1), 8),
    ((1, 1), ((1, 2), (2, 1)), (2, 3), 8),
]


@pytest.mark.parametrize("strides,pads,lhs,h", GENERAL)
def test_general_padding_and_lhs_dilation_match_jax(strides, pads, lhs, h):
    rng = np.random.default_rng(1)
    x, w = _x(rng, (2, h, h, 8)), 0.1 * _x(rng, (4, 4, 8, 16))
    f = lambda a, b: J.int8_conv(a, b, strides, pads, lhs)  # noqa: E731
    g = _x(rng, jax.eval_shape(f, x, w).shape)
    yj, (dxj, dwj) = _vjp(f, (jnp.asarray(x), jnp.asarray(w)),
                          lambda o: jnp.asarray(g))
    dxj, dwj = np.asarray(dxj), np.asarray(dwj)
    xt, wt = _t4(x).requires_grad_(), _tw(w).requires_grad_()
    yt = T.int8_conv(xt, wt, strides, pads, lhs)
    yt.backward(_t4(g))
    np.testing.assert_array_equal(_n4(yt), np.asarray(yj))
    if strides == (1, 1):
        np.testing.assert_array_equal(_n4(xt.grad), dxj)
    else:
        _close(_n4(xt.grad), dxj)
    if lhs == (1, 1):
        np.testing.assert_array_equal(_nw(wt.grad), dwj)
    else:
        _close(_nw(wt.grad), dwj)


def _conv_vars(rng, k, cin, cout, x, inner=False, delayed=True,
               u=False):
    """A flax conv's variables from the seed (no flax init compile): the
    HWIO kernel and bias under ``Conv_0`` with ``inner``, the stored amax
    at 0.7 of max|x| (the forward clips) and a spectral ``u``."""
    p = {"kernel": 0.1 * _x(rng, (k, k, cin, cout)),
         "bias": 0.1 * _x(rng, (cout,))}
    q = {"amax_x": np.float32(0.7 * np.abs(x).max())}
    wrap = (lambda t: {"Conv_0": t}) if inner else (lambda t: t)
    v = {"params": wrap(p)}
    if delayed:
        v["quant"] = wrap(q)
    if u:
        uu = _x(rng, (cout,))
        v["spectral"] = {"u": uu / np.linalg.norm(uu)}
    return v


def _flax_grads(module, variables, x, g, mutable=("quant",)):
    """Output, updated collections and (d params, dx) of a flax module
    under ``jax.vjp`` with cotangent ``g``."""
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def f(p, a):
        return module.apply({"params": p, **rest}, a, mutable=list(mutable))

    (y, upd), (dp, dx) = _vjp(f, (params, jnp.asarray(x)), lambda o: (
        jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, o[1])))
    return y, upd, dp, dx


def _port_grads(net, x, g):
    xt = _t4(x).requires_grad_()
    y = net(xt)
    y.backward(_t4(g))
    return y, xt.grad, {k: p.grad for k, p in net.named_parameters()}


@pytest.mark.parametrize("delayed", [False, True])
def test_quant_conv_transpose_matches_jax(delayed):
    """k4 s2 'SAME' as the lhs-dilated int8 conv: the forward and the int8
    dgrad bitwise, the bf16 wgrad within the band, the stored scale's
    update bitwise."""
    rng = np.random.default_rng(2)
    x = _x(rng, (1, 8, 8, 8))
    jm = J.QuantConvTranspose(8, delayed=delayed)
    v = _conv_vars(rng, 4, 8, 8, x, delayed=delayed)
    g = _x(rng, (1, 16, 16, 8))
    yj, upd, dp, dxj = _flax_grads(jm, v, x, g)
    tm = T.QuantConvTranspose(8, 8, delayed=delayed)
    tm.load_state_dict(state_from_flax(*v.values(), module=tm))
    y, dx, grads = _port_grads(tm, x, g)
    np.testing.assert_array_equal(_n4(y), np.asarray(yj))
    np.testing.assert_array_equal(_n4(dx), np.asarray(dxj))
    want = state_from_flax(jax.tree_util.tree_map(np.asarray, dp),
                           module=tm)
    _close(grads["weight"].numpy(), want["weight"].numpy())
    _close(grads["bias"].numpy(), want["bias"].numpy(), SUM_RTOL_OF_MAX,
           0.0)
    if delayed:
        assert float(tm.amax_x) == float(upd["quant"]["amax_x"])


def test_quant_subpixel_deconv_and_its_amax_update_match_jax():
    rng = np.random.default_rng(3)
    x = _x(rng, (1, 8, 8, 8))
    jm = J.QuantSubpixelDeconv(8, delayed=True)
    # a stored scale below the input's max: the forward clips, the update
    # takes the measured max
    v = _conv_vars(rng, 2, 8, 32, x, inner=True)
    g = _x(rng, (1, 16, 16, 8))
    yj, upd, dp, dxj = _flax_grads(jm, v, x, g)
    tm = T.QuantSubpixelDeconv(8, 8, delayed=True)
    tm.load_state_dict(state_from_flax(*v.values(), module=tm))
    assert set(tm.state_dict()) == {"conv.kernel", "conv.bias",
                                    "conv.amax_x"}
    y, dx, grads = _port_grads(tm, x, g)
    np.testing.assert_array_equal(_n4(y), np.asarray(yj))
    np.testing.assert_array_equal(_n4(dx), np.asarray(dxj))
    want = state_from_flax(jax.tree_util.tree_map(np.asarray, dp),
                           module=tm)
    np.testing.assert_array_equal(grads["conv.kernel"].numpy(),
                                  want["conv.kernel"].numpy())
    _close(grads["conv.bias"].numpy(), want["conv.bias"].numpy(),
           SUM_RTOL_OF_MAX, 0.0)
    assert float(tm.conv.amax_x) == float(
        upd["quant"]["Conv_0"]["amax_x"]) == float(np.abs(x).max())


@pytest.mark.parametrize("k,stride", [(5, 1), (3, 1), (3, 2)])
def test_conv_layer_int8_matches_jax(k, stride):
    """net_c's three ConvLayers: reflect pad outside, the int8 conv with
    zero padding 0 inside; forward, weight gradient and the amax update
    bitwise, the input gradient within its band (the k3-s2 dgrad within
    the bf16 band)."""
    rng = np.random.default_rng(4)
    x = _x(rng, (1, 8, 8, 8))
    jm = JaxConvLayer(8, kernel_size=k, stride=stride, int8=True,
                      int8_delayed=True)
    v = _conv_vars(rng, k, 8, 8, x, inner=True)
    ho = 8 // stride
    g = _x(rng, (1, ho, ho, 8))
    yj, upd, dp, dxj = _flax_grads(jm, v, x, g)
    tm = ConvLayer(8, 8, k, stride=stride, int8=True, int8_delayed=True)
    tm.load_state_dict(state_from_flax(*v.values(), module=tm))
    assert isinstance(tm.conv, T.QuantConv)
    y, dx, grads = _port_grads(tm, x, g)
    np.testing.assert_array_equal(_n4(y), np.asarray(yj))
    if stride == 1:
        # the int8 dgrad, then the reflect pad's f32 border sums
        _close(_n4(dx), dxj, SUM_RTOL_OF_MAX, 0.0)
    else:
        _close(_n4(dx), dxj)
    want = state_from_flax(jax.tree_util.tree_map(np.asarray, dp),
                           module=tm)
    np.testing.assert_array_equal(grads["conv.weight"].numpy(),
                                  want["conv.weight"].numpy())
    _close(grads["conv.bias"].numpy(), want["conv.bias"].numpy(),
           SUM_RTOL_OF_MAX, 0.0)
    assert float(tm.conv.amax_x) == float(upd["quant"]["Conv_0"]["amax_x"])


def _leaky_quant(xp):
    """A quantize epilogue of the same arithmetic on both sides:
    ``(clip(round(leaky(y)/sx)), max|leaky(y)|)``."""
    def ep(y, sx):
        a = xp.where(y > 0, y, 0.2 * y)
        q = xp.clip(xp.round(a.astype(xp.float32) / sx), -127, 127)
        return q.astype(y.dtype), xp.abs(a.astype(xp.float32)).max()
    return ep


def _torch_leaky_quant(y, sx):
    a = torch.where(y > 0, y, 0.2 * y)
    q = torch.clamp(torch.round(a.float() / sx), -127, 127)
    return q.to(y.dtype), a.float().abs().amax()


@pytest.mark.parametrize("form", ["dynamic", "delayed", "epilogue"])
def test_spectral_conv_int8_matches_jax_with_the_same_u(form):
    """Only w/σ is quantized; the power iteration and ``u`` as in the
    plain path. The epilogue form returns the surrogate tap."""
    rng = np.random.default_rng(5)
    x = _x(rng, (1, 8, 8, 8))
    ep = form == "epilogue"
    jm = JaxSpectral(8, kernel_size=4, stride=2, padding=2, int8=True,
                     int8_delayed=form != "dynamic",
                     epilogue=_leaky_quant(jnp) if ep else None,
                     epilogue_tap=ep)
    v = _conv_vars(rng, 4, 8, 8, x, delayed=form != "dynamic", u=True)
    mut = ("spectral", "quant") if form != "dynamic" else ("spectral",)
    g = _x(rng, (1, 5, 5, 8))
    params = v["params"]
    rest = {k: val for k, val in v.items() if k != "params"}

    def f(p, a):
        o, upd = jm.apply({"params": p, **rest}, a, mutable=list(mut))
        return (o[0], o[1]) if ep else (o, o), upd

    ((yj, tapj), upd), (dp, dxj) = _vjp(f, (params, jnp.asarray(x)), lambda o: (
        (jnp.asarray(g), jnp.zeros_like(o[0][1])),
        jax.tree_util.tree_map(jnp.zeros_like, o[1])))
    tm = SpectralConv(8, 8, 4, stride=2, padding=2, int8=True,
                      int8_delayed=form != "dynamic",
                      epilogue=_torch_leaky_quant if ep else None,
                      epilogue_tap=ep)
    tm.load_state_dict(state_from_flax(*v.values(), module=tm))
    xt = _t4(x).requires_grad_()
    o = tm(xt)
    y, tap = o if ep else (o, None)
    y.backward(_t4(g))
    for got, want in ((_n4(y), yj), (_n4(xt.grad), dxj)):
        _close(got, want, SN_RTOL_OF_MAX, 0.0)
    if ep:
        _close(_n4(tap), tapj, SN_RTOL_OF_MAX, 0.0)
    want = state_from_flax(jax.tree_util.tree_map(np.asarray, dp),
                           module=tm)
    for k, p in tm.named_parameters():
        _close(p.grad.numpy(), want[k].numpy(), SN_RTOL_OF_MAX, 0.0)
    np.testing.assert_allclose(tm.u.numpy(), np.asarray(
        upd["spectral"]["u"]), atol=U_ATOL, rtol=0)
    if form != "dynamic":
        assert float(tm.amax_x) == pytest.approx(
            float(upd["quant"]["amax_x"]), rel=1e-6)
