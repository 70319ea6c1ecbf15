"""The port's int8 convolutions (``p2p_tpu_torch/ops/int8.py``) against
``p2p_tpu.ops.int8`` on the CPU: ``int8_conv``, ``int8_conv_ds`` and
``int8_conv_pq`` forward and both gradients, on the same inputs (numpy,
from seeds).

Tolerances. Every int8 contraction is exact in int32 on both sides and the
dequantization is the same f32 arithmetic, so the forward, the stride-1
dgrad and the int8 wgrad (Ho·Wo ≤ 4096) are held bitwise. The bf16 forms
(stride-2 dgrad; wgrad above 4096 output positions) multiply the same
bf16-rounded operands exactly but sum them in another order (XLA's conv against the library's), up to 8,450
terms in f32: atol 1e-6 + 1e-5 of the tensor's largest entry (measured
7.5e-8 of the largest on the dgrad, 1.7e-6 on the 65² wgrad). Also: exactness
against a float conv on integer grids (as tests/test_int8.py), the amax
update law bitwise, the unscaled gradient through ``surrogate_tap``, the
delayed ``QuantConv``'s transient clipping, and ``int_mm``'s padding.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops import int8 as J  # noqa: E402
from p2p_tpu_torch.ops import int8 as T  # noqa: E402

P2 = ((2, 2), (2, 2))
# (k, strides, padding, H): the D's forms (k4, pad 2, s2 and s1), a k4 s2
# conv with pad 1 on an even input, a k3 s1 conv, and the two sides of the
# 4096 wgrad boundary (64² output: int8; 65²: bf16, which the 64² step
# test never reaches)
CASES = [
    (4, (2, 2), 2, 17),
    (4, (1, 1), 2, 9),
    (4, (2, 2), 1, 16),
    (3, (1, 1), 1, 9),
    (4, (1, 1), 2, 63),
    (4, (1, 1), 2, 64),
    (4, (2, 2), 2, 129),
]
BF16_ATOL, BF16_RTOL_OF_MAX = 1e-6, 1e-5


def _t4(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _n4(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _tw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nw(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


def _inputs(seed, h, k, c=8, o=16, n=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, h, c)).astype(np.float32),
            (0.1 * rng.normal(size=(k, k, c, o))).astype(np.float32), rng)


def _bf16_close(got, want):
    limit = BF16_ATOL + BF16_RTOL_OF_MAX * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= limit


def _int8_forms(strides, out_hw):
    """(dgrad int8, wgrad int8) under the JAX dispatch."""
    return (strides == (1, 1),
            out_hw[0] * out_hw[1] <= T._INT8_WGRAD_SLICE_MAX)


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("k,strides,pad,h", CASES)
def test_int8_conv_forward_and_gradients_match_jax(k, strides, pad, h):
    x, w, rng = _inputs(0, h, k)
    pads = ((pad, pad), (pad, pad))
    yj, vjp = jax.vjp(lambda a, b: J.int8_conv(a, b, strides, pads),
                      jnp.asarray(x), jnp.asarray(w))
    g = rng.normal(size=yj.shape).astype(np.float32)
    dxj, dwj = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt, wt = _t4(x).requires_grad_(), _tw(w).requires_grad_()
    with mock.patch.object(T, "int_mm", wraps=T.int_mm) as mm:
        yt = T.int8_conv(xt, wt, strides, pad)
        assert mm.call_count == 1
        yt.backward(_t4(g))
    np.testing.assert_array_equal(_n4(yt), np.asarray(yj))
    dx_int8, dw_int8 = _int8_forms(strides, yj.shape[1:3])
    assert mm.call_count == 1 + dx_int8 + dw_int8
    _check(_n4(xt.grad), dxj, dx_int8)
    _check(_nw(wt.grad), dwj, dw_int8)


@pytest.mark.parametrize("strides", [(2, 2), (1, 1)])
def test_int8_conv_ds_returns_amax_and_the_jax_gradients(strides):
    x, w, rng = _inputs(1, 13, 4)
    sx = np.float32(0.8 * np.abs(x).max() / 127.0)   # clips the top 20%

    def f(a, b):
        return J.int8_conv_ds(a, b, jnp.asarray(sx), strides, P2)

    (yj, aj), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    g = rng.normal(size=yj.shape).astype(np.float32)
    dxj, dwj = vjp((jnp.asarray(g), jnp.zeros((), jnp.float32)))
    xt, wt = _t4(x).requires_grad_(), _tw(w).requires_grad_()
    yt, at = T.int8_conv_ds(xt, wt, torch.tensor(sx), strides, 2)
    assert not at.requires_grad
    yt.backward(_t4(g))
    np.testing.assert_array_equal(_n4(yt), np.asarray(yj))
    assert float(at) == float(aj) == float(np.abs(x).max())
    _check(_n4(xt.grad), np.asarray(dxj), strides == (1, 1))
    np.testing.assert_array_equal(_nw(wt.grad), np.asarray(dwj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv_pq_takes_the_grid_values_as_they_are(dtype):
    """Prequantized input (integers in [-127, 127] in the compute dtype):
    forward bitwise, gradients w.r.t. the surrogate as JAX's."""
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 128, size=(1, 9, 9, 8)).astype(np.float32)
    w = (0.1 * rng.normal(size=(4, 4, 8, 16))).astype(np.float32)
    sx = np.float32(0.03)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    yj, vjp = jax.vjp(lambda a, b: J.int8_conv_pq(a, b, jnp.asarray(sx),
                                                  (1, 1), P2),
                      jnp.asarray(q, jd), jnp.asarray(w, jd))
    g = rng.normal(size=yj.shape).astype(np.float32)
    dxj, dwj = vjp(jnp.asarray(g, jd))
    qt = _t4(q).to(td).requires_grad_()
    wt = _tw(w).to(td).requires_grad_()
    yt = T.int8_conv_pq(qt, wt, torch.tensor(sx), (1, 1), 2)
    yt.backward(_t4(g).to(td))
    assert yt.dtype == qt.grad.dtype == wt.grad.dtype == td
    for got, want in ((_n4(yt.float()), yj), (_n4(qt.grad.float()), dxj),
                      (_nw(wt.grad.float()), dwj)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def _grid_ints(rng, shape, scale, channel_axis=None):
    """Integer-valued tensor in [-127, 127]·scale with ±127 present (in
    every slice along ``channel_axis``), which absmax quantization
    reproduces exactly."""
    v = rng.integers(-127, 128, size=shape).astype(np.float32)
    if channel_axis is None:
        v.flat[0] = 127.0
    else:
        idx = [0] * len(shape)
        idx[channel_axis] = slice(None)
        v[tuple(idx)] = 127.0
    return v * scale


@pytest.mark.parametrize("k,strides,pad,h", CASES[:4])
def test_int8_conv_is_exact_against_the_float_conv_on_integer_grids(
        k, strides, pad, h):
    """Where quantization is lossless the int8 conv and its int8 gradient
    forms equal the f64 conv's (tests/test_int8.py:62 in the port)."""
    rng = np.random.default_rng(3)
    x = _grid_ints(rng, (2, h, h, 8), 0.5)
    w = _grid_ints(rng, (k, k, 8, 16), 0.25, channel_axis=3)
    xt, wt = _t4(x).requires_grad_(), _tw(w).requires_grad_()
    yt = T.int8_conv(xt, wt, strides, pad)
    x64 = _t4(x).double().requires_grad_()
    w64 = _tw(w).double().requires_grad_()
    y64 = torch.nn.functional.conv2d(x64, w64, stride=strides, padding=pad)
    np.testing.assert_array_equal(yt.detach().double().numpy(),
                                  y64.detach().numpy())
    ct = _t4(_grid_ints(rng, tuple(yt.permute(0, 2, 3, 1).shape), 2.0))
    yt.backward(ct)
    y64.backward(ct.double())
    dx_int8, dw_int8 = _int8_forms(strides, yt.shape[2:])
    for got, want, exact in ((xt.grad, x64.grad, dx_int8),
                             (wt.grad, w64.grad, dw_int8)):
        if exact:
            np.testing.assert_array_equal(got.double().numpy(),
                                          want.numpy())
        else:
            np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_int_mm_pads_to_the_library_limits_exactly():
    rng = np.random.default_rng(4)
    for m, k, n in ((5, 7, 3), (17, 1089, 512), (33, 24, 16)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        got = T.int_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, (a.long() @ b.long()).int())


def test_scales_and_amax_update_are_the_jax_arithmetic():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        float(T.absmax_scale(torch.from_numpy(x))),
        float(J.absmax_scale(jnp.asarray(x))))
    w = rng.normal(size=(4, 4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        T.absmax_scale(_tw(w), dim=(1, 2, 3)).reshape(-1).numpy(),
        np.asarray(J.absmax_scale(jnp.asarray(w), axis=(0, 1, 2))
                   ).reshape(-1))
    cur = rng.uniform(0, 4, 64).astype(np.float32)
    stored = rng.uniform(0, 4, 64).astype(np.float32)
    got = T.amax_update(torch.from_numpy(cur), torch.from_numpy(stored))
    want = J.amax_update(jnp.asarray(cur), jnp.asarray(stored))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nan = T.amax_update(torch.tensor(float("nan")), torch.tensor(1.0))
    assert torch.isnan(nan)


def test_surrogate_tap_passes_the_cotangent_unscaled():
    q = torch.tensor([[-3.0, 0.0, 127.0]], requires_grad=True)
    sx = torch.tensor(0.03)
    tap = T.surrogate_tap(q, sx)
    want = J.surrogate_tap(jnp.asarray(q.detach().numpy()), jnp.asarray(0.03))
    np.testing.assert_array_equal(tap.detach().numpy(), np.asarray(want))
    tap.sum().backward()
    assert torch.equal(q.grad, torch.ones_like(q))


def test_delayed_quant_conv_updates_amax_and_clips_transiently():
    """``amax_x``: set from the first input by the init pass, raised at
    once by a larger input, decayed by AMAX_DECAY by a smaller one; the
    clipped input is quantized at ±127 for that step (the port pin of
    tests/test_int8.py:242). Eval mode leaves it alone."""
    m = T.QuantConv(4, 8, kernel_size=4, stride=2, padding=1, delayed=True)
    rng = np.random.default_rng(1)
    x = _t4(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    a0 = float(x.abs().max())
    m.init_amax = True
    with torch.no_grad():
        m(x)
    m.init_amax = False
    assert float(m.amax_x) == a0
    with torch.no_grad():
        y2 = m(2.0 * x)
    assert float(m.amax_x) == float(2.0 * x.abs().max())
    # that step quantized 2x with the stale scale of x: the top half of the
    # values clipped at ±127; the next step, at the raised scale, does not
    with torch.no_grad():
        y3 = m(2.0 * x)
        exact = torch.nn.functional.conv2d(2.0 * x, m.weight, m.bias, 2, 1)
    assert not torch.equal(y2, y3)
    assert (y3 - exact).abs().max() < (y2 - exact).abs().max()
    with torch.no_grad():
        m(0.01 * x)
    assert float(m.amax_x) == pytest.approx(
        T.AMAX_DECAY * 2 * a0, rel=1e-6)
    before = m.amax_x.clone()
    m.eval()
    with torch.no_grad():
        m(5.0 * x)
    assert torch.equal(m.amax_x, before)
    with pytest.raises(ValueError, match="delayed=True"):
        T.QuantConv(4, 8, epilogue=lambda y, s: (y, s))
