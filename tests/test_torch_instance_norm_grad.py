"""The port's instance-norm seam with its autograd Functions against the JAX
package's fused kernels and their custom VJPs, on the CPU.

``_InstanceNorm`` (#1 + #2) is held against ``instance_norm_fused`` and
``_InstanceNormAct`` (#1 + #3) against ``instance_norm_act_fused``, both
run in interpret mode under ``jax.vjp``, on the same numpy inputs and
cotangents: the output and every cotangent (dx, dscale, dbias, dres).
Cases: act none/relu/leaky, with and without a residual and an affine,
C = 3 (the ExpandNetwork head's width) and C = 64, odd extents (33×33),
f32 and bf16, and (in f32) inputs whose normalized values are exactly 0
(dyadic values with a mean of exactly 0), which pin the activation masks
at y == 0 (relu drops the gradient there, leaky passes it). The plain
version of kernel #2 is held against ``_norm_local`` in interpret mode.

Tolerances: f32 outputs, dx and dres within 1e-5 abs + 1e-5 rel (the two
sides differ only in the order of f32 sums); in bf16 they are stored in
bf16 after the same f32 arithmetic, so they agree within one bf16
rounding (2⁻⁷ of the value) plus 1e-5 abs for values near 0 whose f32
precursors differ in the last bits. dscale and dbias are f32 sums over
N·H·W = 2,178 terms taken in another order on each side: within 1e-5 rel
plus 1e-7 (about two f32 epsilons) of a bound on the sum of their terms'
magnitudes, Σ|g|·max|xhat| per channel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops.pallas.instance_norm_kernel import (  # noqa: E402
    _norm_local, instance_norm_fused as jax_in_fused)
from p2p_tpu.ops.pallas.norm_act import instance_norm_act_fused  # noqa: E402
from p2p_tpu_torch.ops import instance_norm as seam  # noqa: E402
from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (  # noqa: E402
    instance_norm_apply, instance_norm_apply_plain, instance_norm_stats)
from p2p_tpu_torch.ops.norm import make_norm, make_norm_act  # noqa: E402

EPS = 1e-5
SLOPE = 0.2
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-5, rtol=2.0 ** -7)
SUM_RTOL, SUM_OF_ABS_TOL = 1e-5, 1e-7
N, H, W = 2, 33, 33
# (C, exact zeros) per dtype: f32 carries the zero-mask cases, bf16 the
# rounding of random values
CASES = {torch.float32: ((3, False), (64, True)),
         torch.bfloat16: ((64, False),)}


def _normal(shape, seed, loc=0.25, scale=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + loc).astype(np.float32)


def _zero_mean_dyadic(shape, seed):
    """NHWC values in multiples of 0.5 whose every (n, c) slice holds
    pairs ±v and some exact zeros: every partial sum is exact, so the mean
    is exactly 0 and the zeros normalize to exactly 0."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    hw = h * w
    half = (hw - hw // 10) // 2
    out = np.empty((n, c, hw), np.float32)
    for i in range(n):
        for j in range(c):
            v = rng.integers(1, 9, half).astype(np.float32) * 0.5
            vals = np.concatenate([v, -v, np.zeros(hw - 2 * half,
                                                   np.float32)])
            out[i, j] = rng.permutation(vals)
    return out.reshape(n, c, h, w).transpose(0, 2, 3, 1).copy()


def _t(a, dtype=torch.float32, grad=False):
    """NHWC numpy → channels_last (N, C, H, W) torch."""
    t = torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype)
    return t.requires_grad_(grad) if grad else t


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _case(c, affine, residual, zeros, seed):
    shape = (N, H, W, c)
    x = (_zero_mean_dyadic(shape, seed) if zeros
         else _normal(shape, seed))
    rng = np.random.default_rng(seed + 1)
    s = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32) if affine \
        else None
    # with zeros, β = 0 and a residual that is 0 where x is: y stays 0
    b = None if not affine else (
        np.zeros(c, np.float32) if zeros
        else (0.1 * rng.normal(size=c)).astype(np.float32))
    r = None
    if residual:
        r = _normal(shape, seed + 2)
        if zeros:
            r = np.where(x == 0, 0.0, np.round(r * 2) / 2).astype(np.float32)
    g = _normal(shape, seed + 3, loc=0.0, scale=1.0)
    return x, s, b, r, g


def _jax_vjp(fn, args, g, jdtype):
    idx = [i for i, a in enumerate(args) if a is not None]

    def f(*live):
        full = list(args)
        for i, v in zip(idx, live):
            full[i] = v
        return fn(*full)

    prim = [jnp.asarray(args[i]).astype(
        jdtype if args[i].ndim == 4 else jnp.float32) for i in idx]

    @jax.jit
    def fwd_bwd(prim, g):
        y, pull = jax.vjp(f, *prim)
        return y, pull(g.astype(y.dtype))

    y, cts = fwd_bwd(prim, jnp.asarray(g))
    out = [None] * len(args)
    for i, ct in zip(idx, cts):
        out[i] = np.asarray(ct.astype(jnp.float32))
    return np.asarray(y.astype(jnp.float32)), out


def _port(fn, args, g, dtype):
    """Run the port's route on torch copies of ``args``; return the output
    and each argument's gradient (None where the argument is absent)."""
    ts = [None if a is None else (
        _t(a, dtype, grad=True) if a.ndim == 4
        else torch.from_numpy(a).requires_grad_(True)) for a in args]
    y = fn(*ts)
    y.backward(_t(g, dtype))
    return y, [None if t is None else (
        _nhwc(t.grad) if t.dim() == 4 else t.grad.numpy()) for t in ts]


def _abs_sum_bound(x, g, dtype):
    """Per channel, Σ_NHW |g| · max |xhat|: a bound on the sum of the
    magnitudes of the terms of dscale and dbias."""
    x = _nhwc(_t(x, dtype)).astype(np.float64)
    xhat = (x - x.mean(axis=(1, 2), keepdims=True)) / np.sqrt(
        x.var(axis=(1, 2), keepdims=True) + EPS)
    return np.abs(g).sum(axis=(0, 1, 2)) * np.maximum(
        1.0, np.abs(xhat).max(axis=(0, 1, 2)))


def _check(y, grads, jy, jgrads, dtype, what, x, g):
    act_tol = F32 if dtype == torch.float32 else BF16
    _close(_nhwc(y), jy, act_tol, f"{what} y")
    names = ("dx", "dscale", "dbias", "dres")
    for name, got, want in zip(names, grads, jgrads):
        assert (got is None) == (want is None), (what, name)
        if got is None:
            continue
        if name in ("dx", "dres"):
            _close(got, want, act_tol, f"{what} {name}")
            continue
        limit = (SUM_RTOL * np.abs(want)
                 + SUM_OF_ABS_TOL * _abs_sum_bound(x, g, dtype))
        excess = np.abs(got - want) - limit
        assert (excess <= 0).all(), (what, name, np.abs(got - want).max())


def test_pallas_instance_routes_go_through_the_autograd_functions():
    """Both ``pallas_instance`` routes carry the port's Functions as their
    ``grad_fn``, on the CPU as on the card."""
    x = _t(_normal((1, 5, 6, 8), 0), grad=True)
    y = make_norm("pallas_instance")(x)
    assert isinstance(y.grad_fn, seam._InstanceNorm._backward_cls)
    z = make_norm_act("pallas_instance")(x, act="relu", residual=x)
    assert isinstance(z.grad_fn, seam._InstanceNormAct._backward_cls)
    (y.square().sum() + z.sum()).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax_vjp(affine, dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for i, (c, zeros) in enumerate(CASES[dtype]):
        x, s, b, _, g = _case(c, affine, False, zeros, 10 * i)
        jy, jgrads = _jax_vjp(
            lambda x_, s_, b_: jax_in_fused(x_, s_, b_, EPS, interpret=True),
            (x, s, b), g, jdtype)
        y, grads = _port(lambda x_, s_, b_: seam.instance_norm_fused(
            x_, s_, b_, EPS), (x, s, b), g, dtype)
        assert isinstance(y.grad_fn, seam._InstanceNorm._backward_cls)
        assert y.dtype == dtype
        _check(y, grads, jy, jgrads, dtype,
               f"C={c} affine={affine} zeros={zeros}", x, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_instance_norm_act_matches_jax_vjp(act, residual, affine, dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for i, (c, zeros) in enumerate(CASES[dtype]):
        x, s, b, r, g = _case(c, affine, residual, zeros, 100 + 10 * i)
        jy, jgrads = _jax_vjp(
            lambda x_, s_, b_, r_: instance_norm_act_fused(
                x_, s_, b_, r_, act=act, slope=SLOPE, eps=EPS,
                interpret=True), (x, s, b, r), g, jdtype)
        y, grads = _port(lambda x_, s_, b_, r_: seam.instance_norm_act(
            x_, s_, b_, r_, act=act, slope=SLOPE, eps=EPS), (x, s, b, r), g,
            dtype)
        assert isinstance(y.grad_fn, seam._InstanceNormAct._backward_cls)
        what = f"{act} C={c} res={residual} affine={affine} zeros={zeros}"
        if zeros:
            # the case is built so that y is exactly 0 at the zeros of x
            ynp = _nhwc(y)
            assert (ynp[x == 0] == 0).all() and (x == 0).sum() > 0, what
        _check(y, grads, jy, jgrads, dtype, what, x, g)


def test_masks_at_exact_zeros_follow_the_jax_rule():
    """At y == 0 relu's gradient is 0 and leaky's is the full g (not
    slope·g), the rule of the JAX VJP, read from the saved output; the
    residual's cotangent is that masked g itself."""
    x = _zero_mean_dyadic((1, 9, 9, 4), 7)
    zero = x == 0
    for act, want in (("relu", 0.0), ("leaky", 1.0)):
        r = _t(np.zeros_like(x), grad=True)
        y = seam.instance_norm_act(_t(x), residual=r, act=act, slope=SLOPE)
        y.backward(torch.ones_like(y))
        assert zero.any() and (_nhwc(y)[zero] == 0).all()
        assert (_nhwc(r.grad)[zero] == want).all(), act


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("c", [3, 8, 64])
def test_apply_plain_matches_pallas_norm_pass(c, affine):
    """#2's plain version (what a CPU tensor runs) against the Pallas
    ``_norm_local`` in interpret mode, on the same statistics."""
    x = _normal((N, 17, 11, c), c)
    xt = _t(x)
    mean, rstd = instance_norm_stats(xt, EPS)
    rng = np.random.default_rng(c + 1)
    s = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32) if affine \
        else None
    b = (0.1 * rng.normal(size=c)).astype(np.float32) if affine else None
    want = _norm_local(
        jnp.asarray(x), jnp.asarray(mean.numpy()[:, None, None, :]),
        jnp.asarray(rstd.numpy()[:, None, None, :]),
        None if s is None else jnp.asarray(s),
        None if b is None else jnp.asarray(b), True)
    ts = None if s is None else torch.from_numpy(s)
    tb = None if b is None else torch.from_numpy(b)
    launches = instance_norm_apply.launches
    got = instance_norm_apply(xt, mean, rstd, ts, tb)
    assert instance_norm_apply.launches == launches
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, instance_norm_apply_plain(
        xt, mean, rstd, ts, tb), atol=0, rtol=0)
    _close(_nhwc(got), want, F32, f"C={c}")


def test_apply_refuses_a_device_it_has_no_route_for():
    x = torch.empty((1, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        instance_norm_apply(x, torch.empty((1, 8), device="meta"),
                            torch.empty((1, 8), device="meta"))
