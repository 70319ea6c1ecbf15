"""The subpixel image head (kernels #6 and #7 through their plain versions
on the CPU) against the JAX package.

``SubpixelHeadConv`` is held against the JAX ``subpixel_head_conv`` run in
interpret mode, forward and both gradients of ``Σ sin(z)``: in f32 within
atol 1e-4 (the bound of tests/test_ops.py's own check of that kernel
against XLA's conv); with bf16 operands z within atol 1e-4 (bf16 products
are exact in f32, only the order of the f32 sums differs), dx within one
bf16 rounding of its value (2⁻⁸ relative, + 1e-3 for values near 0) and
dW, a bf16 conv of the bf16-cast dz in both packages, within 2⁻⁷ relative
+ 1e-2. The interleave is held bitwise, and ``SubpixelDeconv`` with
converted weights against the JAX module within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops.conv import SubpixelDeconv as JaxSubpixelDeconv  # noqa: E402
from p2p_tpu.ops.conv import (  # noqa: E402
    subpixel_interleave as jax_interleave)
from p2p_tpu.ops.pallas.subpixel_head import (  # noqa: E402
    subpixel_head_conv as jax_head_conv)
from p2p_tpu_torch.convert import load_flax  # noqa: E402
from p2p_tpu_torch.ops.conv import (  # noqa: E402
    SubpixelDeconv, subpixel_interleave)
from p2p_tpu_torch.ops.cuda.subpixel_head import (  # noqa: E402
    subpixel_head_conv, subpixel_head_dx, subpixel_head_dx_plain,
    subpixel_head_fwd, subpixel_head_fwd_plain)

CL = torch.channels_last


def _nchw(a, dtype=torch.float32, grad=False):
    """NHWC numpy → channels_last (N, C, H, W) leaf tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
    t = t.to(dtype).detach()
    return t.requires_grad_(grad)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, 10, 32)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 32, 12)) * 0.1).astype(np.float32)
    return x, w


def _jax_fwd_and_grads(x, w):
    f = lambda x, k: jnp.sum(jnp.sin(jax_head_conv(x, k, True)))  # noqa
    z = jax_head_conv(x, w, True)
    dx, dw = jax.grad(f, (0, 1))(x, w)
    return np.asarray(z), np.asarray(dx.astype(jnp.float32)), np.asarray(
        dw.astype(jnp.float32))


def _port_fwd_and_grads(x, w, dtype):
    xt = _nchw(x, dtype, grad=True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    z = subpixel_head_conv(xt, wt)
    torch.sin(z).sum().backward()
    return (z.detach().permute(0, 2, 3, 1).numpy(), _nhwc(xt.grad),
            wt.grad.float().numpy(), z, xt.grad, wt.grad)


def test_f32_forward_and_both_gradients_match_the_jax_kernel():
    x, w = _inputs()
    jz, jdx, jdw = _jax_fwd_and_grads(jnp.asarray(x), jnp.asarray(w))
    z, dx, dw, tz, tdx, tdw = _port_fwd_and_grads(x, w, torch.float32)
    assert tz.dtype == torch.float32 and tz.shape == (2, 12, 13, 11)
    assert tz.is_contiguous(memory_format=CL)
    assert tdx.dtype == torch.float32 and tdw.dtype == torch.float32
    np.testing.assert_allclose(z, jz, atol=1e-4)
    np.testing.assert_allclose(dx, jdx, atol=1e-4)
    np.testing.assert_allclose(dw, jdw, atol=1e-4)


def test_bf16_operands_match_the_jax_kernel():
    x, w = _inputs(1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    jz, jdx, jdw = _jax_fwd_and_grads(xb, wb)
    z, dx, dw, tz, tdx, tdw = _port_fwd_and_grads(x, w, torch.bfloat16)
    assert tz.dtype == torch.float32
    assert tdx.dtype == torch.bfloat16 and tdw.dtype == torch.bfloat16
    np.testing.assert_allclose(z, jz, atol=1e-4)
    np.testing.assert_allclose(dx, jdx, rtol=2.0 ** -8, atol=1e-3)
    np.testing.assert_allclose(dw, jdw, rtol=2.0 ** -7, atol=1e-2)


def test_plain_dx_is_the_gradient_of_the_plain_forward():
    x, w = _inputs(2)
    xt = _nchw(x, grad=True)
    wt = torch.from_numpy(w)
    z = subpixel_head_fwd_plain(xt, wt)
    dz = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))
    (z * dz).sum().backward()
    torch.testing.assert_close(subpixel_head_dx_plain(dz, wt), xt.grad,
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    x, w = _inputs(3)
    xt, wt = _nchw(x), torch.from_numpy(w)
    n_fwd, n_dx = subpixel_head_fwd.launches, subpixel_head_dx.launches
    z = subpixel_head_fwd(xt, wt)
    torch.testing.assert_close(z, subpixel_head_fwd_plain(xt, wt),
                               atol=0, rtol=0)
    torch.testing.assert_close(subpixel_head_dx(z, wt),
                               subpixel_head_dx_plain(z, wt), atol=0, rtol=0)
    assert (subpixel_head_fwd.launches, subpixel_head_dx.launches) == (
        n_fwd, n_dx)


def test_wrappers_refuse_a_device_they_have_no_route_for():
    x = torch.empty((1, 8, 4, 4), device="meta")
    w = torch.empty((2, 2, 8, 12), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        subpixel_head_fwd(x, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        subpixel_head_dx(torch.empty((1, 12, 5, 5), device="meta"), w)


@pytest.mark.parametrize("f", [1, 3])
def test_interleave_is_bitwise_the_jax_interleave(f):
    z = np.random.default_rng(f).normal(size=(2, 7, 9, 4 * f)).astype(
        np.float32)
    want = np.asarray(jax_interleave(jnp.asarray(z), f))
    got = subpixel_interleave(_nchw(z), f)
    assert got.shape == (2, f, 12, 16)
    assert got.is_contiguous(memory_format=CL)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("pallas", [True, False])
def test_subpixel_deconv_with_converted_weights_matches_jax(pallas):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    jm = JaxSubpixelDeconv(3, pallas=pallas)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["Conv_0"]["bias"] = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = load_flax(SubpixelDeconv(64, 3, pallas=pallas), params)
    assert port.conv.kernel.shape == (2, 2, 64, 12)
    np.testing.assert_array_equal(port.conv.kernel.detach().numpy(),
                                  params["Conv_0"]["kernel"])
    got = port(_nchw(x))
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=1e-5)
