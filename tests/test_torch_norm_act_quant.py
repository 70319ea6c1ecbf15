"""Kernel #4, the quantize-fused epilogue, in the port against the JAX
package on the CPU.

- The plain version of #4 (``ops/cuda/norm_act.py norm_act_quant_plain``,
  what the wrapper computes on a CPU tensor) against the Pallas kernel
  ``_norm_act_quant_local`` in interpret mode, both fed the same mean and
  rstd: q and amax bitwise, for none/relu/leaky, with and without the
  affine, in f32 and bf16, at a scale whose quotients hit rounding ties
  (2⁻⁴, on inputs from binary grids) and at an absmax scale. XLA compiles
  the affine ``y·γ + β`` as one fused multiply-add, and so do the port's
  plain version and kernel.
- ``_InstanceNormActQuant`` (ops/instance_norm.py; #1 then #4, the
  straight-through backward) against ``jax.vjp`` of
  ``instance_norm_act_quant(use_kernel=True, interpret=True)``. The
  statistics are summed in another order on each side, so q may move by
  one step where yc/sx lies within an ulp of a tie: at most 0.5% of q
  differ, by 1 (measured: none); amax within 1e-6 relative. The backward
  takes the same mask and closed form: dx, dγ and dβ within 1e-5 of each
  tensor's largest entry (f32 sums of H·W = 144 terms in another order).
- The ``make_norm_act(quant_scale=)`` guards.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops.pallas import norm_act as jna  # noqa: E402
from p2p_tpu_torch.ops import norm as tnorm  # noqa: E402
from p2p_tpu_torch.ops.cuda import norm_act as tna  # noqa: E402
from p2p_tpu_torch.ops.instance_norm import (  # noqa: E402
    instance_norm_act_quant)

ACTS = ("none", "relu", "leaky")
Q_FLIP_SHARE = 5e-3
AMAX_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5


def _t4(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _n4(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _case(seed, affine, n=2, h=12, w=12, c=16, dyadic=False):
    """x, mean, rstd and the affine; ``dyadic`` puts them on coarse binary
    grids, so the activation divided by a power of two hits ties."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, c)) * 2 + 0.5).astype(np.float32)
    mean = rng.normal(size=(n, c)).astype(np.float32) * 0.5 + 0.5
    rstd = rng.uniform(0.4, 0.6, size=(n, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32) * 0.2
    if dyadic:
        x, mean, scale, bias = (np.round(v * 16) / 16 for v in
                                (x, mean, scale, bias))
        rstd = np.round(rstd * 4) / 4
    if not affine:
        scale = bias = None
    return x, mean, rstd, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("sx_kind", ["tie", "absmax"])
def test_plain_version_is_bitwise_the_pallas_kernel(dtype, affine, act,
                                                    sx_kind):
    x, mean, rstd, scale, bias = _case(0, affine, dyadic=sx_kind == "tie")
    sx = np.float32(2.0 ** -4 if sx_kind == "tie" else 3.1 / 127.0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    n, c = mean.shape
    qj, aj = jax.jit(lambda a: jna._norm_act_quant_local(
        a, jnp.asarray(mean).reshape(n, 1, 1, c),
        jnp.asarray(rstd).reshape(n, 1, 1, c),
        None if scale is None else jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), jnp.asarray(sx), act,
        0.2, True))(jnp.asarray(x, jd))
    opt = (lambda v: None if v is None else torch.from_numpy(v))
    before = tna.norm_act_quant.launches
    qt, at = tna.norm_act_quant(_t4(x, td), torch.from_numpy(mean),
                                torch.from_numpy(rstd), opt(scale),
                                opt(bias), torch.tensor(sx), act, 0.2)
    assert tna.norm_act_quant.launches == before   # the CPU takes the plain
    assert qt.dtype == td and at.dtype == torch.float32 and at.dim() == 0
    np.testing.assert_array_equal(_n4(qt), np.asarray(qj, np.float32))
    assert float(at) == float(aj)
    if sx_kind == "tie":
        yc = tna.norm_act_plain(_t4(x, td), torch.from_numpy(mean),
                                torch.from_numpy(rstd), opt(scale),
                                opt(bias), None, act).float() / float(sx)
        assert bool(((yc - yc.floor()) == 0.5).any())   # ties were hit


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_function_forward_and_backward_match_the_jax_vjp(affine, act):
    x, _, _, scale, bias = _case(1, affine)
    sx = np.float32(np.abs(x).max() / 2 / 127.0)
    rng = np.random.default_rng(2)
    g = rng.normal(size=x.shape).astype(np.float32)

    def f(a, s, b):
        return jna.instance_norm_act_quant(
            a, jnp.asarray(sx), s, b, act=act, slope=0.2, use_kernel=True,
            interpret=True)

    args = (jnp.asarray(x), None if scale is None else jnp.asarray(scale),
            None if bias is None else jnp.asarray(bias))
    (qj, aj), vjp = jax.vjp(f, *args)
    dxj, dsj, dbj = vjp((jnp.asarray(g), jnp.zeros((), jnp.float32)))

    xt = _t4(x).requires_grad_()
    st = None if scale is None else torch.from_numpy(scale).requires_grad_()
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_()
    qt, at = instance_norm_act_quant(xt, torch.tensor(sx), st, bt, act=act,
                                     slope=0.2)
    assert not at.requires_grad
    dq = np.abs(_n4(qt) - np.asarray(qj))
    assert dq.max() <= 1 and (dq > 0).mean() <= Q_FLIP_SHARE
    assert float(at) == pytest.approx(float(aj), rel=AMAX_RTOL)
    qt.backward(_t4(g))
    pairs = [(_n4(xt.grad), dxj)]
    if scale is not None:
        pairs += [(st.grad.numpy(), dsj), (bt.grad.numpy(), dbj)]
    for got, want in pairs:
        want = np.asarray(want)
        limit = GRAD_RTOL_OF_MAX * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= limit


def test_reference_form_matches_the_jax_reference():
    """``instance`` takes the lax reference (two-pass statistics) under the
    same backward, as the JAX CPU path does."""
    x, _, _, _, _ = _case(3, False)
    sx = np.float32(np.abs(x).max() / 2 / 127.0)
    qj, aj = jna.instance_norm_act_quant(jnp.asarray(x), jnp.asarray(sx),
                                         act="leaky", slope=0.2)
    na = tnorm.make_norm_act("instance")
    qt, at = na(_t4(x), act="leaky", slope=0.2,
                quant_scale=torch.tensor(sx))
    dq = np.abs(_n4(qt) - np.asarray(qj))
    assert dq.max() <= 1 and (dq > 0).mean() <= Q_FLIP_SHARE
    assert float(at) == pytest.approx(float(aj), rel=AMAX_RTOL)


def test_quant_scale_guards():
    y = _t4(np.zeros((1, 4, 4, 8), np.float32))
    s = torch.tensor(0.01)
    with pytest.raises(ValueError, match="residual"):
        tnorm.make_norm_act("pallas_instance")(y, quant_scale=s, residual=y)
    for kind in ("none", "instance"):
        with pytest.raises(ValueError, match="instance-family"):
            tnorm.make_norm_act(kind)(
                y, quant_scale=s, residual=y if kind == "instance" else None)
    with pytest.raises(ValueError, match="instance-family"):
        tnorm.make_norm_act("batch", 8)(y, quant_scale=s)
    q, amax = tnorm.make_norm_act("pallas_instance")(y, act="leaky",
                                                    quant_scale=s)
    assert q.shape == y.shape and float(amax) == 0.0
