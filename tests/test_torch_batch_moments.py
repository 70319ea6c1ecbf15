"""Kernel #5's plain version and the port's BatchNorm against the JAX
package on the CPU.

``batch_moments`` (the wrapper, which takes the plain version for a CPU
tensor) is held against ``pallas_dual_moments`` in interpret mode (as
tests/test_ops.py runs it) and against the JAX ``dual_moments``, at
C ∈ {3, 8, 128} and an M that no block size divides evenly into the
port's chunks; the autograd backward against ``jax.vjp`` of
``dual_moments``; and ``BatchNorm`` against flax ``BatchNorm``
(``_FastBatchNorm``) in train and eval mode, with both running-statistic
updates of a train step. Inputs come from numpy with a seed; every
channel has its own mean and spread, one of them a large mean with a
small spread. JAX runs with ``P2P_PALLAS_BN`` unset.

Tolerances: sums of M ≤ 291 f32 values taken in another order: rtol 1e-5
plus atol 1e-4 (as tests/test_ops.py holds the Pallas kernel against the
XLA path); BatchNorm statistics and gradients: atol 1e-5, rtol 1e-4;
BatchNorm outputs: atol 5e-4, the f32 rounding of the two cancelling
terms of the folded affine on the large-mean channel.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.ops.norm import BatchNorm as JaxBatchNorm  # noqa: E402
from p2p_tpu.ops.norm import dual_moments as jax_dual_moments  # noqa: E402
from p2p_tpu.ops.pallas.batch_moments import pallas_dual_moments  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402
from p2p_tpu_torch.ops.cuda.batch_moments import (  # noqa: E402
    batch_moments, batch_moments_plain)
from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (  # noqa: E402
    stats_geometry)
from p2p_tpu_torch.ops.norm import BatchNorm, dual_moments  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-4)
BN_TOL = dict(rtol=1e-4, atol=1e-5)
# y = x·a + b on the large-mean channel adds two terms of about ±2·10³
# (x ≈ 40, a = γ/σ ≈ 50) that cancel: f32 keeps them to 2.4e-4
AFFINE_TOL = dict(rtol=1e-4, atol=5e-4)
M_ODD = 3 * 97          # Pallas block 97; not a multiple of the port's chunks
# the reference preset's (M, C) at 256², batch 1, ngf 32
PATH_SHAPES = [(65536, 32), (16384, 64), (4096, 128), (65536, 3),
               (65536, 64)]
# the facades U-Net's at 256², batch 1, ngf 64 (and facades_int8's)
FACADES_SHAPES = [(16384, 64), (4096, 128), (1024, 256), (256, 512),
                  (64, 512), (16, 512), (4, 512)]


def _x(m, c, seed, dtype=np.float32):
    """(M, C) rows with a per-channel mean and spread; channel 0 has a
    large mean and a small spread."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-2, 2, c)
    spread = rng.uniform(0.1, 3, c)
    mean[0], spread[0] = 40.0, 0.01
    return (rng.normal(size=(m, c)) * spread + mean).astype(dtype)


@pytest.fixture(autouse=True)
def _xla_path():
    assert os.environ.get("P2P_PALLAS_BN", "0") != "1"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 8, 128])
def test_plain_version_matches_pallas_kernel_and_jax_dual_moments(c, dtype):
    x = _x(M_ODD, c, seed=c)
    xj = jnp.asarray(x, dtype)
    k1, k2 = pallas_dual_moments(xj, block_m=97, interpret=True)
    r1, r2 = jax_dual_moments(xj)
    # the port sees the same values the JAX functions see
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    s1, s2 = batch_moments(xt)
    assert s1.dtype == s2.dtype == torch.float32
    for got, *wants in ((s1, k1, r1), (s2, k2, r2)):
        for want in wants:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **SUM_TOL)


def test_backward_is_the_jax_closed_form():
    x = _x(M_ODD, 8, seed=1)
    rng = np.random.default_rng(2)
    ds, dss = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(jax_dual_moments, jnp.asarray(x))
    (want,) = vjp((jnp.asarray(ds), jnp.asarray(dss)))
    xt = torch.from_numpy(x).requires_grad_(True)
    s1, s2 = dual_moments(xt)
    (got,) = torch.autograd.grad(
        (s1 * torch.from_numpy(ds)).sum() + (s2 * torch.from_numpy(dss)).sum(),
        xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BN_TOL)


def _flax_bn(x_nhwc, variables, train):
    bn = JaxBatchNorm(use_running_average=not train)
    if train:
        y, upd = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
        return y, {**variables, "batch_stats": upd["batch_stats"]}
    return bn.apply(variables, x_nhwc), variables


def _bn_state(*trees):
    """A lone flax BatchNorm's trees hold its inner ``BatchNorm_0``."""
    return state_from_flax(*(t["BatchNorm_0"] for t in trees))


def _nchw(a):
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy()
                            ).contiguous(memory_format=torch.channels_last)


def _bn_variables(x, c, seed):
    """flax BatchNorm variables with a running mean away from 0 and γ away
    from 1, so the shift and the affine are exercised. Channel 0 (mean 40,
    spread 0.01) is warmed up: its shift is near its mean, which is what
    makes its one-pass variance well conditioned in f32 (unshifted,
    Σx²/n − mean² cancels to the rounding of 1600, in both packages and in
    different orders)."""
    v = jax.tree_util.tree_map(np.asarray, JaxBatchNorm().init(
        jax.random.key(seed), jnp.asarray(x)))
    running = np.linspace(-1, 1, c).astype(np.float32)
    running[0] = 39.9
    v["batch_stats"]["BatchNorm_0"]["mean"] = running
    v["params"]["BatchNorm_0"]["scale"] = np.linspace(
        0.5, 1.5, c).astype(np.float32)
    return v


def test_batchnorm_matches_flax_in_train_and_eval_with_both_updates():
    c = 8
    xs = [_x(2 * 6 * 5, c, seed=s).reshape(2, 6, 5, c) for s in (3, 4, 5)]
    variables = _bn_variables(xs[0], c, 0)
    bn = BatchNorm(c)
    bn.load_state_dict(_bn_state(variables["params"],
                                 variables["batch_stats"]))
    # two train-mode forwards (a G step and its net_c branch), then eval
    for x, train in ((xs[0], True), (xs[1], True), (xs[2], False)):
        want, variables = _flax_bn(jnp.asarray(x), variables, train)
        bn.train(train)
        got = bn(_nchw(x))
        np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want), **AFFINE_TOL)
        stats = _bn_state(jax.tree_util.tree_map(
            np.asarray, variables["batch_stats"]))
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       stats[k].numpy(), **BN_TOL)


def test_batchnorm_gradients_match_flax():
    c = 3
    x = _x(2 * 4 * 4, c, seed=6).reshape(2, 4, 4, c)
    # spread 1 on the large-mean channel: BatchNorm's input gradient
    # scales with 1/σ³ through the variance, so at σ = 0.01 both packages'
    # last-bit differences in Σg·x grow to percent level
    x[..., 0] = 40.0 + (x[..., 0] - 40.0) * 100.0
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    variables = _bn_variables(x, c, 1)

    def f(params, xx):
        y, _ = JaxBatchNorm().apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xx,
            mutable=["batch_stats"])
        return jnp.sum(y * g)

    dp, dx = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    bn = BatchNorm(c)
    bn.load_state_dict(_bn_state(variables["params"],
                                 variables["batch_stats"]))
    xt = _nchw(x).requires_grad_(True)
    (bn(xt) * _nchw(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(dx), **BN_TOL)
    want = _bn_state(jax.tree_util.tree_map(np.asarray, dp))
    np.testing.assert_allclose(bn.scale.grad.numpy(), want["scale"].numpy(),
                               **BN_TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), want["bias"].numpy(),
                               **BN_TOL)


def test_cpu_tensor_takes_the_plain_version_and_meta_raises():
    x = torch.from_numpy(_x(10, 3, seed=8))
    n = batch_moments.launches
    for a, b in zip(batch_moments(x), batch_moments_plain(x)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert batch_moments.launches == n
    with pytest.raises(ValueError, match="CUDA tensor"):
        batch_moments(torch.empty((4, 3), device="meta"))


@pytest.mark.parametrize("m,c", PATH_SHAPES)
@pytest.mark.parametrize("vec_bytes", [2, 4])
def test_launch_geometry_covers_every_row_and_channel(m, c, vec_bytes):
    """The kernel's launch plan at the path's shapes (built on the CPU, as
    the wrapper builds it): chunks tile M exactly once, threads along C
    cover every channel, and there is more than one block."""
    vec = 16 // vec_bytes if c % (16 // vec_bytes) == 0 else 1
    g = stats_geometry(1, m, c, vec)
    assert g.num_p * g.chunk >= m > (g.num_p - 1) * g.chunk
    assert g.cblocks * g.tx * g.vec >= c and g.tx * g.ty <= 256
    assert g.num_p * g.cblocks >= 64


def _coverage(g, m, c):
    """How often pass 1 of plan ``g`` reads each row and each channel,
    following the kernel's index arithmetic: block (cb, p), thread (i, j)
    reads rows p·chunk + j + k·ty below min((p + 1)·chunk, M) and channels
    (cb·tx + i)·vec … + vec − 1 below C."""
    rows = np.zeros(m, np.int64)
    for p in range(g.num_p):
        lo, hi = p * g.chunk, min((p + 1) * g.chunk, m)
        for j in range(g.ty):
            rows[lo + j:hi:g.ty] += 1
    chans = np.zeros(c, np.int64)
    for cb in range(g.cblocks):
        for i in range(g.tx):
            c0 = (cb * g.tx + i) * g.vec
            chans[c0:min(c0 + g.vec, c)] += 1
    return rows, chans


@pytest.mark.parametrize("m,c", sorted(set(PATH_SHAPES + FACADES_SHAPES)))
@pytest.mark.parametrize("elt", [2, 4])
def test_launch_plan_reads_every_row_and_channel_once(m, c, elt):
    """The plan of both launches at every BatchNorm shape of the train
    steps, in bf16 and f32: pass 1 reads each row and each channel exactly
    once, its grid is within CUDA's limits, and the (P, C) f32 partials
    stay under a quarter of the input's bytes (two loads a thread at
    least); none, and no second launch, where one chunk covers M, which is
    so at the U-Net's two innermost levels."""
    vec = 16 // elt if c % (16 // elt) == 0 else 1
    g = stats_geometry(1, m, c, vec)
    rows, chans = _coverage(g, m, c)
    assert (rows == 1).all() and (chans == 1).all()
    assert g.cblocks <= 2 ** 31 - 1 and g.num_p <= 65535
    if g.num_p > 1:
        assert 2 * 4 * g.num_p * c <= m * c * elt / 4
    assert (g.num_p == 1) == (m <= 16)
