"""The port's ``reference`` train step against the JAX step on the CPU.

One JAX ``create_train_state`` of the ``reference`` preset, shrunk to 32²
with ngf 8, ndf 8, 2 residual blocks, VGG on and f32, is carried into the
port by ``convert.load_train_state``; both packages then take 3 steps on
the same synthetic batches (numpy, from seeds), with the JAX fixed-seed
VGG19 draw converted for the port. JAX runs with ``P2P_PALLAS_BN`` unset.

Tolerances: step 1 is one forward and backward from equal weights, so its
losses agree to f32 rounding of sums taken in another order (rtol 1e-5).
From step 2 on, Adam's first steps move every weight by about ±lr (its
update is m/√v ≈ sign(g)), so a last-bit difference in a near-zero gradient
becomes a difference of up to 2·lr = 4e-4 in that weight per step: the
losses of steps 2-3 agree within rtol 2e-2, the running statistics within
atol 3e-3, the spectral u (a unit vector) within atol 1e-4. One bf16
step of both packages (the card's mixed precision) agrees within rtol 2e-2.
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.vgg import load_vgg19_params  # noqa: E402
from p2p_tpu.train.state import create_train_state as jax_create  # noqa: E402
from p2p_tpu.train.step import build_train_step as jax_build  # noqa: E402
from p2p_tpu_torch.convert import load_train_state, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from p2p_tpu_torch.models.vgg import VGG19Features  # noqa: E402
from p2p_tpu_torch.ops import norm  # noqa: E402
from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments  # noqa: E402
from p2p_tpu_torch.train.state import (  # noqa: E402
    create_train_state, load_vgg19)
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402

N_STEPS = 3
KEYS = ("loss_g", "loss_d", "loss_c", "g_gan", "g_feat", "g_vgg", "g_tv")
FIELDS = ("params_g", "batch_stats_g", "params_d", "spectral_d",
          "params_c", "batch_stats_c")
STEP1_RTOL = 1e-5
LATER_RTOL = 2e-2
STATS_ATOL = 3e-3
U_ATOL = 1e-4
# bf16 keeps 8 significant bits: an element rounded at another point of an
# op differs by up to 2^-8 = 3.9e-3 relative; the losses' means shrink that
# and the TV term's neighbour differences amplify it
BF16_RTOL = 2e-2


def _small(cfg):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=2),
        data=dataclasses.replace(cfg.data, image_size=32),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(n_steps, jax_dtype=None, torch_dtype=None):
    """n_steps of both packages from one converted JAX state; returns the
    per-step metrics of each and both final states."""
    jcfg, tcfg = _small(jax_preset("reference")), _small(
        get_preset("reference"))
    batches = [synthetic_batch(1, 32, seed=i) for i in range(n_steps)]
    sample = {k: jnp.asarray(v) for k, v in batches[0].items()}
    js = jax.jit(lambda k: jax_create(jcfg, k, sample, 1, jax_dtype))(
        jax.random.key(0))
    start = {f: _np(getattr(js, f)) for f in FIELDS}
    vgg_params = _np(jax.jit(lambda: load_vgg19_params(seed=190))())

    jstep = jax_build(jcfg, vgg_params, 1, jax_dtype, jit=True)
    jax_metrics = []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append({k: float(m[k]) for k in KEYS})

    ts = load_train_state(create_train_state(
        tcfg, device="cpu", train_dtype=torch_dtype), start)
    vgg = VGG19Features()
    vgg.load_state_dict(state_from_flax(vgg_params), strict=True)
    tstep = build_train_step(tcfg, vgg.eval(), torch_dtype)
    port_metrics = []
    for b in batches:
        ts, m = tstep(ts, b)
        port_metrics.append({k: float(m[k]) for k in KEYS})
    return dict(jax=jax_metrics, port=port_metrics, js=js, ts=ts)


@pytest.fixture(scope="module")
def runs():
    assert os.environ.get("P2P_PALLAS_BN", "0") != "1"
    return _both(N_STEPS)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_per_loss_metrics_track_the_jax_step(runs, i):
    rtol = STEP1_RTOL if i == 0 else LATER_RTOL
    for k in KEYS:
        want, got = runs["jax"][i][k], runs["port"][i][k]
        assert np.isfinite(got), k
        assert got == pytest.approx(want, rel=rtol), (i, k, want, got)


@pytest.mark.parametrize("net,field,atol", [
    ("net_g", "batch_stats_g", STATS_ATOL),
    ("net_c", "batch_stats_c", STATS_ATOL),
    ("net_d", "spectral_d", U_ATOL)])
def test_running_stats_and_spectral_u_track_the_jax_step(runs, net, field,
                                                         atol):
    want = state_from_flax(_np(getattr(runs["js"], field)))
    got = dict(getattr(runs["ts"], net).named_buffers())
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   rtol=0, err_msg=k)


def test_bf16_step_matches_the_jax_bf16_step():
    """The mixed-precision program (bf16 compute on f32 masters, VGG in
    f32): both packages round activations to bf16 at the same ops, so one
    step's losses agree to bf16 rounding at different points inside an op
    (the conv bias, the folded affine's product): within BF16_RTOL."""
    got = _both(1, jnp.bfloat16, torch.bfloat16)
    for k in KEYS:
        want, port = got["jax"][0][k], got["port"][0][k]
        assert port == pytest.approx(want, rel=BF16_RTOL), (k, want, port)


def test_optimizers_stepped_once_per_step(runs):
    ts = runs["ts"]
    assert ts.step == N_STEPS
    for opt in (ts.opt_g, ts.opt_d, ts.opt_c):
        assert opt[1].last_epoch == N_STEPS


def test_every_training_batchnorm_goes_through_the_kernel_wrapper():
    """G runs twice per step (the G step and the net_c branch) with
    3 + 2·n_blocks + 3 BatchNorms, net_c twice with one: 50 at the full
    preset, 22 here. On the CPU the wrapper takes the plain version and
    counts no launch."""
    cfg = _small(get_preset("reference"))
    ts = create_train_state(cfg, device="cpu")
    step = build_train_step(cfg, load_vgg19(device="cpu"))
    launches = batch_moments.launches
    with mock.patch.object(norm, "batch_moments",
                           wraps=norm.batch_moments) as spy:
        step(ts, synthetic_batch(1, 32, seed=0))
    assert spy.call_count == 2 * (6 + 2 * cfg.model.n_blocks) + 2 == 22
    assert batch_moments.launches == launches


@pytest.mark.parametrize("sn", [True, False])
def test_nonfinite_batch_is_skipped_and_leaves_state_unchanged(sn):
    cfg = _small(get_preset("reference"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                use_spectral_norm=sn))
    ts = create_train_state(cfg, seed=1, device="cpu")
    before = {k: v.clone() for net in (ts.net_g, ts.net_d, ts.net_c)
              for k, v in net.state_dict().items()}
    step = build_train_step(cfg, load_vgg19(device="cpu"))
    bad = synthetic_batch(1, 32, seed=0)
    bad["target"][0, 0, 0, 0] = np.nan
    ts, m = step(ts, bad)
    assert float(m["health_ok"]) == 0.0 and ts.step == 1
    after = {k: v for net in (ts.net_g, ts.net_d, ts.net_c)
             for k, v in net.state_dict().items()}
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert ts.opt_g[1].last_epoch == ts.opt_c[1].last_epoch == 0


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    cfg = _small(get_preset("reference"))
    if torch.cuda.is_available():
        assert create_train_state(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_vgg19()


def test_without_guard_or_net_c_training():
    """health.enabled off: no host verdict, no ``health_ok``;
    train_compression_net off (the reference's bug): net_c never steps."""
    cfg = _small(get_preset("reference"))
    cfg = cfg.replace(
        health=dataclasses.replace(cfg.health, enabled=False),
        optim=dataclasses.replace(cfg.optim, train_compression_net=False))
    ts = create_train_state(cfg, device="cpu")
    c0 = {k: v.clone() for k, v in ts.net_c.named_parameters()}
    step = build_train_step(cfg, load_vgg19(device="cpu"))
    ts, m = step(ts, synthetic_batch(1, 32, seed=0))
    assert "health_ok" not in m and set(KEYS) <= set(m)
    for k, v in ts.net_c.named_parameters():
        assert torch.equal(v, c0[k]), k
    assert ts.opt_g[1].last_epoch == 1 and ts.opt_c[1].last_epoch == 0


def test_step_refuses_what_is_not_ported():
    cfg = _small(get_preset("reference"))
    with pytest.raises(ValueError, match="split_d_pairs is incompatible"):
        build_train_step(cfg.replace(
            model=dataclasses.replace(cfg.model, split_d_pairs=True),
            train=dataclasses.replace(cfg.train, pool_size=4)))
    with pytest.raises(ValueError, match="norm_d"):
        create_train_state(cfg.replace(model=dataclasses.replace(
            cfg.model, norm_d="batch")), device="cpu")
