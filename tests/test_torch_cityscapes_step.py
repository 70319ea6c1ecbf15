"""The port's ``cityscapes_spatial`` train step (the 9-block
ResnetGenerator with plain instance norms, the 3-scale spectral-norm D,
LSGAN + 10·FM + 10·VGG19 + 1·TV) with the trainer options of this slice
on — the historical-fake pool, the EMA generator and global-norm gradient
clipping — against the JAX step on the CPU.

One JAX state of the preset shrunk to ngf 8, ndf 8, one residual block,
at 32×64 and batch 2 (the preset: 256×512, batch 4), f32, with
``pool_size=3`` (the second step crosses the fill boundary: one pair is
stored, one is queried against the full pool), ``ema_decay=0.999`` and
``grad_clip=1.0`` (active: the step-1 gradients of G and D have larger
global norms), is carried into the port (EMA and pool too); both take 2
steps on the same batches, the port's pool queries fed the JAX step's
draws (``torch_step_parity.jax_pool_draws_fed``).

Tolerances: every loss within 1e-4 relative at step 1 (measured 8e-7)
and 2e-4 at step 2 (measured 6.9e-5: Adam's sign-like first update moves
a weight whose gradient is near 0 by ±lr on either side); D's step-1
(clipped) gradient within 1e-5 abs + 1e-4 of each tensor's largest
|gradient| (measured 1.3e-6); G's within 1e-5 + 5e-3 of its largest: the
cotangent that reaches G through D, VGG, FM and TV is ill-conditioned at
this state, so that G's f32 gradient moves by 1.2e-3 of a tensor's largest
(the port's) and 2.1e-3 (JAX's) from the port's run with f64 weights and
norms, with or without the options (G alone, on a random cotangent,
agrees within 2e-6); 5e-3 is 2.5× the larger, rounded up. The pool after
2 steps: the real_a halves of its pairs bitwise, the fake halves within
5e-3 (a pair of step 2 is G's output after one update: measured 1.7e-3;
of step 1, 1.2e-5); the EMA after 2 steps within 2e-6 absolute ((1 − d)
times the ±2·lr the parameters may differ by at each step, 1.2e-6;
measured 8e-7); the non-finite counts exactly 0 on both.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu_torch.convert import state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_hd_batch  # noqa: E402
from torch_step_parity import (  # noqa: E402
    assert_grads_close, assert_losses_close, jax_start, np_tree, run_both)

H, W, N = 32, 64, 2
N_STEPS = 2
KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg", "g_tv",
        "nonfinite_g", "nonfinite_d")
STEP1_RTOL, LATER_RTOL = 1e-4, 2e-4
GRAD_ATOL = 1e-5
GRAD_RTOL = {"g": 5e-3, "d": 1e-4}
FAKE_ATOL = 5e-3
EMA_ATOL = 2e-6


def _small(cfg):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1),
        data=dataclasses.replace(cfg.data, image_size=H, image_width=W,
                                 batch_size=N),
        optim=dataclasses.replace(cfg.optim, grad_clip=1.0),
        train=dataclasses.replace(cfg.train, mixed_precision=False,
                                  pool_size=3),
        health=dataclasses.replace(cfg.health, ema_decay=0.999))


def _batches(n):
    return [synthetic_hd_batch(N, H, W, seed=i) for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = (_small(jax_preset("cityscapes_spatial")),
                  _small(get_preset("cityscapes_spatial")))
    start = jax_start(jcfg, _batches(1)[0])
    out = run_both(jcfg, tcfg, _batches(N_STEPS), KEYS, start,
                   keep_states=True)
    return out


@pytest.mark.parametrize("i", range(N_STEPS))
def test_losses_and_counts_track_the_jax_step(runs, i):
    assert_losses_close({k: runs[k][i:i + 1] for k in ("jax", "port")},
                        KEYS[:-2], STEP1_RTOL if i == 0 else LATER_RTOL)
    jm, pm = runs["jax"][i], runs["port"][i]
    assert jm["nonfinite_g"] == pm["nonfinite_g"] == 0.0
    assert jm["nonfinite_d"] == pm["nonfinite_d"] == 0.0


@pytest.mark.parametrize("net", ["g", "d"])
def test_step1_clipped_gradients_match_the_jax_step(runs, net):
    got, want = runs["grads"][net]
    for grads in (got, want):       # the clip acted: norm 1 = grad_clip
        norm = float(torch.sqrt(sum(g.double().square().sum()
                                    for g in grads.values())))
        assert norm == pytest.approx(1.0, rel=1e-5)
    assert_grads_close(got, want, GRAD_ATOL, GRAD_RTOL[net])


def test_pool_and_ema_after_two_steps_match_the_jax_state(runs):
    js, ts = runs["states"]
    assert int(ts.pool_n) == int(np.asarray(js.pool_n)) == 3
    pool, jpool = ts.pool.numpy(), np.asarray(js.pool)
    np.testing.assert_array_equal(pool[..., :3], jpool[..., :3])
    np.testing.assert_allclose(pool[..., 3:], jpool[..., 3:],
                               atol=FAKE_ATOL, rtol=0)
    want = state_from_flax(np_tree(js.ema_g), module=ts.net_g)
    assert set(want) == set(ts.ema_g)
    for k, w in want.items():
        np.testing.assert_allclose(ts.ema_g[k].numpy(), w.numpy(),
                                   atol=EMA_ATOL, rtol=0, err_msg=k)
