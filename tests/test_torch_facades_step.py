"""The port's ``facades`` train step (U-Net G with the subpixel head on
kernels #6/#7, one PatchGAN without spectral norm, no net_c, LSGAN +
100·L1) against the JAX step on the CPU.

One JAX ``create_train_state`` of ``facades`` shrunk to ngf 32, ndf 16 at
64² with ``thin_head`` and ``head_pallas`` (the JAX head kernel runs in
interpret mode, the port's through the plain versions) is carried into
the port by ``convert.load_train_state``; both packages then take 3 f32
steps on the same synthetic facades batches. Dropout is off for the
parity runs: the two packages' random streams differ.

Tolerances: step 1 is one forward and backward from equal weights, so its
losses agree to f32 rounding of sums taken in another order (rtol 1e-4);
the later steps within rtol 1e-3 (measured: 8.5e-7 at step 3). Adam's
first steps move each weight by about ±lr = 2e-4 whatever its gradient's
size, so a weight whose gradient is near zero and changes sign between the
packages ends up to 2·lr per step apart: after 3 steps each of G's
parameters agrees within 3·2·lr = 1.2e-3 absolute, and each tensor's
update (parameter − start) within 0.2 of its L2 norm (measured: 0.126 at
the 1×1 innermost level, whose gradients are the smallest; the image head,
through #6/#7, within 1e-3, measured 1.5e-5). The running statistics agree
within 1e-3 absolute and 1e-3 of each tensor's update (measured 1.5e-4 and
2.1e-4). One bf16 step of both (bf16 compute on f32 masters) agrees within
rtol 1e-2 (measured 6.9e-5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.train.state import create_train_state as jax_create  # noqa: E402
from p2p_tpu.train.step import build_train_step as jax_build  # noqa: E402
from p2p_tpu_torch.convert import load_train_state, state_from_flax  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_facades_batch  # noqa: E402
from p2p_tpu_torch.losses.l1 import l1_loss  # noqa: E402
from p2p_tpu_torch.ops import norm  # noqa: E402
from p2p_tpu_torch.ops.cuda import subpixel_head  # noqa: E402
from p2p_tpu_torch.train.state import create_train_state  # noqa: E402
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402

SIZE = 64
N_STEPS = 3
KEYS = ("loss_d", "loss_g", "g_gan", "g_l1", "loss_c")
FIELDS = ("params_g", "batch_stats_g", "params_d", "spectral_d",
          "params_c", "batch_stats_c")
STEP1_RTOL = 1e-4
LATER_RTOL = 1e-3
# field: (elementwise atol, per-tensor relative update band)
G_BANDS = {"params_g": (1.2e-3, 0.2), "batch_stats_g": (1e-3, 1e-3)}
HEAD_UPDATE_RTOL = 1e-3
BF16_RTOL = 1e-2


def _small(cfg, dropout=False):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=32, ndf=16, thin_head=True,
                                  head_pallas=True, use_dropout=dropout),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a), tree)


def _batches(n):
    return [synthetic_facades_batch(1, SIZE, seed=i) for i in range(n)]


def _jax_state(jcfg, dtype=None):
    sample = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}
    return jax.jit(lambda k: jax_create(jcfg, k, sample, 1, dtype))(
        jax.random.key(0))


def _both(n_steps, jax_dtype=None, torch_dtype=None):
    jcfg = _small(jax_preset("facades"))
    tcfg = _small(get_preset("facades"))
    batches = _batches(n_steps)
    js = _jax_state(jcfg, jax_dtype)
    start = {f: _np(getattr(js, f)) for f in FIELDS}
    jstep = jax_build(jcfg, None, 1, jax_dtype, jit=True)
    jax_metrics = []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append({k: float(m[k]) for k in KEYS})
    ts = load_train_state(create_train_state(
        tcfg, device="cpu", train_dtype=torch_dtype), start)
    tstep = build_train_step(tcfg, None, torch_dtype)
    port_metrics = []
    for b in batches:
        ts, m = tstep(ts, b)
        port_metrics.append({k: float(m[k]) for k in KEYS})
    return dict(jax=jax_metrics, port=port_metrics, js=js, ts=ts,
                start=start)


@pytest.fixture(scope="module")
def runs():
    return _both(N_STEPS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_term_is_the_jax_expression(dtype):
    """The difference in the train dtype, the mean in f32: the same
    rounded differences in both packages, summed in another order."""
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
            for _ in range(2))
    jd = getattr(jnp, dtype)
    want = float(jnp.mean(jnp.abs(jnp.asarray(a, jd) - jnp.asarray(b, jd)),
                          dtype=jnp.float32))
    td = getattr(torch, dtype)
    got = l1_loss(torch.from_numpy(a).to(td), torch.from_numpy(b).to(td))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_converted_state_is_the_jax_state():
    jcfg, tcfg = _small(jax_preset("facades")), _small(get_preset("facades"))
    js = _jax_state(jcfg)
    assert js.params_c is None and js.opt_c is None
    ts = load_train_state(create_train_state(tcfg, device="cpu"),
                          {f: _np(getattr(js, f)) for f in FIELDS})
    assert ts.net_c is None and ts.opt_c is None
    for net, fields in ((ts.net_g, ("params_g", "batch_stats_g")),
                        (ts.net_d, ("params_d", "spectral_d"))):
        want = state_from_flax(*(_np(getattr(js, f)) for f in fields),
                               module=net)
        got = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    assert ts.net_g.up0.conv.kernel.shape == (2, 2, 64, 12)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_per_loss_metrics_track_the_jax_step(runs, i):
    rtol = STEP1_RTOL if i == 0 else LATER_RTOL
    assert runs["port"][i]["loss_c"] == 0.0 == runs["jax"][i]["loss_c"]
    for k in KEYS[:4]:
        want, got = runs["jax"][i][k], runs["port"][i][k]
        assert np.isfinite(got), k
        assert got == pytest.approx(want, rel=rtol), (i, k, want, got)


@pytest.mark.parametrize("field", sorted(G_BANDS))
def test_generator_tracks_the_jax_step(runs, field):
    atol, update_rtol = G_BANDS[field]
    ts = runs["ts"]
    want = state_from_flax(_np(getattr(runs["js"], field)), module=ts.net_g)
    start = state_from_flax(runs["start"][field], module=ts.net_g)
    got = ts.net_g.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   rtol=0, err_msg=k)
        band = HEAD_UPDATE_RTOL if k.startswith("up0.") else update_rtol
        update = float((v - start[k]).norm())
        assert update > 0, k
        assert float((got[k] - v).norm()) <= band * update, k


def test_bf16_step_matches_the_jax_bf16_step():
    got = _both(1, jnp.bfloat16, torch.bfloat16)
    for k in KEYS[:4]:
        want, port = got["jax"][0][k], got["port"][0][k]
        assert port == pytest.approx(want, rel=BF16_RTOL), (k, want, port)


def test_dropout_steps_are_finite_and_reproducible():
    cfg = _small(get_preset("facades"), dropout=True)
    batches = _batches(2)

    def run(seed):
        ts = create_train_state(cfg, seed=0, device="cpu")
        step = build_train_step(cfg.replace(train=dataclasses.replace(
            cfg.train, seed=seed)))
        out = []
        for b in batches:
            ts, m = step(ts, b)
            out.append({k: float(m[k]) for k in KEYS})
        return out

    a, b, c = run(123), run(123), run(124)
    assert all(np.isfinite(v) for m in a for v in m.values())
    assert a == b and a != c


def test_each_step_runs_every_batchnorm_and_one_head_forward_and_dx():
    """At the full depth (8 levels, 256²) a step runs 13 training-mode
    BatchNorms, one #6 and one #7; here the depth is 6 (9 BatchNorms).
    On the CPU every wrapper takes its plain version and counts no
    launch."""
    from unittest import mock

    cfg = _small(get_preset("facades"), dropout=True)
    ts = create_train_state(cfg, device="cpu")
    step = build_train_step(cfg)
    before = (subpixel_head.subpixel_head_fwd.launches,
              subpixel_head.subpixel_head_dx.launches)
    with mock.patch.object(norm, "batch_moments",
                           wraps=norm.batch_moments) as bm, \
            mock.patch.object(subpixel_head, "subpixel_head_fwd",
                              wraps=subpixel_head.subpixel_head_fwd) as fwd, \
            mock.patch.object(subpixel_head, "subpixel_head_dx",
                              wraps=subpixel_head.subpixel_head_dx) as dx:
        step(ts, _batches(1)[0])
    assert (bm.call_count, fwd.call_count, dx.call_count) == (9, 1, 1)
    assert (subpixel_head.subpixel_head_fwd.launches,
            subpixel_head.subpixel_head_dx.launches) == before


def test_nonfinite_batch_is_skipped_and_leaves_state_unchanged():
    cfg = _small(get_preset("facades"), dropout=True)
    ts = create_train_state(cfg, seed=1, device="cpu")
    before = {k: v.clone() for net in (ts.net_g, ts.net_d)
              for k, v in net.state_dict().items()}
    bad = _batches(1)[0]
    bad = {k: v.astype(np.float32) / 127.5 - 1 for k, v in bad.items()}
    bad["target"][0, 0, 0, 0] = np.nan
    ts, m = build_train_step(cfg)(ts, bad)
    assert float(m["health_ok"]) == 0.0 and ts.step == 1
    after = {k: v for net in (ts.net_g, ts.net_d)
             for k, v in net.state_dict().items()}
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert ts.opt_g[1].last_epoch == ts.opt_d[1].last_epoch == 0
