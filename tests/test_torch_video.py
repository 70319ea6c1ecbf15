"""The video slice against the JAX package (``p2p_tpu/models/temporal_d.py``,
``p2p_tpu/data/video.py``, ``p2p_tpu/train/video_step.py``,
``p2p_tpu/train/video_loop.py:57 build_video_eval_step``), on the CPU in
f32 at the tiny shapes of ``tests/test_video.py`` (``_tiny_cfg``: U-Net
ngf 8 at 16², ndf 8, 2 D scales of n_layers 2, so 1 temporal scale in the
step) with 4 frames at batch 2. The temporal D alone runs with
``num_D=2`` so that its spatial pooling runs. One JAX train-step compile
for the file.

Bands: about 10x the maximum measured with this file's inputs (CPU, torch
on one thread), rounded up to 1, 2 or 5 x 10^-n; each constant below
names its maximum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.data.pipeline import make_loader as jax_make_loader
from p2p_tpu.data.video import VideoClipDataset as JaxClips
from p2p_tpu.data.video import make_synthetic_video_dataset as jax_synth
from p2p_tpu.models.temporal_d import (
    MultiscaleTemporalDiscriminator as JaxTemporalD)
from p2p_tpu.train.video_loop import build_video_eval_step as jax_eval_build
from p2p_tpu.train.video_step import (build_video_models as jax_models,
                                      build_video_train_step as jax_build,
                                      create_video_train_state as jax_create)
from p2p_tpu_torch.convert import (load_flax, load_video_train_state,
                                   state_from_flax)
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.pipeline import make_loader
from p2p_tpu_torch.data.video import (VideoClipDataset,
                                      make_synthetic_video_dataset)
from p2p_tpu_torch.models.temporal_d import (MultiscaleTemporalDiscriminator,
                                             fold_frames, split_time_stem,
                                             unfold_frames)
from p2p_tpu_torch.train import video_step
from p2p_tpu_torch.train.step import single_forward_d_losses
from p2p_tpu_torch.train.video_loop import build_video_eval_step
from p2p_tpu_torch.train.video_step import (build_video_models,
                                            build_video_train_step,
                                            create_video_train_state,
                                            to_device_clip)
from torch_step_parity import (INIT_COMPILE, adam_mu, assert_grads_close,
                               np_tree, port_grads)

BATCH, FRAMES, SIZE = 2, 4, 16
LOSS_KEYS = ("loss_d", "loss_dt", "loss_g", "g_gan", "g_gan_t", "g_feat")
# the temporal D: features 1.32e-6 and input gradient 6.88e-7 of their
# largest |value|, the updated u 1.79e-7 (absolute)
D_FEAT_RTOL_OF_MAX, D_DX_RTOL_OF_MAX, U_ATOL = 2e-5, 1e-5, 2e-6
# the split stem against one F.conv3d: output 1.85e-7, weight gradient
# 2.63e-7 of their largest
STEM_RTOL_OF_MAX = 5e-6
# the step: losses 2.72e-7 relative; step-1 gradients of G 1.34e-6, D
# 8.45e-7, DT 1.21e-6 of each tensor's largest; u of D 5.96e-8, of DT
# 1.19e-7 (U_ATOL)
LOSS_RTOL = 5e-6
GRAD_RTOL_OF_MAX = {"g": 2e-5, "d": 1e-5, "dt": 2e-5}
# the eval step: per-frame PSNR 1.91e-6 dB, SSIM 1.12e-8
PSNR_ATOL, SSIM_ATOL = 2e-5, 2e-7


def _tiny(cfg):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, num_D=2,
                                  n_layers_D=2),
        data=dataclasses.replace(cfg.data, batch_size=BATCH, image_size=SIZE,
                                 n_frames=FRAMES),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(
        np.float32) for k in ("input", "target")}


def _clip(x):
    """An NTHWC numpy clip as the port's channels_last_3d NCDHW tensor."""
    return torch.from_numpy(np.array(x)).permute(0, 4, 1, 2, 3)


def _rel_of_max(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def _no_grain():
    """The JAX loader on its in-process fallback, the one the port
    mirrors (Grain is installed here)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P2P_TPU_NO_GRAIN", "1")
        yield


def test_temporal_d_forward_input_gradient_and_u():
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (BATCH, FRAMES, SIZE, SIZE, 6)).astype(np.float32)
    jd = JaxTemporalD(ndf=8, n_layers=2, num_D=2)
    variables = jax.jit(jd.init)(jax.random.key(3), jnp.asarray(x))

    def loss(xx):
        out, mut = jd.apply(variables, xx, mutable=["spectral"])
        total = sum(jnp.mean(f * f) for scale in out for f in scale)
        return total, (out, mut["spectral"])

    (_, (jfeats, jspec)), jdx = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jnp.asarray(x))

    d = MultiscaleTemporalDiscriminator(6, 8, 2, 2)
    load_flax(d, np_tree(variables["params"]), np_tree(variables["spectral"]))
    d.to(memory_format=torch.channels_last_3d).train()
    xt = _clip(x).requires_grad_(True)
    feats = d(xt)
    sum(torch.mean(f * f) for scale in feats for f in scale).backward()

    assert [len(s) for s in feats] == [len(s) for s in jfeats] == [4, 4]
    for scale, jscale in zip(feats, jfeats):
        for f, jf in zip(scale, jscale):
            got = f.detach().permute(0, 2, 3, 4, 1).numpy()
            assert got.shape == jf.shape
            assert _rel_of_max(got, jf) <= D_FEAT_RTOL_OF_MAX
    dx = xt.grad.permute(0, 2, 3, 4, 1).numpy()
    assert _rel_of_max(dx, jdx) <= D_DX_RTOL_OF_MAX
    want_u = state_from_flax(np_tree(jspec))
    got_u = {k: v for k, v in d.state_dict().items() if k.endswith(".u")}
    assert set(got_u) == set(want_u) and len(got_u) == 4
    for k, u in got_u.items():
        assert float((u - want_u[k]).abs().max()) <= U_ATOL, k


@pytest.mark.parametrize("stride", [1, 2])
def test_split_stem_is_one_conv3d_and_the_fold_a_view(stride):
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(BATCH, 6, FRAMES, SIZE, SIZE, generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    w = (0.1 * torch.randn(8, 6, 3, 4, 4, generator=gen)).requires_grad_(True)
    b = torch.randn(8, generator=gen)
    y = split_time_stem(x, w, b, stride)
    gw, = torch.autograd.grad((y * y).sum(), w)
    w2 = w.detach().clone().requires_grad_(True)
    ref = F.conv3d(x, w2, b, (1, stride, stride), (1, 2, 2))
    gw_ref, = torch.autograd.grad((ref * ref).sum(), w2)
    assert y.shape == ref.shape
    assert _rel_of_max(y.detach(), ref.detach()) <= STEM_RTOL_OF_MAX
    assert _rel_of_max(gw, gw_ref) <= STEM_RTOL_OF_MAX
    # the clip's frames and the frames' clip are views of one buffer
    frames = fold_frames(x)
    assert frames.data_ptr() == x.data_ptr()
    assert frames.is_contiguous(memory_format=torch.channels_last)
    back = unfold_frames(frames, BATCH)
    assert back.data_ptr() == x.data_ptr() and torch.equal(back, x)


@pytest.fixture(scope="module")
def runs():
    """One JAX f32 video step from a JAX state and one port step from
    that state converted; the eval step of each on the starting G."""
    jcfg = _tiny(jax_preset("vid2vid_temporal"))
    tcfg = _tiny(get_preset("vid2vid_temporal"))
    batch, test = _batch(0), _batch(1)
    sample = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(0)
    js = jax.jit(lambda k: jax_create(jcfg, k, sample)).lower(key).compile(
        compiler_options=INIT_COMPILE)(key)
    fields = {f: np_tree(getattr(js, f)) for f in (
        "params_g", "batch_stats_g", "params_d", "spectral_d", "params_dt",
        "spectral_dt", "lr_scale")}
    _, jeval_metrics = jax_eval_build(jcfg)(
        js, {k: jnp.asarray(v) for k, v in test.items()})
    js1, jm = jax_build(jcfg)(js, sample)

    ts = load_video_train_state(
        create_video_train_state(tcfg, device="cpu"), fields)
    pred, teval_metrics = build_video_eval_step(tcfg)(ts.net_g, test)
    ts, tm = build_video_train_step(tcfg)(ts, batch)
    return dict(jax=(js1, jm, jeval_metrics), port=(ts, tm, teval_metrics),
                pred=pred)


def test_video_step_losses(runs):
    (_, jm, _), (_, tm, _) = runs["jax"], runs["port"]
    assert set(tm) == set(jm) == set(LOSS_KEYS) | {"health_ok"}
    for k in LOSS_KEYS:
        want, got = float(jm[k]), float(tm[k])
        assert np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(
            want), (k, got, want)
    assert float(tm["health_ok"]) == float(jm["health_ok"]) == 1.0


@pytest.mark.parametrize("net", ["g", "d", "dt"])
def test_video_step_gradients_and_u(runs, net):
    js1, ts = runs["jax"][0], runs["port"][0]
    tnet = getattr(ts, f"net_{net}")
    want = state_from_flax(adam_mu(getattr(js1, f"opt_{net}")), module=tnet)
    assert_grads_close(port_grads(tnet, getattr(ts, f"opt_{net}")),
                       {k: 2.0 * v for k, v in want.items()}, 0.0,
                       GRAD_RTOL_OF_MAX[net])
    if net != "g":
        want_u = state_from_flax(np_tree(getattr(js1, f"spectral_{net}")))
        got_u = {k: v for k, v in tnet.state_dict().items()
                 if k.endswith(".u")}
        assert set(got_u) == set(want_u) and got_u
        for k, u in got_u.items():
            assert float((u - want_u[k]).abs().max()) <= U_ATOL, k
    assert ts.step == int(js1.step) == 1


def test_video_step_leaves_each_d_gradient_its_own_loss():
    """After a step (its updates skipped), each D's ``.grad`` is its D
    loss's gradient alone: the G loss's backward reaches G only."""
    cfg = _tiny(get_preset("vid2vid_temporal"))
    batch = _batch(2)
    st = create_video_train_state(cfg, seed=1, device="cpu")
    grads = {}

    def keep(opt, ok, clip=0.0, lr_scale=1.0):
        grads[id(opt)] = [p.grad.clone() for g in opt[0].param_groups
                          for p in g["params"]]
        opt[0].zero_grad(set_to_none=True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_step, "_apply", keep)
        build_video_train_step(cfg)(st, batch)
    st2 = create_video_train_state(cfg, seed=1, device="cpu")
    a, b = (to_device_clip(batch[k], torch.device("cpu"))
            for k in ("input", "target"))
    with torch.no_grad():
        fake = st2.net_g(fold_frames(a))
    single_forward_d_losses(st2.net_d, torch.cat([fold_frames(a), fake], 1),
                            torch.cat([fold_frames(a), fold_frames(b)], 1),
                            "lsgan")
    single_forward_d_losses(st2.net_dt,
                            torch.cat([a, unfold_frames(fake, BATCH)], 1),
                            torch.cat([a, b], 1), "lsgan")
    for opt, net in ((st.opt_d, st2.net_d), (st.opt_dt, st2.net_dt)):
        for got, p in zip(grads[id(opt)], net.parameters()):
            torch.testing.assert_close(got, p.grad, rtol=0, atol=0)


def test_video_eval_step_per_frame(runs):
    jm, tm = runs["jax"][2], runs["port"][2]
    assert tm["psnr"].shape == (BATCH * FRAMES,) == jm["psnr"].shape
    assert runs["pred"].shape == (BATCH, FRAMES, SIZE, SIZE, 3)
    assert np.abs(tm["psnr"].numpy() - np.asarray(jm["psnr"])).max() \
        <= PSNR_ATOL
    assert np.abs(tm["ssim"].numpy() - np.asarray(jm["ssim"])).max() \
        <= SSIM_ATOL


@pytest.fixture(scope="module")
def clip_dirs(tmp_path_factory):
    kw = dict(n_videos=2, n_frames=10, size=32, seed=5)
    return (jax_synth(str(tmp_path_factory.mktemp("jax_clips")), **kw),
            make_synthetic_video_dataset(
                str(tmp_path_factory.mktemp("port_clips")), **kw))


@pytest.mark.parametrize("dtype,direction,stride,size",
                         [("float32", "b2a", None, 32),
                          ("uint8", "a2b", 3, 32),
                          ("float32", "a2b", None, 24)])
def test_clip_windows_pixels_and_loader_order(clip_dirs, dtype, direction,
                                              stride, size):
    jax_dir, port_dir = clip_dirs
    kw = dict(direction=direction, image_size=size, n_frames=4,
              stride=stride, dtype=dtype)
    want = JaxClips(jax_dir, "train", **kw)
    for root in (jax_dir, port_dir):      # Pillow's PNGs and the port's
        got = VideoClipDataset(root, "train", **kw)
        assert got.windows == want.windows
        for i in range(len(want)):
            w, g = want[i], got[i]
            for k in ("input", "target"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    got = VideoClipDataset(port_dir, "train", **kw)
    for jb, tb in zip(jax_make_loader(want, 3, shuffle=True, seed=7,
                                      num_epochs=2, skip_samples=1),
                      make_loader(got, 3, shuffle=True, seed=7,
                                  num_epochs=2, skip_samples=1),
                      strict=True):
        for k in ("input", "target"):
            np.testing.assert_array_equal(np.asarray(tb[k]),
                                          np.asarray(jb[k]))


@pytest.mark.parametrize("field", ["int8_delayed", "ema_decay"])
def test_video_refusals_match_jax(field):
    tcfg, jcfg = (_tiny(get_preset("vid2vid_temporal")),
                  _tiny(jax_preset("vid2vid_temporal")))
    if field == "int8_delayed":
        def bad(c):
            return c.replace(model=dataclasses.replace(
                c.model, int8=True, int8_delayed=True))

        with pytest.raises(ValueError) as want:
            jax_models(bad(jcfg))
        with pytest.raises(ValueError) as got:
            build_video_models(bad(tcfg))
        with pytest.raises(ValueError) as got_step:
            build_video_train_step(bad(tcfg))
        assert str(got_step.value) == str(want.value)
    else:
        def bad(c):
            return c.replace(health=dataclasses.replace(c.health,
                                                        ema_decay=0.999))

        with pytest.raises(ValueError) as want:
            jax_create(bad(jcfg), jax.random.key(0), _batch(0))
        with pytest.raises(ValueError) as got:
            create_video_train_state(bad(tcfg), device="cpu")
    assert str(got.value) == str(want.value)
