"""pix2pixHD's coarse-to-fine training in the port against the JAX package
on the CPU: the graft (train/graft.py), the two CLI phases, and the
phase-1 (``pix2pixhd_global``) train step with the pool, the EMA and the
gradient clip on.

- The graft of a G1 tree into the full generator: the same grafted and
  dropped paths as the JAX ``graft_global_into_full`` (names mapped:
  ``/`` → ``.``, ``Conv_0`` → ``conv``, ``kernel`` → ``weight``), G1's
  image head dropped; a shape mismatch, an empty graft and a missing
  phase-1 directory raise (the last before anything is created on disk);
  the full generator with the converted G1 grafted in (ngf 8, 1 block,
  64×128, f32, the preset's ``pallas_instance`` norms on the plain
  versions of #1 and #3) against the JAX graft of the same trees, forward
  within 1e-5 abs.
- ``python -m p2p_tpu_torch.cli.train --phase global`` then ``--phase
  full`` on the CPU at that size: phase 1 trains G1 at 32×64 under
  ``pix2pixhd_g1``; phase 2 starts from G1's checkpoint grafted in,
  every grafted leaf bitwise the checkpoint's, the head listed as
  dropped; a resume does not graft again.
- The phase-1 step: the JAX preset with ``split_d_pairs`` off (the pool
  stores concatenated pairs) shrunk to ngf 8, ndf 8, one block at 32×64,
  f32, ``pool_size=2``, ``ema_decay=0.999``, ``grad_clip=1.0``, the JAX
  Pallas kernels in interpret mode; 2 steps, the port's pool fed the JAX
  draws. Tolerances as tests/test_torch_cityscapes_step.py sets them for
  the same options (losses 1e-4 relative at step 1 and 2e-4 at step 2, D's
  gradient 1e-5 + 1e-4 of the largest, G's 1e-5 + 5e-3, the EMA 2e-6),
  measured here: losses 6.8e-7 and 1.09e-4, D 1.3e-6, G 8.4e-4, EMA
  1.13e-6. The pool's real_a halves bitwise (its fake halves, G's outputs
  at step 2 after one update, moved by 9e-3 and are held through loss_d).
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.models.registry import define_G as jax_define_G  # noqa: E402
from p2p_tpu.train import graft as jax_graft  # noqa: E402
from p2p_tpu_torch.cli import train as cli_train  # noqa: E402
from p2p_tpu_torch.convert import (graft_flax_g1, load_flax,  # noqa: E402
                                   state_from_flax)
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_dataset, synthetic_hd_batch)
from p2p_tpu_torch.models.registry import define_G  # noqa: E402
from p2p_tpu_torch.train import graft  # noqa: E402
from p2p_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from torch_step_parity import (  # noqa: E402
    assert_grads_close, assert_losses_close, jax_start, np_tree, run_both)

H, W = 64, 128
FWD_ATOL = 1e-5
KEYS = ("loss_g", "loss_d", "g_gan", "g_feat", "g_vgg", "nonfinite_g",
        "nonfinite_d")
STEP1_RTOL, LATER_RTOL = 1e-4, 2e-4
GRAD_ATOL = 1e-5
GRAD_RTOL = {"g": 5e-3, "d": 1e-4}
EMA_ATOL = 2e-6


def _model(cfg, **kw):
    return dataclasses.replace(cfg.model, **{"ngf": 8, "ndf": 8,
                                             "n_blocks": 1, **kw})


def _jax_params(generator, h, w):
    g = jax_define_G(_model(jax_preset("pix2pixhd"), generator=generator))
    v = jax.jit(lambda k: g.init(k, jnp.zeros((1, h, w, 3)), False))(
        jax.random.key(0 if generator == "pix2pixhd" else 1))
    return g, np_tree(v["params"])


def _port_path(jax_path):
    return ".".join({"Conv_0": "conv", "kernel": "weight"}.get(p, p)
                    for p in jax_path.split("/"))


@pytest.fixture(scope="module")
def trees():
    full, full_params = _jax_params("pix2pixhd", H, W)
    _, g1_params = _jax_params("pix2pixhd_global", H // 2, W // 2)
    return full, full_params, g1_params


def test_graft_lists_and_forward_match_jax(trees):
    full, full_params, g1_params = trees
    want_tree, grafted, dropped = jax_graft.graft_tree(
        full_params["global"], g1_params, "global")
    tg = load_flax(define_G(_model(get_preset("pix2pixhd"))), full_params)
    out, got_grafted, got_dropped = graft.graft_tree(
        graft.nest(dict(tg.named_parameters()))["global"],
        graft.nest(state_from_flax(g1_params)), "global")
    assert got_grafted == [_port_path(p) for p in grafted]
    assert got_dropped == [_port_path(p) for p in dropped] == [
        "global.ConvLayer_5"]
    with redirect_stdout(io.StringIO()) as text:
        graft_flax_g1(tg, g1_params)
    assert "1 head leaves dropped (global.ConvLayer_5)" in text.getvalue()
    for k, p in tg.named_parameters():
        if k.startswith("global."):
            assert torch.equal(p, state_from_flax(g1_params)[k[7:]]), k
    x = np.random.default_rng(0).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    grafted_params = jax_graft.graft_global_into_full(
        full_params, g1_params, verbose=False)
    want = jax.jit(lambda p: full.apply({"params": p}, x, False))(
        grafted_params)
    with torch.no_grad():
        got = tg.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_graft_errors(trees, tmp_path):
    _, full_params, g1_params = trees
    tg = load_flax(define_G(_model(get_preset("pix2pixhd"))), full_params)
    wide = define_G(_model(get_preset("pix2pixhd"),
                           generator="pix2pixhd_global", ngf=16))
    with pytest.raises(ValueError, match="graft shape mismatch at "
                                         "global.ConvLayer_0.conv.weight"):
        graft.graft_into(tg, dict(wide.named_parameters()))
    with pytest.raises(ValueError, match="graft copied nothing"):
        graft.graft_into(tg, {"head.weight": torch.zeros(3)})
    with pytest.raises(ValueError, match="no 'global' submodule"):
        graft.graft_global_into_full({"ConvLayer_0": {}}, {})
    cfg = get_preset("pix2pixhd")
    missing = tmp_path / "work"
    with pytest.raises(FileNotFoundError, match="run --phase global first"):
        graft.load_and_graft_g1(None, cfg, workdir=str(missing))
    assert not missing.exists()
    g1 = graft.g1_phase_config(cfg)
    assert (g1.name, g1.model.generator, g1.image_hw) == (
        "pix2pixhd_g1", "pix2pixhd_global", (256, 512))
    assert graft.g1_phase_config(g1).name == "pix2pixhd_g1"


def test_cli_phase_global_then_full(tmp_path, capsys):
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=2,
                                  n_test=1, size=64, seed=0)
    work = str(tmp_path / "work")
    common = ["--preset", "pix2pixhd", "--data_root", root, "--workdir",
              work, "--device", "cpu", "--image_size", str(H),
              "--image_width", str(W), "--ngf", "8", "--ndf", "8",
              "--n_blocks", "1", "--lambda_vgg", "0", "--epochsave", "1"]
    assert cli_train.main(common + ["--phase", "global", "--nepoch",
                                    "1"]) == 0
    g1_dir = os.path.join(work, "checkpoint", "cityscapes_hd",
                          "pix2pixhd_g1")
    mgr = CheckpointManager(g1_dir)
    assert mgr.all_steps() == [2] and mgr.verify(2) == []
    saved = mgr.read(2, ["net_g"])["net_g"]
    assert saved["ConvLayer_0.conv.weight"].shape == (8, 3, 7, 7)
    seen = {}
    real_graft_into = graft.graft_into

    def record(net_g, g1_params, verbose=True):
        real_graft_into(net_g, g1_params, verbose)
        seen.update({k: p.detach().clone()
                     for k, p in net_g.named_parameters()})

    capsys.readouterr()
    with mock.patch.object(graft, "graft_into", record):
        assert cli_train.main(common + ["--phase", "full", "--nepoch",
                                        "1"]) == 0
    out = capsys.readouterr().out
    assert "1 head leaves dropped (global.ConvLayer_5)" in out
    head = [k for k in saved if k.startswith("ConvLayer_5.")]
    assert head and all(f"global.{k}" not in seen for k in head)
    n = 0
    for k, v in saved.items():
        if k.startswith("ConvLayer_5."):
            continue
        assert torch.equal(seen[f"global.{k}"], v), k
        n += 1
    assert f"coarse-to-fine graft: {n} leaves" in out
    full_dir = os.path.join(work, "checkpoint", "cityscapes_hd", "pix2pixhd")
    assert CheckpointManager(full_dir).all_steps() == [2]
    seen.clear()
    with mock.patch.object(graft, "graft_into", record):
        assert cli_train.main(common + ["--phase", "full", "--nepoch",
                                        "2"]) == 0
    assert not seen and "resumed at epoch 2" in capsys.readouterr().out


def _g1_cfg(cfg):
    return cfg.replace(
        model=_model(cfg, generator="pix2pixhd_global", split_d_pairs=False),
        data=dataclasses.replace(cfg.data, image_size=H // 2,
                                 image_width=W // 2),
        optim=dataclasses.replace(cfg.optim, grad_clip=1.0),
        train=dataclasses.replace(cfg.train, mixed_precision=False,
                                  pool_size=2),
        health=dataclasses.replace(cfg.health, ema_decay=0.999))


def _batches(n):
    return [synthetic_hd_batch(1, H // 2, W // 2, seed=i) for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _g1_cfg(jax_preset("pix2pixhd")), _g1_cfg(
        get_preset("pix2pixhd"))
    start = jax_start(jcfg, _batches(1)[0])
    return run_both(jcfg, tcfg, _batches(2), KEYS, start, keep_states=True)


@pytest.mark.parametrize("i", range(2))
def test_phase1_step_losses_track_the_jax_step(runs, i):
    assert_losses_close({k: runs[k][i:i + 1] for k in ("jax", "port")},
                        KEYS[:-2], STEP1_RTOL if i == 0 else LATER_RTOL)
    for k in KEYS[-2:]:
        assert runs["jax"][i][k] == runs["port"][i][k] == 0.0


@pytest.mark.parametrize("net", ["g", "d"])
def test_phase1_step1_gradients_match_the_jax_step(runs, net):
    got, want = runs["grads"][net]
    assert_grads_close(got, want, GRAD_ATOL, GRAD_RTOL[net])


def test_phase1_pool_and_ema_match_the_jax_state(runs):
    js, ts = runs["states"]
    assert int(ts.pool_n) == int(np.asarray(js.pool_n)) == 2
    np.testing.assert_array_equal(ts.pool.numpy()[..., :3],
                                  np.asarray(js.pool)[..., :3])
    want = state_from_flax(np_tree(js.ema_g), module=ts.net_g)
    for k, w in want.items():
        np.testing.assert_allclose(ts.ema_g[k].numpy(), w.numpy(),
                                   atol=EMA_ATOL, rtol=0, err_msg=k)
