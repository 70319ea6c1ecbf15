"""EMA serving in the port (port only, on the CPU): a tiny ``facades``
U-Net (BatchNorm, so the served buffers are G's running statistics) and
a tiny ``cityscapes_spatial`` ResNet G trained 3 steps with
``ema_decay=0.5`` and checkpointed.

- ``engine_from_checkpoint`` with ``ema_decay`` set serves the smoothed G:
  its predictions equal, bitwise, those of an engine built from G with
  the EMA parameters loaded (and G's own running statistics); without it,
  the raw G; the BatchNorm U-Net keeps f32 masters in the engine;
- ``ema_decay=0`` training serves bitwise what the raw G serves;
- ``Tenant.reload`` keeps the EMA policy;
- ``cli.serve --ema_decay`` (directory mode, ``--once``) and ``cli.infer
  --ema_decay`` write the EMA engine's images; the tenant key
  ``ema_decay=`` sets the tenant's config, and a value that is not a
  number is refused;
- a checkpoint without an EMA cannot be served with ``ema_decay``.

Tolerance: none (bitwise), f32 engines on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from p2p_tpu_torch.cli import infer as cli_infer
from p2p_tpu_torch.cli import serve as cli_serve
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.pipeline import PairedImageDataset
from p2p_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                          synthetic_hd_batch)
from p2p_tpu_torch.models.registry import define_G
from p2p_tpu_torch.serve.engine import InferenceEngine, \
    engine_from_checkpoint
from p2p_tpu_torch.serve.tenancy import Tenant, checkpoint_dir
from p2p_tpu_torch.train.checkpoint import CheckpointCorrupt, \
    CheckpointManager
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.train.step import build_train_step
from p2p_tpu_torch.utils.images import decode_png, encode_png, \
    to_uint8_img

SIZE = 32
TINY = {"facades": ["--image_size", str(SIZE), "--ngf", "8"],
        "cityscapes_spatial": ["--image_size", str(SIZE), "--image_width",
                               str(SIZE), "--ngf", "8", "--n_blocks", "1"]}


def _cfg(preset, decay):
    cfg = get_preset(preset)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  use_dropout=False),
        data=dataclasses.replace(cfg.data, image_size=SIZE,
                                 image_width=SIZE, batch_size=1),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        train=dataclasses.replace(cfg.train, mixed_precision=False),
        health=dataclasses.replace(cfg.health, ema_decay=decay))


def _train(preset, decay, work, steps=(3,)):
    """Train ``_cfg(preset, decay)`` and save after each of ``steps``."""
    cfg = _cfg(preset, decay)
    ts = create_train_state(cfg, device="cpu")
    step = build_train_step(cfg)
    mgr = CheckpointManager(checkpoint_dir(cfg, work))
    for i in range(max(steps)):
        ts, _ = step(ts, synthetic_hd_batch(1, SIZE, SIZE, seed=i))
        if ts.step in steps:
            mgr.save(ts.step, ts, 1)
    return cfg, ts


def _requests(n=2):
    return [synthetic_hd_batch(1, SIZE, SIZE, seed=10 + i)
            for i in range(n)]


def _preds(engine, batches):
    return [engine.infer_batch(b)[0].numpy() for b in batches]


def _engine(cfg, net_g, **kw):
    return InferenceEngine(cfg, net_g, buckets=(1,), dtype="f32",
                           device="cpu", **kw)


@pytest.fixture(scope="module", params=["facades", "cityscapes_spatial"])
def trained(request, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("work"))
    cfg, ts = _train(request.param, 0.5, work, steps=(2, 3))
    return request.param, cfg, ts, work


def test_engine_serves_the_ema_generator(trained):
    preset, cfg, ts, work = trained
    ckpt = checkpoint_dir(cfg, work)
    eng, step = engine_from_checkpoint(cfg, ckpt, buckets=(1,), dtype="f32",
                                       device="cpu")
    assert step == 3
    want_g = define_G(cfg.model, image_hw=cfg.image_hw)
    want_g.load_state_dict({**ts.net_g.state_dict(), **ts.ema_g})
    batches = _requests()
    for got, want in zip(_preds(eng, batches),
                         _preds(_engine(cfg, want_g), batches)):
        np.testing.assert_array_equal(got, want)
    raw_cfg = cfg.replace(health=dataclasses.replace(cfg.health,
                                                     ema_decay=None))
    raw, _ = engine_from_checkpoint(raw_cfg, ckpt, buckets=(1,),
                                    dtype="f32", device="cpu")
    assert not np.array_equal(_preds(raw, batches)[0],
                              _preds(eng, batches)[0])
    for k, p in eng.model.named_parameters():
        assert p.dtype == torch.float32, k
        assert torch.equal(p, ts.ema_g[k]), k


def test_tenant_reload_keeps_the_ema_policy(trained):
    preset, cfg, ts, work = trained
    tenant = Tenant("t", cfg, checkpoint_dir(cfg, work), step=2,
                    buckets=(1,), dtype="f32", device="cpu")
    assert tenant.reload(3)["step"] == 3
    for k, p in tenant.engine.model.named_parameters():
        assert torch.equal(p, ts.ema_g[k]), k


def test_ema_at_decay_zero_serves_the_raw_generator(tmp_path):
    cfg, ts = _train("facades", 0.0, str(tmp_path))
    for k, p in ts.net_g.named_parameters():
        assert torch.equal(ts.ema_g[k], p), k
    batches = _requests()
    ema, _ = engine_from_checkpoint(cfg, checkpoint_dir(cfg, str(tmp_path)),
                                    buckets=(1,), dtype="f32", device="cpu")
    for got, want in zip(_preds(ema, batches),
                         _preds(_engine(cfg, ts.net_g), batches)):
        np.testing.assert_array_equal(got, want)


def test_ema_serving_needs_a_checkpoint_with_an_ema(tmp_path):
    cfg, _ = _train("facades", None, str(tmp_path))
    ema = cfg.replace(health=dataclasses.replace(cfg.health, ema_decay=0.9))
    with pytest.raises(CheckpointCorrupt, match="has no ema_g"):
        engine_from_checkpoint(ema, checkpoint_dir(cfg, str(tmp_path)),
                               buckets=(1,), dtype="f32", device="cpu")


def test_cli_serve_ema_decay_writes_the_ema_images(trained, tmp_path,
                                                    capsys):
    preset, cfg, ts, work = trained
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    imgs = [b["input"][0] for b in _requests()]
    for i, img in enumerate(imgs):
        (in_dir / f"r{i}.png").write_bytes(encode_png(img))
    args = ["--preset", preset, "--input_dir", str(in_dir), "--workdir",
            work, "--device", "cpu", "--dtype", "f32", "--once",
            "--buckets", "1", "--ema_decay", "0.5"] + TINY[preset]
    assert cli_serve.main(args) == 0
    eng, _ = engine_from_checkpoint(cfg, checkpoint_dir(cfg, work),
                                    buckets=(1,), dtype="f32", device="cpu")
    out = tmp_path / "in_out"
    for i, img in enumerate(imgs):
        pred = eng.infer_batch({"input": img[None]})[0][0]
        np.testing.assert_array_equal(
            decode_png((out / f"r{i}.png").read_bytes()),
            to_uint8_img(pred.numpy()))
    capsys.readouterr()


def test_cli_infer_ema_decay_writes_the_ema_images(tmp_path, capsys):
    """``cli.infer`` (square sizes only, as the JAX CLI) on the U-Net."""
    preset, work = "facades", str(tmp_path / "work")
    cfg, _ = _train(preset, 0.5, work)
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=1,
                                  n_test=2, size=SIZE, seed=4)
    out = str(tmp_path / "pred")
    assert cli_infer.main(["--preset", preset, "--data_root", root,
                           "--workdir", work, "--device", "cpu", "--dtype",
                           "f32", "--out", out, "--ema_decay", "0.5"]
                          + TINY[preset]) == 0
    eng, _ = engine_from_checkpoint(cfg, checkpoint_dir(cfg, work),
                                    buckets=(1,), dtype="f32", device="cpu")
    ds = PairedImageDataset(root, "test", cfg.data.direction, SIZE, SIZE,
                            dtype="uint8")
    for i, name in enumerate(sorted(os.listdir(out))):
        pred = eng.infer_batch({"input": ds[i]["input"][None].copy()})[0][0]
        np.testing.assert_array_equal(
            decode_png(open(os.path.join(out, name), "rb").read()),
            to_uint8_img(pred.numpy()))
    capsys.readouterr()


def test_tenant_key_ema_decay_sets_the_tenants_config():
    args = cli_serve.build_parser().parse_args(["--http", "127.0.0.1:0"])
    alias, kv = cli_serve._parse_tenant_spec(
        "alias=hd,preset=pix2pixhd,ema_decay=0.999")
    assert (alias, kv) == ("hd", {"preset": "pix2pixhd",
                                  "ema_decay": "0.999"})
    assert cli_serve._build_config(args, kv).health.ema_decay == 0.999
    assert cli_serve._build_config(args, {}).health.ema_decay is None
    base = cli_serve.build_parser().parse_args(["--ema_decay", "0.5"])
    assert cli_serve._build_config(base, {}).health.ema_decay == 0.5
    with pytest.raises(ValueError, match="ema_decay='x'"):
        cli_serve._parse_tenant_spec("alias=a,ema_decay=x")
