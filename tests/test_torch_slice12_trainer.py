"""Slice 12's trainer and CLI options on the CPU, at 32² with ngf and ndf 8
(no JAX): a ``reference`` Trainer with ``eval_fid``, ``save_masks`` and the
Sobel and angular terms (VGG19 loaded with ``lambda_vgg`` 0; each eval's
``vfid`` with its feature source; each mask the bitwise AND of the saved
prediction and input); ``eval_every_epoch`` False (no eval, no samples, no
checkpoint marked good); no VFID for a single scored image or for the
video trainer; the flags ``cli.train`` and ``cli.infer`` now accept, and
``cli.infer --compilation_cache`` building into its directory."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from p2p_tpu_torch.cli import infer, train
from p2p_tpu_torch.core import cache
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.data.video import make_synthetic_video_dataset
from p2p_tpu_torch.train import loop
from p2p_tpu_torch.train.loop import Trainer
from p2p_tpu_torch.train.state import load_vgg19
from p2p_tpu_torch.train.video_loop import VideoTrainer
from p2p_tpu_torch.utils.images import decode_png

torch.set_num_threads(1)
SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def _one_seeded_vgg():
    """No VGG asset: the trainers draw the seeded VGG19, once for the
    module (a 20M-parameter draw). BLAS on one thread: VFID's
    eigendecompositions of 1472² matrices spin-wait 20× slower on many
    threads when the suite's other workers hold the cores."""
    vgg = []

    def load(**kw):
        if not vgg:
            vgg.append(load_vgg19(**kw))
        return vgg[0]

    with pytest.MonkeyPatch.context() as mp, threadpool_limits(1):
        mp.delenv("P2P_TPU_VGG19_NPZ", raising=False)
        mp.setattr(loop, "load_vgg19", load)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  n_train=3, n_test=3, size=SIZE, seed=4)


def _small(loss=None, **train):
    cfg = get_preset("reference")
    train = {"mixed_precision": False, "nepoch": 2, "epoch_save": 1,
             **train}
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=2),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0, **(loss or {})),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, **train))


def _records(workdir, kind):
    with open(os.path.join(workdir, "metrics_reference.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_trainer_scores_vfid_writes_masks_and_takes_the_new_terms(
        root, tmp_path):
    cfg = _small(eval_fid=True, save_masks=True,
                 loss=dict(lambda_sobel=1.0, sobel_warmup_epochs=2,
                           lambda_angular=1.0))
    tr = Trainer(cfg, root, str(tmp_path), device="cpu")
    assert tr.vgg is not None and tr.vgg_source == "random"
    tr.fit()
    evals = _records(tmp_path, "eval")
    assert len(evals) == 2
    for r in evals:
        assert r["n_images"] == 3 and np.isfinite(r["vfid"]) and r["vfid"] > 0
        assert r["vfid_feature_source"] == "random"
    for r in _records(tmp_path, "epoch"):
        assert np.isfinite([r["g_sobel"], r["g_angular"]]).all()
        assert "g_style" not in r
    out = tmp_path / "result" / cfg.data.dataset
    for e in (1, 2):
        pred, inp, mask = (decode_png((out / f"e{e}_{k}.png").read_bytes())
                           for k in ("pred", "input", "mask"))
        np.testing.assert_array_equal(mask, np.bitwise_and(pred, inp))
    assert tr.ckpt.last_good_step() == 2 * 3


def test_eval_every_epoch_false_runs_no_eval(root, tmp_path):
    tr = Trainer(_small(eval_every_epoch=False, nepoch=1), root,
                 str(tmp_path), device="cpu")
    assert tr.vgg is None
    tr.fit()
    assert _records(tmp_path, "eval") == []
    (epoch,) = _records(tmp_path, "epoch")
    assert "psnr_mean" not in epoch and np.isfinite(epoch["loss_g"])
    assert not (tmp_path / "result").exists()
    assert tr.ckpt.latest_step() == 3 and tr.ckpt.last_good_step() is None


def test_no_vfid_for_one_image_or_for_video(tmp_path):
    one = make_synthetic_dataset(str(tmp_path / "one"), n_train=1,
                                 n_test=1, size=SIZE, seed=2)
    tr = Trainer(_small(eval_fid=True), one, str(tmp_path / "w1"),
                 device="cpu")
    res = tr.evaluate()
    assert res["n_images"] == 1 and "vfid" not in res
    clips = make_synthetic_video_dataset(str(tmp_path / "clips"), n_videos=1,
                                         n_frames=4, size=16)
    vcfg = get_preset("vid2vid_temporal")
    vcfg = vcfg.replace(
        model=dataclasses.replace(vcfg.model, ngf=8, ndf=8, num_D=2,
                                  n_layers_D=2),
        data=dataclasses.replace(vcfg.data, image_size=16, n_frames=4),
        loss=dataclasses.replace(vcfg.loss, lambda_style=1.0),
        train=dataclasses.replace(vcfg.train, eval_fid=True,
                                  save_masks=True, mixed_precision=False))
    vt = VideoTrainer(vcfg, clips, str(tmp_path / "w2"), device="cpu")
    assert vt.vgg is None and vt.fid_feature_fn is None
    res = vt.evaluate(save_samples=True)
    assert "vfid" not in res and not (tmp_path / "w2" / "result").exists()


def test_cli_flags_of_slice_12_are_accepted():
    # --tp_min_ch and the serving --mesh are ported with the model axis,
    # --pp_overlap and --recalibrate_steps with the pipe axis and TP x int8
    assert {n for n, _, _ in train.UNPORTED} == {"scan_steps"}
    assert {n for n, _, _ in infer.UNPORTED} == set()
    args = train.build_parser().parse_args(
        ["--threads", "2", "--lambda_sobel", "1.5", "--sobel_warmup_epochs",
         "3", "--lambda_angular", "0.5", "--save_masks", "--eval_fid"])
    assert train.refuse_unported(args, train.UNPORTED) == 0
    cfg = train.config_from_flags(args)
    assert (cfg.data.threads, cfg.loss.lambda_sobel,
            cfg.loss.sobel_warmup_epochs, cfg.loss.lambda_angular,
            cfg.train.save_masks, cfg.train.eval_fid) == (2, 1.5, 3, 0.5,
                                                         True, True)
    assert train.main(["--scan_steps", "4"]) == 2


def test_infer_builds_into_its_compilation_cache(root, tmp_path,
                                                 monkeypatch):
    work = tmp_path / "run"
    flags = ["--preset", "reference", "--data_root", root, "--device", "cpu",
             "--image_size", str(SIZE), "--ngf", "8", "--n_blocks", "1",
             "--workdir", str(work)]
    assert train.main(flags + ["--ndf", "8", "--lambda_vgg", "0", "--nepoch",
                               "1", "--epochsave", "1"]) == 0
    monkeypatch.setattr(cache, "_enabled_dir", cache._enabled_dir)
    built = tmp_path / "cc"
    assert infer.main(flags + ["--compilation_cache", str(built),
                               "--dtype", "f32"]) == 0
    assert cache.compilation_cache_dir() == str(built)
    assert any(f.startswith("libfastimage-") for f in os.listdir(built))
