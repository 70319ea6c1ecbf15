"""Slice 6 as a whole: the port's eval step, its trainer and its CLIs
against the JAX package, on the CPU at a tiny ``reference`` (32², ngf 8,
ndf 8, one residual block, 2 D scales, f32, ``lambda_vgg = 0``, batch 1)
and one dataset directory written by the JAX package's
``make_synthetic_dataset`` (2 train, 2 test pairs).

- ``build_eval_step`` of both packages on one JAX state carried into the
  port, and the port's ``InferenceEngine`` with net_c and metrics: G's
  output within 1e-5, per-image PSNR within 1e-3 dB and SSIM within 1e-4
  of the JAX values, and the engine's scores equal to the eval step's.
  The scores see the outputs in uint8 space, where f32 sums taken in
  another order can move a value across a rounding edge; one such flip
  moves PSNR by ~3e-5 dB and SSIM by ~1e-5 here, so the bands allow ~30
  and ~10 flips. Measured: G's output 8e-10 apart, no flip, PSNR 9.5e-6
  dB (the f32 mean's order), SSIM 1.8e-7 (the JAX package's f32 rounding).
- JAX ``Trainer.fit`` against the port's ``Trainer.fit`` from the same
  initial state (the JAX trainer's, carried across) on the same dataset,
  2 epochs of 2 steps: the ``epoch``, ``eval`` and per-step ``train``
  records have the same keys, steps and epoch labels; the first step's
  losses agree within the step test's 1e-5, every later step's and the
  epoch means within its 2e-2 (``tests/test_torch_train_step.py``:
  Adam's sign-like first update can turn last-bit differences into ±lr;
  measured: every step within 2.3e-6); the evals score 2 images each,
  PSNR within 0.05 dB and SSIM within 1e-3 of the JAX trainer's, the
  drift the 2e-2 loss band allows (measured after 4 steps: 5.2e-5 dB,
  1.4e-5). A port trainer built on the same workdir resumes at epoch 3
  and the same step.
- The CLIs, port only: ``generate_dataset`` into both splits, ``train``
  for 2 epochs (bf16 on f32 masters, as the preset), ``infer --metrics``
  from the last checkpoint; the printed metrics equal the last ``eval``
  record to their 4 printed decimals (the same forward on the same
  checkpoint); one PNG per test image; unported flags refused by name
  with exit 2; the card is the default device.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.data.synthetic import make_synthetic_dataset
from p2p_tpu.models.vgg import load_vgg19_params
from p2p_tpu.train.loop import Trainer as JaxTrainer
from p2p_tpu.train.state import create_train_state as jax_create
from p2p_tpu.train.step import build_eval_step as jax_eval_step
from p2p_tpu_torch.cli import generate_dataset, infer, train
from p2p_tpu_torch.convert import load_train_state, state_from_flax
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.pipeline import PairedImageDataset
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset as \
    port_synth
from p2p_tpu_torch.serve.engine import InferenceEngine
from p2p_tpu_torch.train.loop import Trainer
from p2p_tpu_torch.train.state import create_train_state, load_vgg19
from p2p_tpu_torch.train.step import build_eval_step, make_infer_forward
from p2p_tpu_torch.utils.images import decode_png

SIZE = 32
FIELDS = ("params_g", "batch_stats_g", "params_d", "spectral_d",
          "params_c", "batch_stats_c")
PRED_ATOL = 1e-5
PSNR_DB, SSIM_ABS = 1e-3, 1e-4
STEP1_RTOL, LATER_RTOL = 1e-5, 2e-2
FIT_PSNR_DB, FIT_SSIM_ABS = 0.05, 1e-3
LOSSES = ("loss_g", "loss_d", "loss_c", "g_gan", "g_feat", "g_tv")


def _small(cfg, **train):
    return cfg.replace(
        name="tiny",
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=2),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, mixed_precision=False,
                                  **train))


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a), tree)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  n_train=2, n_test=2, size=SIZE, seed=1)


@pytest.fixture(scope="module", autouse=True)
def _no_grain():
    """The JAX loader on its in-process fallback (Grain is installed
    here), for the module-scoped fixtures too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P2P_TPU_NO_GRAIN", "1")
        yield


# ------------------------------------------------------------------ eval
@pytest.fixture(scope="module")
def evals(root):
    jcfg = _small(jax_preset("reference"))
    tcfg = _small(get_preset("reference"))
    ds = PairedImageDataset(root, "test", image_size=SIZE, dtype="uint8")
    batch = {k: np.stack([ds[i][k] for i in range(len(ds))])
             for k in ("input", "target")}
    sample = {k: jnp.asarray(v[:1]) for k, v in batch.items()}
    js = jax.jit(lambda k: jax_create(jcfg, k, sample, 1))(
        jax.random.key(2))
    jpred, jm = jax_eval_step(jcfg)(js, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    ts = load_train_state(create_train_state(tcfg, device="cpu"),
                          {f: _np(getattr(js, f)) for f in FIELDS})
    tpred, tm = build_eval_step(tcfg)(ts, batch)
    return dict(tcfg=tcfg, ts=ts, batch=batch, jpred=np.asarray(jpred),
                jm=_np(jm), tpred=tpred.numpy(),
                tm={k: v.numpy() for k, v in tm.items()})


def test_eval_step_matches_the_jax_eval_step(evals):
    assert evals["tpred"].shape == evals["jpred"].shape == (2, SIZE, SIZE,
                                                            3)
    np.testing.assert_allclose(evals["tpred"], evals["jpred"],
                               atol=PRED_ATOL, rtol=0)
    for k, tol in (("psnr", PSNR_DB), ("ssim", SSIM_ABS)):
        assert evals["tm"][k].shape == (2,)
        np.testing.assert_allclose(evals["tm"][k], evals["jm"][k],
                                   atol=tol, rtol=0, err_msg=k)


def test_eval_step_runs_nets_in_eval_mode_and_restores_train_mode(evals):
    ts = evals["ts"]
    assert ts.net_g.training and ts.net_c.training
    stats = [b.clone() for b in ts.net_g.buffers()]
    build_eval_step(evals["tcfg"])(ts, evals["batch"])
    assert ts.net_g.training and ts.net_c.training
    assert all(torch.equal(a, b) for a, b in zip(stats, ts.net_g.buffers()))


def test_engine_with_net_c_scores_as_the_eval_step(evals):
    ts, cfg, batch = evals["ts"], evals["tcfg"], evals["batch"]
    with pytest.raises(ValueError, match="net_c"):
        InferenceEngine(cfg, ts.net_g, dtype="f32", device="cpu")
    with pytest.raises(ValueError, match="net_c"):
        make_infer_forward(cfg)(ts.net_g, batch)
    engine = InferenceEngine(cfg, ts.net_g, buckets=(1, 2), dtype="f32",
                             device="cpu", net_c=ts.net_c,
                             with_metrics=True)
    stats, metrics = engine.run([{k: v[:1] for k, v in batch.items()},
                                 {k: v[1:] for k, v in batch.items()}],
                                collect_metrics=True)
    assert stats.n_images == 2 and sorted(metrics) == ["psnr", "ssim"]
    for k in metrics:
        np.testing.assert_array_equal(np.asarray(metrics[k], np.float32),
                                      evals["tm"][k])
    pred, _, n = engine.infer_batch(batch)
    np.testing.assert_allclose(pred[:n].numpy(), evals["tpred"], atol=1e-6)
    # G runs on quantize(net_c(target)): the stored input is unused
    other = dict(batch, input=np.zeros_like(batch["input"]))
    np.testing.assert_array_equal(engine.infer_batch(other)[0].numpy(),
                                  pred.numpy())
    plain = InferenceEngine(cfg, ts.net_g, dtype="f32", device="cpu",
                            net_c=ts.net_c)
    with pytest.raises(ValueError, match="with_metrics"):
        plain.run([batch], collect_metrics=True)


# ------------------------------------------------------------------- fit
def _records(path, kinds=("epoch", "eval", "train")):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs
            if r["kind"] in kinds]


@pytest.fixture(scope="module")
def fits(root, tmp_path_factory):
    kw = dict(nepoch=2, epoch_save=1, log_every=1, seed=5)
    jcfg = _small(jax_preset("reference"), **kw)
    tcfg = _small(get_preset("reference"), **kw)
    jdir = str(tmp_path_factory.mktemp("jax_run"))
    tdir = str(tmp_path_factory.mktemp("port_run"))
    jtr = JaxTrainer(jcfg, data_root=root, workdir=jdir, use_mesh=False)
    start = {f: _np(getattr(jtr.state, f)) for f in FIELDS}
    ttr = Trainer(tcfg, data_root=root, workdir=tdir, device="cpu")
    load_train_state(ttr.state, start)
    try:
        jtr.fit()
    finally:
        jtr.close()
    ttr.fit()
    return dict(tcfg=tcfg, root=root, tdir=tdir, jtr=jtr, ttr=ttr,
                jax=_records(os.path.join(jdir, "metrics_tiny.jsonl")),
                port=_records(os.path.join(tdir, "metrics_tiny.jsonl")))


def _kind(recs, kind):
    return [r for r in recs if r["kind"] == kind]


def test_fit_writes_the_jax_records(fits):
    for kind, n in (("epoch", 2), ("eval", 2), ("train", 4)):
        j, p = _kind(fits["jax"], kind), _kind(fits["port"], kind)
        assert len(j) == len(p) == n, kind
        for a, b in zip(j, p):
            assert set(a) == set(b), (kind, sorted(set(a) ^ set(b)))
            assert a["epoch"] == b["epoch"]
            if kind == "train":
                assert a["step"] == b["step"]
                assert a["samples"] == b["samples"]
    assert [r["epoch"] for r in _kind(fits["port"], "epoch")] == [1.0, 2.0]
    assert [r["step"] for r in _kind(fits["port"], "train")] == \
        [1.0, 2.0, 3.0, 4.0]
    assert fits["ttr"].state.step == int(fits["jtr"].state.step) == 4


def test_fit_losses_track_the_jax_trainer(fits):
    jt, pt = _kind(fits["jax"], "train"), _kind(fits["port"], "train")
    for i, (a, b) in enumerate(zip(jt, pt)):
        rtol = STEP1_RTOL if i == 0 else LATER_RTOL
        for k in LOSSES:
            assert b[k] == pytest.approx(a[k], rel=rtol), (i, k)
    for a, b in zip(_kind(fits["jax"], "epoch"), _kind(fits["port"],
                                                       "epoch")):
        for k in LOSSES:
            assert b[k] == pytest.approx(a[k], rel=LATER_RTOL), k
        assert b["health_ok"] == a["health_ok"] == 1.0
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)
    for a, b in zip(_kind(fits["jax"], "eval"), _kind(fits["port"],
                                                      "eval")):
        assert b["n_images"] == a["n_images"] == 2.0
        for k in ("psnr_mean", "psnr_max"):
            assert abs(b[k] - a[k]) <= FIT_PSNR_DB, k
        for k in ("ssim_mean", "ssim_max"):
            assert abs(b[k] - a[k]) <= FIT_SSIM_ABS, k


def test_fit_writes_samples_and_checkpoints_and_resumes(fits):
    tcfg, tdir = fits["tcfg"], fits["tdir"]
    res = os.path.join(tdir, "result", tcfg.data.dataset)
    assert sorted(os.listdir(res)) == sorted(
        f"e{e}_{k}.png" for e in (1, 2)
        for k in ("input", "target", "pred", "comp"))
    ttr = fits["ttr"]
    assert ttr.ckpt.all_steps() == [2, 4]
    assert all(not ttr.ckpt.verify(s) for s in (2, 4))
    again = Trainer(tcfg, data_root=fits["root"], workdir=tdir, device="cpu")
    assert again.maybe_resume()
    assert again.epoch == 3 and again.state.step == ttr.state.step == 4
    for a, b in zip(again.state.net_g.state_dict().values(),
                    ttr.state.net_g.state_dict().values()):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ CLIs
def test_cli_generate_train_infer(tmp_path, capsys):
    src = port_synth(str(tmp_path / "src"), 2, 1, size=2 * SIZE, seed=2)
    data = str(tmp_path / "data")
    for split in ("train", "test"):
        assert generate_dataset.main([
            "--dataset_path", os.path.join(src, split, "a"),
            "--target_dataset_folder", data, "--split", split,
            "--crop_size", str(SIZE), "--max_patches", "2"]) == 0
    work = str(tmp_path / "work")
    common = ["--preset", "reference", "--data_root", data, "--workdir",
              work, "--image_size", str(SIZE), "--ngf", "8", "--n_blocks",
              "1"]
    tiny = ["--ndf", "8", "--lambda_vgg", "0"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(common + tiny)
    capsys.readouterr()
    assert train.main(common + tiny + ["--scan_steps", "2"]) == 2
    assert train.main(common + tiny + ["--mesh", "data=2",
                                       "--tensorboard"]) == 2
    assert "--scan_steps" in capsys.readouterr().err
    assert train.main(common + tiny + ["--scan_steps", "1", "--device",
                                       "cpu", "--nepoch", "2",
                                       "--epochsave", "1"]) == 0
    evals = [json.loads(line) for line in
             open(os.path.join(work, "metrics_reference.jsonl"))
             if '"eval"' in line]
    assert [e["epoch"] for e in evals] == [1.0, 2.0]
    assert infer.main(common + ["--mesh", "1,1,1"]) == 2
    capsys.readouterr()
    out = str(tmp_path / "pred")
    assert infer.main(common + ["--device", "cpu", "--metrics", "--out",
                                out]) == 0
    text = capsys.readouterr().out
    line = next(x for x in text.splitlines() if x.startswith("psnr_mean"))
    got = dict(kv.split("=") for kv in line.split())
    for k, v in got.items():
        assert v == f"{evals[-1][k]:.4f}", (k, v, evals[-1][k])
    names = sorted(os.listdir(os.path.join(data, "test", "a")))
    assert sorted(os.listdir(out)) == names and len(names) == 2
    for n in names:
        assert decode_png(open(os.path.join(out, n), "rb").read()).shape \
            == (SIZE, SIZE, 3)


# ------------------------------------------------------------------ VGG
def test_vgg19_npz_loads_as_the_jax_package_reads_it(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    arrays, cin = {}, 3
    for name, ch in (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
                     ("conv2_2", 128), ("conv3_1", 256), ("conv3_2", 256),
                     ("conv3_3", 256), ("conv3_4", 256), ("conv4_1", 512),
                     ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
                     ("conv5_1", 512)):
        arrays[f"{name}_kernel"] = rng.normal(
            0, 0.1, (3, 3, cin, ch)).astype(np.float32)
        arrays[f"{name}_bias"] = rng.normal(0, 0.1, ch).astype(np.float32)
        cin = ch
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **arrays)
    monkeypatch.setenv("P2P_TPU_VGG19_NPZ", path)
    got = load_vgg19(device="cpu").state_dict()
    want = state_from_flax(_np(load_vgg19_params()))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_vgg19_npz_named_but_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("P2P_TPU_VGG19_NPZ", str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError, match="P2P_TPU_VGG19_NPZ"):
        load_vgg19(device="cpu")
