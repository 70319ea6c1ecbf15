"""The port's video trainer and its CLI routes on the CPU
(``p2p_tpu_torch/train/video_loop.py``, ``train/checkpoint.py``,
``cli/train.py``, ``cli/infer.py``) and the serving refusals of video
presets, at a tiny ``vid2vid_temporal`` over synthetic clips of 16²: 2
train and 2 test videos of 16 frames (two 8-frame clips each, 4-frame
clips in the in-process trainer).

- ``VideoTrainer.fit`` end to end: 2 epochs of 8 steps (one, then a
  resume for the second), an eval and a checkpoint an epoch, the records
  and files a run writes.
- A checkpoint round trip is bitwise (every network, ``u``, optimizer
  and scheduler, the temporal D's included).
- ``P2P_CHAOS=elastic@6`` through ``cli.train``: exit 75 at step 6, then
  the relaunch resumes at epoch 2, batch 2, reads exactly the clips the
  uninterrupted run read after its sixth step and ends bitwise in its
  state (the twin of ``tests/test_resilience.py``'s exact-resume test).
- ``cli.train`` → ``cli.infer --metrics`` writes every frame of every
  test clip as ``<video>_<frame>.png`` (the twin of ``tests/test_cli.py``'s
  train-then-infer test).
- The serving engine, a tenant and ``cli.serve`` (directory and HTTP
  modes) refuse a video preset with the JAX messages (exit 2), and
  ``cli.train`` a fake pool for one.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from p2p_tpu.cli import serve as jax_cli_serve
from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.serve.engine import InferenceEngine as JaxEngine
from p2p_tpu.serve.tenancy import Tenant as JaxTenant
from p2p_tpu_torch.cli import infer as cli_infer
from p2p_tpu_torch.cli import serve as cli_serve
from p2p_tpu_torch.cli import train as cli_train
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data import video
from p2p_tpu_torch.data.generate import read_png
from p2p_tpu_torch.data.video import make_synthetic_video_dataset
from p2p_tpu_torch.models.registry import define_G
from p2p_tpu_torch.resilience import (PREEMPTED_EXIT_CODE, ChaosMonkey,
                                      install_chaos)
from p2p_tpu_torch.serve.engine import InferenceEngine
from p2p_tpu_torch.serve.tenancy import Tenant
from p2p_tpu_torch.train.checkpoint import (CheckpointManager,
                                            tensor_checksums)
from p2p_tpu_torch.train.video_loop import VideoTrainer
from p2p_tpu_torch.train.video_step import (build_video_train_step,
                                            create_video_train_state)

SIZE = 16
NETS = ("net_g", "net_d", "net_dt")
OPTS = ("opt_g", "opt_d", "opt_dt")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread, restored afterwards: these tiny steps are
    latency-bound, and one thread keeps them fast when the suite's workers
    share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _no_ambient_chaos():
    install_chaos(None)
    yield
    install_chaos(None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_video_dataset(
        str(tmp_path_factory.mktemp("clips")), n_videos=2, n_frames=16,
        size=SIZE, seed=5)


def _cfg():
    cfg = get_preset("vid2vid_temporal")
    return cfg.replace(
        name="tiny",
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, num_D=2,
                                  n_layers_D=2),
        data=dataclasses.replace(cfg.data, image_size=SIZE, n_frames=4),
        train=dataclasses.replace(cfg.train, nepoch=2, epoch_save=1,
                                  log_every=100, mixed_precision=False))


def _everything(state):
    """Every tensor and count of a video train state, by name."""
    out = {"step": torch.tensor(state.step),
           "lr_scale": torch.tensor(state.lr_scale)}
    for name in NETS:
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}/{k}"] = v.clone()
    for name in OPTS:
        opt, sched = getattr(state, name)
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}/{i}/{k}"] = torch.as_tensor(v).clone()
        out[f"{name}/last_epoch"] = torch.tensor(sched.last_epoch)
        out[f"{name}/lr"] = torch.tensor(sched.get_last_lr())
    return out


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert bad == []


def _records(work, name):
    with open(os.path.join(work, f"metrics_{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


@contextlib.contextmanager
def _train_reads():
    """The train split's clip indices, in the order the loaders read
    them."""
    reads = []
    orig = video.VideoClipDataset.__getitem__

    def recording(self, idx):
        if os.path.basename(os.path.dirname(self.a_dir)) == "train":
            reads.append(int(idx))
        return orig(self, idx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video.VideoClipDataset, "__getitem__", recording)
        yield reads


def test_video_trainer_fit_end_to_end(root, tmp_path):
    work = str(tmp_path / "run")
    tr = VideoTrainer(_cfg(), data_root=root, workdir=work, device="cpu")
    assert (len(tr.train_ds), len(tr.test_ds), tr.steps_per_epoch) \
        == (8, 8, 8)
    history = tr.fit(nepoch=1)
    tr2 = VideoTrainer(_cfg(), data_root=root, workdir=work, device="cpu")
    assert tr2.maybe_resume() and tr2.epoch == 2
    history += tr2.fit()
    assert [h["epoch"] for h in history] == [1, 2]
    for h in history:
        for k in ("loss_d", "loss_dt", "loss_g", "g_gan", "g_gan_t",
                  "g_feat", "psnr_mean", "ssim_mean"):
            assert np.isfinite(h[k]), k
        assert h["frames_per_sec"] > 0 and h["health_ok"] == 1.0
        assert h["n_frames_scored"] == 32
    assert tr2.state.step == 16
    assert tr2.ckpt.all_steps() == [8, 16]
    assert all(tr2.ckpt.verify(s) == [] for s in (8, 16))
    assert tr2.ckpt.last_good_step() == 16
    for f in ("net_dt.pt", "opt_dt.pt"):
        assert os.path.exists(os.path.join(tr2.ckpt.step_dir(16), f))
    kinds = {r["kind"] for r in _records(work, "tiny")}
    assert {"manifest", "epoch", "eval", "health_summary"} <= kinds
    assert os.path.exists(os.path.join(work, "trace_tiny.json"))


def test_video_checkpoint_round_trip_is_bitwise(root, tmp_path):
    cfg = _cfg()
    st = create_video_train_state(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 256, (1, 4, SIZE, SIZE, 3), dtype=np.uint8)
             for k in ("input", "target")}
    st, _ = build_video_train_step(cfg)(st, batch)
    st.lr_scale = 0.5
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(st.step, st, epoch=1)
    assert mgr.verify(st.step) == []
    other = create_video_train_state(cfg, seed=2, device="cpu")
    build_video_train_step(cfg)(other, batch)      # optimizer state exists
    assert mgr.restore(other) == (1, 1)
    _assert_bitwise(_everything(other), _everything(st))


def _cli(root, work, *extra):
    return cli_train.main([
        "--preset", "vid2vid_temporal", "--data_root", root, "--workdir",
        work, "--device", "cpu", "--image_size", str(SIZE), "--ngf", "8",
        "--ndf", "8", "--nepoch", "2", "--epochsave", "1", *extra])


def test_cli_elastic_resume_bitwise_then_infer_every_frame(root, tmp_path):
    cfg = get_preset("vid2vid_temporal")
    ckpt_of = lambda w: CheckpointManager(os.path.join(  # noqa: E731
        w, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name))
    with _train_reads() as reads_u:
        assert _cli(root, str(tmp_path / "u")) == 0
    assert len(reads_u) == 8
    work = str(tmp_path / "p")
    install_chaos(ChaosMonkey.from_spec("elastic@6"))
    with _train_reads() as reads_p:
        assert _cli(root, work) == PREEMPTED_EXIT_CODE
    install_chaos(None)
    assert reads_p == reads_u[:6]
    mgr = ckpt_of(work)
    assert mgr.all_steps() == [4, 6]
    aux = mgr.restore_aux(6)
    assert (aux["batches_done"], aux["epoch"], aux["samples_seen"]) \
        == (2, 2, 6)
    with _train_reads() as reads_r:
        assert _cli(root, work) == 0
    assert reads_r == reads_u[6:]
    recs = _records(work, cfg.name)
    assert [(r["step"], r["epoch"], r["batches_done"]) for r in recs
            if r["kind"] == "resume"] == [(6, 2, 2)]
    assert [r["step"] for r in recs if r["kind"] == "preempt"] == [6]
    assert mgr.all_steps() == [4, 6, 8]
    # the resumed run's last checkpoint is the uninterrupted run's, bitwise
    names = ["net_g", "net_d", "net_dt", "opt_g", "opt_d", "opt_dt"]
    got, want = mgr.read(8, names), ckpt_of(str(tmp_path / "u")).read(
        8, names)
    for n in names:
        assert tensor_checksums(got[n]) == tensor_checksums(want[n]), n
        if n.startswith("opt"):
            assert got[n]["scheduler"] == want[n]["scheduler"], n

    out = str(tmp_path / "frames")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_infer.main([
            "--preset", "vid2vid_temporal", "--data_root", root,
            "--workdir", work, "--device", "cpu", "--image_size", str(SIZE),
            "--ngf", "8", "--metrics", "--out", out])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("wrote 32 frames / 4 clips (checkpoint "
                               "step 8)")
    assert lines[1].startswith("psnr_mean=") and "ssim_max=" in lines[1]
    want_names = sorted(f"v{v:03d}_f{t:04d}.png" for v in range(2)
                        for t in range(16))
    assert sorted(os.listdir(out)) == want_names
    assert read_png(os.path.join(out, want_names[0])).shape == (SIZE, SIZE,
                                                                3)


def test_cli_train_refuses_a_pool_for_video(root, tmp_path, capsys):
    assert _cli(root, str(tmp_path), "--pool_size", "4") == 2
    assert "video step has no fake pool" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "checkpoint")


def test_serving_refuses_video_with_the_jax_messages(tmp_path, capsys):
    tcfg, jcfg = get_preset("vid2vid_temporal"), jax_preset(
        "vid2vid_temporal")
    with pytest.raises(NotImplementedError) as want:
        JaxEngine(jcfg, None)
    with pytest.raises(NotImplementedError) as got:
        InferenceEngine(tcfg, define_G(tcfg.model, image_hw=tcfg.image_hw),
                        device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxTenant("v", jcfg, str(tmp_path))
    with pytest.raises(ValueError) as got:
        Tenant("v", tcfg, str(tmp_path), device="cpu")
    assert str(got.value) == str(want.value)
    req = tmp_path / "req"
    req.mkdir()
    argv = ["--preset", "vid2vid_temporal", "--input_dir", str(req),
            "--workdir", str(tmp_path), "--once"]
    assert jax_cli_serve.main(argv) == 2
    want_err = capsys.readouterr().err
    assert cli_serve.main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == want_err
    assert cli_serve.main(["--http", "127.0.0.1:0", "--workdir",
                           str(tmp_path), "--device", "cpu", "--tenant",
                           "alias=v,preset=vid2vid_temporal"]) == 2
    assert capsys.readouterr().err == want_err
