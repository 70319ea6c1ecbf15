"""Preemption and exact-step resume of the port's trainer
(``p2p_tpu_torch/train/loop.py``, ``train/checkpoint.py``, ``cli/train.py``)
on the CPU, at a tiny ``reference`` (32², ngf 8, ndf 8, one block, 2 D
scales, ``lambda_vgg`` 0, f32, batch 1) over 4 train pairs: 2 epochs of
4 steps.

- Preempted at step 6 of 8 by an injected guard, then resumed: the
  resumed trainer re-enters epoch 2 at batch 2, reads exactly the train
  samples the uninterrupted run read after its sixth step, in order, and
  ends in a state BITWISE equal to it (every parameter, buffer, optimizer
  and scheduler state), as ``tests/test_resilience.py`` pins the JAX
  trainer.
- The same through ``cli.train`` with ``P2P_CHAOS=elastic@6`` (exit 75,
  then 0; bf16 on f32 masters as the preset): the last checkpoint bitwise
  the uninterrupted CLI run's.
- The sidecar's keys (and its topology block's) are the JAX sidecar's:
  ``p2p_tpu.train.loop.save_trainer_ckpt`` is run on a stand-in trainer
  and both payloads are compared.
- A corrupt sidecar reads as missing and is counted; a corrupt newest
  step falls back to the older one and moves the resume position; the
  sidecar's ``lr_base`` and ``seed_jitter`` come back on resume.
- A ``cli.train`` subprocess sent a real SIGTERM after its first ``train``
  record exits 75 with a sidecar; the relaunch resumes and exits 0.
"""

import dataclasses
import json
import os
import select
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.train import loop as jax_loop
from p2p_tpu_torch.cli import train as cli_train
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data import pipeline
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.resilience import (PREEMPTED_EXIT_CODE, ChaosMonkey,
                                      Preempted, install_chaos)
from p2p_tpu_torch.train.checkpoint import CheckpointManager
from p2p_tpu_torch.train.loop import Trainer, save_trainer_ckpt

SIZE = 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  n_train=4, n_test=2, size=SIZE, seed=5)


def _cfg():
    cfg = get_preset("reference")
    return cfg.replace(
        name="tiny",
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=2),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, nepoch=2, epoch_save=1,
                                  log_every=100, mixed_precision=False))


def _everything(state):
    """Every tensor and count of a train state, by name."""
    out = {"step": torch.tensor(state.step),
           "lr_scale": torch.tensor(state.lr_scale)}
    for name in ("net_g", "net_d", "net_c"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}/{k}"] = v.clone()
    for name in ("opt_g", "opt_d", "opt_c"):
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


class _StopAfter:
    """A stand-in guard that asks to stop at an exact step boundary."""

    def __init__(self, n_steps):
        self.calls = 0
        self.n = n_steps
        self.signum = signal.SIGTERM

    def should_stop(self):
        self.calls += 1
        return self.calls >= self.n


def _record_train_reads(mp, reads):
    """Append the train split's item indices to ``reads``, in the order
    the loaders read them."""
    orig = pipeline.PairedImageDataset.__getitem__

    def recording(self, idx):
        if os.path.basename(os.path.dirname(self.a_dir)) == "train":
            reads.append(int(idx))
        return orig(self, idx)

    mp.setattr(pipeline.PairedImageDataset, "__getitem__", recording)


@pytest.fixture
def train_reads(monkeypatch):
    reads = []
    _record_train_reads(monkeypatch, reads)
    return reads


@pytest.fixture(scope="module")
def uninterrupted(root, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("a"))
    reads = []
    with pytest.MonkeyPatch.context() as mp:
        _record_train_reads(mp, reads)
        tr = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
        tr.fit()
    return _everything(tr.state), reads


def _records(work, name="tiny"):
    with open(os.path.join(work, f"metrics_{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_preempt_at_step_6_resumes_bitwise(root, tmp_path, uninterrupted,
                                           train_reads):
    state_a, reads_a = uninterrupted
    work = str(tmp_path / "b")
    tr = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    tr.preempt = _StopAfter(6)
    with pytest.raises(Preempted) as pi:
        tr.fit()
    assert pi.value.step == 6 and pi.value.signum == signal.SIGTERM
    assert tr.ckpt.all_steps() == [4, 6]
    aux = tr.ckpt.restore_aux(6)
    assert (aux["batches_done"], aux["epoch"], aux["samples_seen"],
            aux["epoch_samples_done"]) == (2, 2, 6, 2)
    pre = [r for r in _records(work) if r["kind"] == "preempt"]
    assert [(r["step"], r["epoch"], r["signum"]) for r in pre] \
        == [(6, 2, signal.SIGTERM)]
    # the interrupted run read the uninterrupted run's first 6 samples
    # (the trainer's construction reads none under f32)
    assert train_reads == reads_a[:6]
    del train_reads[:]

    tr2 = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    assert tr2.maybe_resume()
    assert (tr2.epoch, tr2._resume_skip_samples, tr2.state.step) \
        == (2, 2, 6)
    tr2.fit()
    assert train_reads == reads_a[6:] and len(reads_a) == 8
    _assert_bitwise(_everything(tr2.state), state_a)
    recs = _records(work)
    assert [(r["step"], r["epoch"], r["batches_done"]) for r in recs
            if r["kind"] == "resume"] == [(6, 2, 2)]
    assert [r["epoch"] for r in recs if r["kind"] == "epoch"] == [1, 2]


def _cli(root, work, *extra):
    return cli_train.main([
        "--preset", "reference", "--data_root", root, "--workdir", work,
        "--device", "cpu", "--image_size", str(SIZE), "--ngf", "8",
        "--ndf", "8", "--n_blocks", "1", "--lambda_vgg", "0",
        "--nepoch", "2", "--epochsave", "1", "--log_every", "100",
        *extra])


def _ckpt(work):
    return CheckpointManager(os.path.join(work, "checkpoint", "facades",
                                          "reference"))


def test_elastic_chaos_through_the_cli_exits_75_then_resumes(root,
                                                            tmp_path,
                                                            capsys):
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    assert _cli(root, whole) == 0
    install_chaos(ChaosMonkey.from_spec("elastic@6"))
    assert _cli(root, cut) == PREEMPTED_EXIT_CODE == 75
    assert "preempted: checkpoint saved at step 6" in capsys.readouterr().out
    assert _ckpt(cut).all_steps() == [4, 6]
    assert _cli(root, cut) == 0
    assert "resumed at epoch 2 (step 6)" in capsys.readouterr().out
    a, b = _ckpt(whole), _ckpt(cut)
    assert a.all_steps() == [4, 8] and b.all_steps() == [4, 6, 8]
    assert not a.verify(8) and not b.verify(8)
    # every tensor of the last checkpoint bitwise: the manifests' CRC32s
    # over each tensor's bytes, with shapes and dtypes
    files = []
    for m in (a, b):
        with open(os.path.join(m.step_dir(8), "manifest.json")) as f:
            files.append({k: v["tensors"]
                          for k, v in json.load(f)["files"].items()})
    assert files[0] == files[1]


def test_sidecar_keys_are_the_jax_sidecars(root, tmp_path, monkeypatch):
    monkeypatch.setenv("P2P_TPU_NO_GRAIN", "1")
    saved = {}
    stub_ckpt = types.SimpleNamespace(
        save=lambda step, state, wait=False: None,
        save_aux=lambda step, payload: saved.update(payload))
    jcfg = jax_preset("reference")
    stand_in = types.SimpleNamespace(
        state=types.SimpleNamespace(step=6), ckpt=stub_ckpt, epoch=2,
        steps_per_epoch=4, cfg=jcfg, mesh=None, _samples_seen=6,
        _epoch_samples_done=2, _seed_jitter=0, _base_lr_scale=1.0)
    assert jax_loop.save_trainer_ckpt(stand_in) == 6

    cfg = get_preset("reference")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, ngf=8, ndf=8,
                                                n_blocks=1),
                      loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
                      data=dataclasses.replace(cfg.data, image_size=SIZE))
    tr = Trainer(cfg, data_root=root, workdir=str(tmp_path), device="cpu")
    tr.state.step, tr.epoch = 6, 2
    tr._samples_seen, tr._epoch_samples_done = 6, 2
    assert save_trainer_ckpt(tr) == 6
    port = tr.ckpt.restore_aux(6)
    assert port.keys() == saved.keys()
    assert port["topology"].keys() == saved["topology"].keys()
    # the same values where the run is the same; JAX counts its 8 CPU
    # test devices, the port its one
    want = {**saved, "topology": {**saved["topology"], "device_count": 1}}
    assert port == want
    assert port["topology"]["loader"] == "fallback"


def _preempted_run(root, work):
    tr = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    tr.preempt = _StopAfter(6)
    with pytest.raises(Preempted):
        tr.fit()
    return tr


def test_corrupt_sidecar_and_corrupt_step_degrade_counted(root, tmp_path):
    work = str(tmp_path / "w")
    tr = _preempted_run(root, work)
    aux_path = os.path.join(tr.ckpt.directory + ".aux", "6.json")
    with open(aux_path, "w") as f:
        f.write('{"step": 6, "epoch": 2, "batch')        # torn
    tr2 = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    assert tr2.maybe_resume()
    assert tr2.obs.total("aux_corrupt_total") == 1
    assert tr2.obs.total("aux_compat_total") == 1
    # the step counter's position: epoch 2 after 2 batches
    assert (tr2.epoch, tr2._resume_skip_samples, tr2._samples_seen) \
        == (2, 2, 6)
    kinds = [r["kind"] for r in _records(work)]
    assert "aux_corrupt" in kinds and "aux_compat" in kinds

    # a corrupt newest step: the resume falls back to step 4, an epoch
    # boundary, and the position follows it
    with open(os.path.join(tr.ckpt.step_dir(6), "net_g.pt"), "r+b") as f:
        f.seek(200)
        byte = f.read(1)
        f.seek(200)
        f.write(bytes([byte[0] ^ 0xFF]))
    tr3 = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    assert tr3.maybe_resume()
    assert tr3.ckpt.last_restored_step == 4 and tr3.state.step == 4
    assert (tr3.epoch, tr3._resume_skip_samples, tr3._host_step) \
        == (2, 0, 4)
    assert tr3.obs.total("ckpt_corrupt_total") == 1
    bad = [r for r in _records(work) if r["kind"] == "ckpt_corrupt"]
    assert bad and bad[-1]["step"] == 6
    # an explicitly named corrupt step raises, unless it may fall back
    from p2p_tpu_torch.train.checkpoint import CheckpointCorrupt
    with pytest.raises(CheckpointCorrupt):
        tr3.ckpt.restore(tr3.state, step=6)
    assert tr3.ckpt.restore(tr3.state, step=6, fallback=True)[0] == 4


def test_lr_base_and_seed_jitter_come_back(root, tmp_path):
    work = str(tmp_path / "w")
    tr = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    # mid-epoch, mid-cooldown, after a rollback
    tr.state.step, tr.epoch = 6, 2
    tr._seed_jitter, tr._base_lr_scale = 1000003, 0.5
    tr.state.lr_scale = 0.05
    tr._samples_seen, tr._epoch_samples_done = 6, 2
    save_trainer_ckpt(tr)
    tr2 = Trainer(_cfg(), data_root=root, workdir=work, device="cpu")
    assert tr2.maybe_resume()
    assert tr2.state.lr_scale == 0.5 and tr2._base_lr_scale == 0.5
    assert tr2._seed_jitter == 1000003
    assert tr2.current_lr() == pytest.approx(0.5 * 2e-4)
    assert (tr2.epoch, tr2._resume_skip_samples) == (2, 2)


def _wait_for(proc, needle, deadline):
    lines = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            continue
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if needle in line:
            return lines
    raise AssertionError(f"no {needle!r} in {lines}")


def test_sigterm_subprocess_exits_75_and_relaunch_resumes(root, tmp_path):
    work = str(tmp_path / "w")
    args = ["--preset", "reference", "--data_root", root, "--workdir", work,
            "--device", "cpu", "--image_size", str(SIZE), "--ngf", "8",
            "--ndf", "8", "--n_blocks", "1", "--lambda_vgg", "0",
            "--nepoch", "1", "--epochsave", "1", "--log_every", "1"]
    env = {k: v for k, v in os.environ.items() if k != "P2P_CHAOS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "p2p_tpu_torch.cli.train", *args],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_for(proc, "kind=train", time.monotonic() + 120)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == PREEMPTED_EXIT_CODE, out
    ck = _ckpt(work)
    step = ck.latest_step()
    aux = ck.restore_aux(step)
    assert aux is not None and aux["step"] == step < 4
    pre = [r for r in _records(work, "reference") if r["kind"] == "preempt"]
    assert [r["signum"] for r in pre] == [signal.SIGTERM]
    assert _cli(root, work, "--nepoch", "1") == 0
    assert ck.all_steps()[-1] == 4
    epochs = [r["epoch"] for r in _records(work, "reference")
              if r["kind"] == "epoch"]
    assert epochs == [1]
    assert np.isfinite([r["loss_g"] for r in _records(work, "reference")
                        if r["kind"] == "epoch"]).all()
