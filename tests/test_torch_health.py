"""The port's training health (``p2p_tpu_torch/resilience/health.py``)
against the JAX package's, and the recovery ladder in the port's trainer
and CLI, on the CPU.

- The sentinel, the ladder and ``TrainingHealth`` of both packages are
  pure host logic, so they are fed the same seeded metric streams
  (healthy, spikes, slow drift, NaN/Inf, a skipped step's ``health_ok``
  0, the ``nan@NxM`` chaos seam, each under two health configs) and held
  EXACTLY: every status, action, ``lr_multiplier``, level, streak, the
  counters, the ``health`` records and the step of the ``DivergenceError``.
  A ``rollback`` action is answered with ``after_rollback`` on both, as
  the trainers do.
- A tiny ``reference`` (32², ngf 8, ndf 8, one block, ``lambda_vgg`` 0,
  f32, 4 train pairs) trained by the port's ``Trainer`` under
  ``nan@6x3``: skip at 6, cooldown at 7, rollback at 8 to the marked
  step 4, whose weights, buffers, optimizer and scheduler states are
  restored bitwise; the epoch after it logs ``lr`` times
  ``cooldown_factor``; the run completes.
- ``cli.train`` exits 0 after a rollback that recovers and 76 when the
  ladder is exhausted (NaN at every step from 5 on, ``--max_rollbacks
  1``: one rollback, then the give-up).
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from p2p_tpu.core.config import HealthConfig as JaxHealthConfig
from p2p_tpu.obs import MetricsRegistry as JaxRegistry
from p2p_tpu.resilience import ChaosMonkey as JaxMonkey
from p2p_tpu.resilience import install_chaos as jax_install_chaos
from p2p_tpu.resilience import health as jax_health
from p2p_tpu_torch.cli import train as cli_train
from p2p_tpu_torch.core.config import HealthConfig, get_preset
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.obs import MetricsRegistry
from p2p_tpu_torch.resilience import (DIVERGED_EXIT_CODE, ChaosMonkey,
                                      install_chaos)
from p2p_tpu_torch.resilience import health as port_health
from p2p_tpu_torch.train import loop as port_loop
from p2p_tpu_torch.train.checkpoint import CheckpointManager
from p2p_tpu_torch.train.loop import Trainer

SIZE = 32
N_STEPS = 160


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
    jax_install_chaos(None)
    yield
    install_chaos(None)
    jax_install_chaos(None)


# ------------------------------------------------------------ the streams
def _stream(kind: str, seed: int):
    """A seeded list of per-step host metrics."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(N_STEPS):
        m = {"loss_g": 4.0 * math.exp(-t / 80) + 0.05 * rng.normal(),
             "loss_d": 1.5 + 0.03 * rng.normal(),
             "loss_c": 0.6 + 0.02 * rng.normal(),
             "health_ok": 1.0}
        if kind == "drift":
            m["loss_d"] += 0.02 * t
            m["loss_c"] *= 1.0 + 0.01 * t
        elif kind == "spikes" and t > 20 and rng.random() < 0.12:
            key = ("loss_g", "loss_d", "loss_c")[rng.integers(3)]
            m[key] += float(rng.choice([-1, 1])) * rng.uniform(2.0, 40.0)
        elif kind == "nonfinite" and t > 10 and rng.random() < 0.1:
            key = ("loss_g", "loss_d")[rng.integers(2)]
            m[key] = float(rng.choice([np.nan, np.inf, -np.inf]))
        elif kind == "skipped" and t > 10 and rng.random() < 0.1:
            m["health_ok"] = 0.0
        elif kind == "grad_norms":
            m["grad_norm_g"] = 9.0 + rng.normal()
            m["grad_norm_d"] = 2.0 + 0.1 * rng.normal()
            if t > 30 and rng.random() < 0.08:
                m["grad_norm_g"] *= rng.uniform(5.0, 50.0)
        out.append(m)
    return out


class _Records:
    def __init__(self):
        self.recs = []

    def log(self, rec, force=False):
        self.recs.append(dict(rec))


HEALTH = {
    "default": {},
    "tight": dict(window=8, spike_zscore=3.0, ewma_alpha=0.3,
                  cooldown_steps=3, cooldown_factor=0.5, max_rollbacks=2,
                  reset_after=4),
}
STREAMS = ("healthy", "spikes", "drift", "nonfinite", "skipped",
           "grad_norms", "chaos")


def _walk(health_mod, cfg, stream, poison):
    """Feed ``stream`` through ``TrainingHealth``; the trace of every
    decision, the records and the give-up step."""
    reg = JaxRegistry() if health_mod is jax_health else MetricsRegistry()
    log = _Records()
    th = health_mod.TrainingHealth(cfg, registry=reg, logger=log)
    trace, err = [], None
    for i, m in enumerate(stream):
        step = i + 1
        try:
            action = th.observe(step, poison(step, dict(m)))
        except health_mod.DivergenceError as e:
            err = (e.step, e.rollbacks, str(e))
            break
        lad = th.ladder
        trace.append((step, action, th.lr_multiplier, lad.level,
                      lad.rollbacks, lad.healthy_streak,
                      lad._cooldown_left, th.rollback_pending,
                      th.sentinel.last_spike[0]))
        if action == "rollback":
            th.after_rollback(step, max(step - 4, 0))
    return trace, err, log.recs, th.summary()


@pytest.mark.parametrize("hname", sorted(HEALTH))
@pytest.mark.parametrize("kind", STREAMS)
def test_health_decides_as_the_jax_package(kind, hname):
    kw = HEALTH[hname]
    stream = _stream(kind, seed=STREAMS.index(kind) + 7)
    if kind == "chaos":
        jax_install_chaos(JaxMonkey.from_spec("nan@50x3",
                                              registry=JaxRegistry()))
        install_chaos(ChaosMonkey.from_spec("nan@50x3",
                                            registry=MetricsRegistry()))
    jax_run = _walk(jax_health, JaxHealthConfig(**kw), stream,
                    jax_health.poison_nan_observation)
    port_run = _walk(port_health, HealthConfig(**kw), stream,
                     port_health.poison_nan_observation)
    assert port_run[0] == jax_run[0]          # every decision, step by step
    assert port_run[1] == jax_run[1]          # the give-up, if any
    assert port_run[2] == jax_run[2]          # the health records
    assert port_run[3] == jax_run[3]          # the counters
    if kind == "healthy" and hname == "default":
        assert all(a is None for _, a, *_ in port_run[0])
    if kind in ("nonfinite", "chaos", "skipped"):
        assert any(a is not None for _, a, *_ in port_run[0])
    if kind == "chaos":
        acts = {s: a for s, a, *_ in port_run[0] if a is not None}
        if hname == "default":
            assert acts == {50: "skip", 51: "cooldown", 52: "rollback"}


def test_sentinel_and_ladder_alone_match():
    """The two lower layers without the facade, on one spiky stream with
    NaNs: every classification, every ladder action."""
    kw = HEALTH["tight"]
    stream = _stream("spikes", 3) + _stream("nonfinite", 4)
    outs = []
    for mod, reg in ((jax_health, JaxRegistry()),
                     (port_health, MetricsRegistry())):
        s = mod.DivergenceSentinel(window=kw["window"],
                                   spike_zscore=kw["spike_zscore"],
                                   ewma_alpha=kw["ewma_alpha"])
        lad = mod.RecoveryLadder(cooldown_steps=5, cooldown_factor=0.25,
                                 max_rollbacks=10, reset_after=6,
                                 registry=reg)
        got = []
        for i, m in enumerate(stream):
            status = s.classify(m)
            try:
                act = lad.on_status(status, i)
            except mod.DivergenceError as e:
                got.append(("giveup", e.step, e.rollbacks))
                break
            if act == "rollback":
                lad.note_rollback_done(i, 0)
            got.append((status, act, s.last_spike, lad.lr_multiplier))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][-1][0] == "giveup"
    assert port_health.DIVERGED_EXIT_CODE == jax_health.DIVERGED_EXIT_CODE


# ------------------------------------------------------- the port's ladder
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  n_train=4, n_test=2, size=SIZE, seed=3)


def _cfg(**health):
    cfg = get_preset("reference")
    return cfg.replace(
        name="tiny",
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=2),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, nepoch=2, epoch_save=1,
                                  log_every=100, mixed_precision=False),
        health=dataclasses.replace(cfg.health, **health))


def _records(workdir, name="tiny"):
    with open(os.path.join(workdir, f"metrics_{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state_fields(state):
    out = {f"net_g/{k}": v.clone() for k, v in
           state.net_g.state_dict().items()}
    out.update({f"net_d/{k}": v.clone() for k, v in
                state.net_d.state_dict().items()})
    out.update({f"net_c/{k}": v.clone() for k, v in
                state.net_c.state_dict().items()})
    for name in ("opt_g", "opt_d", "opt_c"):
        opt, sched = getattr(state, name)
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}/{i}/{k}"] = torch.as_tensor(v).clone()
        out[f"{name}/sched"] = torch.tensor(sched.last_epoch)
    return out


def test_rollback_restores_the_marked_step_bitwise(root, tmp_path,
                                                   monkeypatch):
    install_chaos(ChaosMonkey.from_spec("nan@6x3"))
    work = str(tmp_path / "w")
    tr = Trainer(_cfg(cooldown_steps=50, max_rollbacks=2), data_root=root,
                 workdir=work, device="cpu")
    snaps = []
    rollback = port_loop.perform_rollback

    def watched(t):
        rollback(t)
        snaps.append((t.ckpt.last_restored_step, _state_fields(t.state),
                      t.state.step, t.state.lr_scale))

    monkeypatch.setattr(port_loop, "perform_rollback", watched)
    hist = tr.fit()
    assert [h["epoch"] for h in hist] == [1, 2] and tr.state.step == 8
    (target, fields, step, lr_scale), = snaps
    assert target == 4 == step and tr.ckpt.last_good_step() == 8
    # the marked step as saved: every tensor bitwise
    saved = Trainer(_cfg(), data_root=root, workdir=str(tmp_path / "x"),
                    device="cpu")
    saved.ckpt = CheckpointManager(tr.ckpt.directory)
    saved.ckpt.restore(saved.state, step=4)
    want = _state_fields(saved.state)
    assert fields.keys() == want.keys()
    bad = [k for k in want if not torch.equal(fields[k], want[k])]
    assert bad == []
    assert lr_scale == pytest.approx(0.1)       # the post-rollback cooldown
    recs = _records(work)
    acts = [r.get("action") for r in recs if r["kind"] == "health"]
    assert acts == ["skip", "cooldown", "rollback", None]
    events = [r["event"] for r in recs if r["kind"] == "health"]
    assert events[-1] == "rollback_done"
    rb, = [r for r in recs if r["kind"] == "rollback"]
    assert (rb["step"], rb["target_step"], rb["epoch"], rb["rollbacks"]) \
        == (8, 4, 2, 1)
    epochs = [r for r in recs if r["kind"] == "epoch"]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert epochs[1]["lr"] == pytest.approx(0.1 * epochs[0]["lr"], rel=1e-6)
    summary, = [r for r in recs if r["kind"] == "health_summary"]
    assert summary == {**summary, "health_skips_total": 1,
                       "health_cooldowns_total": 1,
                       "health_rollbacks_total": 1, "rollbacks": 1}
    # the rerun of epoch 2 shuffles on the perturbed seed
    assert tr._seed_jitter == 1000003


def _cli(root, work, *extra):
    return cli_train.main([
        "--preset", "reference", "--data_root", root, "--workdir", work,
        "--device", "cpu", "--image_size", str(SIZE), "--ngf", "8",
        "--ndf", "8", "--n_blocks", "1", "--lambda_vgg", "0",
        "--nepoch", "2", "--epochsave", "1", "--log_every", "100",
        *extra])


def test_cli_recovers_with_exit_0_and_gives_up_with_exit_76(root, tmp_path,
                                                            capsys):
    install_chaos(ChaosMonkey.from_spec("nan@6x3"))
    assert _cli(root, str(tmp_path / "ok"), "--cooldown_steps", "2",
                "--max_rollbacks", "1") == 0
    recs = _records(str(tmp_path / "ok"), "reference")
    assert [r["target_step"] for r in recs if r["kind"] == "rollback"] \
        == [4]
    capsys.readouterr()
    install_chaos(ChaosMonkey.from_spec("nan@5x1000"))
    work = str(tmp_path / "give")
    assert _cli(root, work, "--max_rollbacks", "1") \
        == DIVERGED_EXIT_CODE == 76
    out = capsys.readouterr().out
    assert "diverged: training diverged at step 7 after 1 rollback(s)" \
        in out and "(exit 76)" in out
    recs = _records(work, "reference")
    acts = [r.get("action") for r in recs if r["kind"] == "health"
            and r.get("action")]
    # step 8 ran before step 7's verdict was read (one step late), so the
    # epoch's drain reads it and asks for the rollback again, as the JAX
    # loop's does; then 5, 6 and 7 of the rerun give up
    assert acts == ["skip", "cooldown", "rollback", "rollback", "skip",
                    "cooldown", "giveup"]
    assert [r["kind"] for r in recs][-1] == "health_summary"
    assert CheckpointManager(os.path.join(
        work, "checkpoint", "facades", "reference")).all_steps() == [4]
