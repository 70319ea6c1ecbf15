"""TP × int8 (ops/int8.py ``_TPInt8Conv``, parallel/tp.py), the
``tp_amax_recalibrate`` migration with ``--recalibrate_steps``, and the
restore under wider int8 coverage, on the CPU in f32 with 2 gloo ranks on
``data=1, model=2`` (one spawn for the file, tests/torch_pp_worker.py
``tp_int8_checks``).

- An ``out`` conv (C_out sharded, the slice kept) and an ``in`` conv (C_in
  sharded) of each form (dynamic and stored scales), forward in training
  mode and the backward of ``sum(y·g)``: the output, dx, dw, the bias
  gradient and the stored amax bitwise the one-rank int8 conv's (the
  scales maxed and the int32 accumulators summed over the model group).
- One f32 step of ``pix2pixhd`` with its residual blocks (and D's inner
  convs) int8 under delayed scales, ngf 8, 64×128, ``tp_min_ch`` 8, from
  one start: the losses and every stored amax against the port's
  one-rank step, D's updated tensors within their band, and every
  replicated tensor (the amax included) the same bits on both ranks.
- ``cli.train --mesh 1,1,1,2`` of it preempted by ``elastic@3`` and
  relaunched on one process with ``--recalibrate_steps 2``: a ``migrate``
  through ``tp_amax_recalibrate`` (``tests/test_elastic.py:698-750``),
  every amax restored bitwise from the checkpoint and held there for two
  steps, then one ``recalibrate_done`` record.
- ``tests/test_int8.py:835-895`` on the port: a ``facades_int8`` step saved
  under narrower int8 coverage restores under wider coverage with the
  new scales initialized and listed, everything else bitwise from disk;
  the trainer's ``quant_init`` record and frozen window follow it.
"""

import contextlib
import dataclasses
import io
import json
import types
from unittest import mock

import numpy as np
import pytest
import torch

import torch_pp_worker as PW
from p2p_tpu_torch.cli import train
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.resilience import reshape
from p2p_tpu_torch.train import loop
from p2p_tpu_torch.train.checkpoint import CheckpointManager
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.train.step import build_train_step
from torch_dp_worker import spawn_start
from torch_step_parity import update_distance

H, W = 64, 128
# bands, by ROADMAP's band rule from this file's runs: the losses, whose
# differences from the one-rank step stayed below 1e-6 relative here (the
# int8 convs are exact; the plain sharded convs' partial sums add in
# another order); the amax after the step up to 2.22e-7 relative; D's
# updated tensors' distance over their update 1.99e-4 (Adam's first step
# moves a weight by ±lr whatever its gradient's size)
LOSS_RTOL = 1e-6
AMAX_RTOL = 1e-6
DIST_BAND = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hd8():
    cfg = get_preset("pix2pixhd")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  int8=True, int8_delayed=True,
                                  int8_generator=True),
        data=dataclasses.replace(cfg.data, image_size=H, image_width=W),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        train=dataclasses.replace(cfg.train, mixed_precision=False),
        parallel=dataclasses.replace(cfg.parallel, tp_min_ch=8))


def _batch(seed=31):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
            for k in ("input", "target")}


def cli_args(data, work):
    return ["--preset", "pix2pixhd", "--data_root", data, "--workdir", work,
            "--device", "cpu", "--image_size", str(H), "--image_width",
            str(W), "--ngf", "8", "--ndf", "8", "--n_blocks", "1",
            "--lambda_vgg", "0", "--batch_size", "1", "--test_batch_size",
            "1", "--nepoch", "2", "--epochsave", "1", "--tp_min_ch", "8",
            "--int8", "--int8_generator", "--int8_delayed"]


def _amax(state):
    return {f"{n}/{k}": v.clone() for n in ("net_g", "net_d")
            for k, v in getattr(state, n).state_dict().items()
            if k.endswith("amax_x")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_int8")
    cfg = _hd8()
    batch = _batch()
    start = create_train_state(cfg, 0, device="cpu", sample_batch=batch)
    data = make_synthetic_dataset(str(tmp / "data"), n_train=4, n_test=2,
                                  size=H)
    torch.save({"cfg": cfg, "batch": batch,
                "net_g": start.net_g.state_dict(),
                "net_d": start.net_d.state_dict(),
                "cli": cli_args(data, str(tmp / "pre"))}, tmp / "hd8.pt")
    join = spawn_start("tp_int8_checks", 2, str(tmp), str(tmp),
                       module="torch_pp_worker")
    # the one-rank references: each conv, the step
    convs = {}
    for role in ("out", "in"):
        for delayed in (False, True):
            conv, x, g = PW.conv_case(role, delayed)
            x = x.clone().requires_grad_()
            y = conv.train()(x)
            (y * g).sum().backward()
            convs[role, delayed] = {
                "y": y.detach(), "dx": x.grad, "dw": conv.weight.grad,
                "db": conv.bias.grad,
                "amax": conv.amax_x.clone() if delayed else None}
    start_nets = PW._nets(start)
    state, m = build_train_step(cfg)(start, batch)
    ranks = join(600)
    # the relaunch at model=1 with the frozen window, watched step by step
    held = []
    hold = loop.hold_frozen_quant

    def watching(tr):
        hold(tr)
        held.append((tr._host_step, _amax(tr.state)))

    restored = {}
    resume = loop.Trainer.maybe_resume

    def resuming(self):
        ok = resume(self)
        restored.update(_amax(self.state))
        return ok

    out = io.StringIO()
    with mock.patch.object(loop, "hold_frozen_quant", watching), \
            mock.patch.object(loop.Trainer, "maybe_resume", resuming), \
            contextlib.redirect_stdout(out):
        rc = train.main(cli_args(data, str(tmp / "pre"))
                        + ["--recalibrate_steps", "2"])
    records = [json.loads(line) for line in
               open(tmp / "pre" / "metrics_pix2pixhd.jsonl")]
    ckpt = CheckpointManager(str(tmp / "pre" / "checkpoint" / "cityscapes_hd"
                                 / "pix2pixhd"))
    return dict(ranks=ranks, convs=convs, one={k: float(v) for k, v in
                                               m.items()},
                one_nets=PW._nets(state), start=start_nets,
                one_amax=_amax(state), rc=rc, records=records, held=held,
                restored=restored, ckpt=ckpt)


@pytest.mark.parametrize("role,delayed", [("out", False), ("out", True),
                                          ("in", False), ("in", True)])
def test_sharded_int8_conv_is_the_one_rank_conv_bitwise(runs, role,
                                                        delayed):
    want = runs["convs"][role, delayed]
    got = [r["convs"][role, delayed] for r in runs["ranks"]]
    cat = lambda k, d: torch.cat([g[k] for g in got], d)  # noqa: E731
    if role == "out":
        assert torch.equal(cat("y", 1), want["y"])
        assert torch.equal(cat("dw", 0), want["dw"])
        assert torch.equal(cat("db", 0), want["db"])
        for g in got:
            assert torch.equal(g["dx"], want["dx"])
    else:
        assert torch.equal(cat("dx", 1), want["dx"])
        assert torch.equal(cat("dw", 1), want["dw"])
        for g in got:
            assert torch.equal(g["y"], want["y"])
            assert torch.equal(g["db"], want["db"])
    if delayed:
        for g in got:
            assert torch.equal(g["amax"], want["amax"])
    # the int32 sums: in the forward of an in conv, the backward of an out
    calls = got[0]["calls"]
    assert calls["int32_sum"] == 1 and calls["amax_max"] >= 1


def test_tp_int8_step_matches_the_one_rank_step(runs):
    r0, r1 = runs["ranks"]
    assert ("net_g", "QuantConv") in r0["kinds"]
    assert ("net_d", "SpectralConv") in r0["kinds"]
    for k, v in runs["one"].items():
        assert abs(r0["metrics"][k] - v) <= LOSS_RTOL * abs(v), k
    assert r0["metrics"] == r1["metrics"]
    amax = {k: v for k, v in r0["nets"].items() if k.endswith("amax_x")}
    assert set(amax) == set(runs["one_amax"]) and len(amax) >= 4
    for k, v in runs["one_amax"].items():
        assert abs(float(amax[k]) - float(v)) <= AMAX_RTOL * float(v), k
    assert update_distance(r0["nets"], runs["one_nets"], runs["start"],
                           "net_d/") <= DIST_BAND
    # every replicated tensor (the stored scales among them) alike
    assert r0["replicated"] == r1["replicated"]
    assert any(k.endswith("amax_x") for k in r0["replicated"])


def test_tp_width_migration_under_int8_holds_the_window(runs):
    assert [r["elastic_rc"] for r in runs["ranks"]] == [75, 75]
    assert runs["rc"] == 0
    recs = runs["records"]
    el = [r for r in recs if r["kind"] == "elastic_resume"]
    assert len(el) == 1 and el[0]["decision"] == "migrate"
    assert el[0]["chain"] == ["tp_amax_recalibrate"]
    rec = [r for r in recs if r["kind"] == "tp_amax_recalibrate"]
    assert len(rec) == 1
    assert (rec[0]["width_saved"], rec[0]["width_current"],
            rec[0]["recalibrate_steps"]) == (2, 1, 2)
    assert rec[0]["amax_leaves"] == len(runs["restored"])
    # every amax restored bitwise from the step the ranks saved
    saved = runs["ckpt"].read(PW.ELASTIC_STOP, ["net_g", "net_d"])
    for k, v in runs["restored"].items():
        net, name = k.split("/", 1)
        assert torch.equal(v, saved[net][name]), k
    # held for the window's two steps, then released
    held = runs["held"]
    assert [s for s, _ in held[:2]] == [PW.ELASTIC_STOP + 1,
                                        PW.ELASTIC_STOP + 2]
    for _, amax in held[:2]:
        assert all(torch.equal(amax[k], v)
                   for k, v in runs["restored"].items())
    done = [r for r in recs if r["kind"] == "recalibrate_done"]
    assert [r["step"] for r in done] == [PW.ELASTIC_STOP + 2]


# ------------------------------------------------ wider int8 coverage
def _tiny(**mk):
    base = get_preset("facades_int8")
    return base.replace(
        model=dataclasses.replace(base.model, ngf=8, ndf=8,
                                  use_compression_net=True, **mk),
        data=dataclasses.replace(base.data, image_size=16, batch_size=2))


def _u8(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
            for k in ("input", "target")}


def test_restore_under_wider_int8_coverage(tmp_path):
    old = create_train_state(_tiny(), 0, device="cpu", sample_batch=_u8())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, old, 1)
    new = create_train_state(
        _tiny(int8_generator=True, int8_head=True, int8_compression=True),
        1, device="cpu", sample_batch=_u8())
    init = {f"{n}/{k}": v.clone() for n in ("net_g", "net_d", "net_c")
            for k, v in getattr(new, n).state_dict().items()
            if k.endswith("amax_x")}
    m2 = CheckpointManager(str(tmp_path / "ckpt"))
    m2.restore(new)
    grafted = m2.last_restore_initialized_quant
    # JAX's count (tests/test_int8.py:873): 3 encoder + head + 3 net_c
    assert len(grafted) == 7, grafted
    assert sum(p.startswith("net_c/") for p in grafted) == 3
    assert sum(p.startswith("net_d/") for p in grafted) == 1
    for p in grafted:
        net, k = p.split("/", 1)
        assert torch.equal(getattr(new, net).state_dict()[k], init[p])
    for net in ("net_g", "net_d", "net_c"):
        a, b = getattr(old, net).state_dict(), getattr(new, net).state_dict()
        for k, v in a.items():
            assert torch.equal(v, b[k]), (net, k)
    m3 = CheckpointManager(str(tmp_path / "ckpt"))
    m3.restore(old)
    assert m3.last_restore_initialized_quant == []
    # the trainer's record and frozen window after such a restore
    logged = []
    tr = types.SimpleNamespace(
        ckpt=m2, state=new, _host_step=7,
        cfg=types.SimpleNamespace(train=types.SimpleNamespace(
            recalibrate_steps=2)),
        logger=types.SimpleNamespace(log=lambda r, force: logged.append(r)))
    reshape.arm_quant_init_warmup(tr, 7)
    frozen = {k: v.clone() for k, v in reshape._amax_buffers(new).items()}
    for _ in range(3):
        with torch.no_grad():
            for b in reshape._amax_buffers(new).values():
                b.mul_(2.0)
        reshape.hold_frozen_quant(tr)
        tr._host_step += 1
    kinds = [r["kind"] for r in logged]
    assert kinds == ["quant_init", "recalibrate_done"]
    assert logged[0]["initialized_leaves"] == 7
    # two steps held the scales, the third let them move
    bufs = reshape._amax_buffers(new)
    assert all(torch.equal(bufs[k], 2.0 * v) for k, v in frozen.items())
