"""The port's checkpoints (``p2p_tpu_torch/train/checkpoint.py``), port
only: tiny ``reference`` (Adam, and ``AdamLP`` with bf16 moments) and
``facades_int8`` (delayed-int8 ``amax_x`` buffers) states after two train
steps on the CPU.

- save then restore into a state built from another seed is bitwise for
  every parameter and buffer (BatchNorm statistics, spectral ``u``,
  ``amax_x``), every optimizer tensor (in its dtype) and every scheduler
  field, and gives back the step and epoch;
- one step after the restore equals one step without it, bitwise;
- restored parameters and moments keep channels_last;
- a flipped byte in the newest step falls back to the one before, a bad
  tensor CRC too, and ``CheckpointCorrupt`` is raised when no step is
  intact; a named step does not fall back;
- the G + net_c restore reads no D or optimizer file (it works with them
  deleted);
- a save that fails midway leaves no step and no temporary directory;
  ``max_to_keep`` keeps the newest steps.

Tolerance: none (bitwise).
"""

import copy
import dataclasses
import json
import os
import shutil
import zlib
from unittest import mock

import pytest
import torch

from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.data.synthetic import synthetic_batch
from p2p_tpu_torch.models.registry import define_C, define_G
from p2p_tpu_torch.train.checkpoint import CheckpointCorrupt, \
    CheckpointManager
from p2p_tpu_torch.train.state import create_train_state
from p2p_tpu_torch.train.step import build_train_step

SIZE = 32


def _cfg(kind):
    if kind == "int8":
        cfg = get_preset("facades_int8")
        return cfg.replace(
            model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
            data=dataclasses.replace(cfg.data, image_size=SIZE),
            train=dataclasses.replace(cfg.train, mixed_precision=False))
    cfg = get_preset("reference")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=1,
                                  num_D=2),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        train=dataclasses.replace(cfg.train, mixed_precision=False))
    if kind == "adamlp":
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, moment_dtype="bfloat16"))
    return cfg


def _batches(n, seed=0):
    b = synthetic_batch(n, SIZE, seed=seed, dtype="uint8")
    return [{k: v[i:i + 1] for k, v in b.items()} for i in range(n)]


def _trained(kind, seed=0, steps=2):
    cfg = _cfg(kind)
    batches = _batches(steps + 1)
    state = create_train_state(cfg, seed, steps_per_epoch=2, device="cpu",
                               sample_batch=batches[0])
    step = build_train_step(cfg)
    for b in batches[:steps]:
        state, _ = step(state, b)
    return cfg, state, step, batches[steps]


def _tensors(state):
    """Every tensor of the state: parameters and buffers, optimizer
    tensors, by a readable name."""
    out = {}
    for name in ("net_g", "net_d", "net_c"):
        net = getattr(state, name)
        if net is not None:
            for k, v in net.state_dict().items():
                out[f"{name}.{k}"] = v
    for name in ("opt_g", "opt_d", "opt_c"):
        opt = getattr(state, name)
        if opt is None:
            continue
        for i, st in opt[0].state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.{i}.{k}"] = v
    return out


def _schedulers(state):
    return [None if o is None else
            {k: v for k, v in o[1].state_dict().items()
             if k != "lr_lambdas"}
            for o in (state.opt_g, state.opt_d, state.opt_c)]


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        x, y = ta[k], tb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x, y), k
        else:
            assert x == y, k
    assert _schedulers(a) == _schedulers(b)
    assert a.step == b.step


@pytest.fixture(scope="module", params=["reference", "adamlp", "int8"])
def trained(request):
    return request.param, _trained(request.param)


def test_save_then_restore_is_bitwise(trained, tmp_path):
    kind, (cfg, state, _, _) = trained
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.step, state, epoch=1)
    assert not mgr.save(state.step, state, epoch=1)   # already on disk
    fresh = create_train_state(cfg, 99, steps_per_epoch=2, device="cpu",
                               sample_batch=_batches(1)[0])
    assert not torch.equal(fresh.net_g.state_dict()[
        next(iter(fresh.net_g.state_dict()))], state.net_g.state_dict()[
        next(iter(state.net_g.state_dict()))])
    assert mgr.restore(fresh) == (2, 1)
    _assert_same(fresh, state)
    if kind == "adamlp":
        moments = [v for k, v in _tensors(fresh).items()
                   if k.endswith("exp_avg")]
        assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    if kind == "int8":
        amax = [k for k in _tensors(fresh) if k.endswith("amax_x")]
        assert len(amax) == 3


def test_a_step_after_restore_equals_a_step_without_it(trained, tmp_path):
    kind, (cfg, state, step, batch) = trained
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, epoch=1)
    other = create_train_state(cfg, 7, steps_per_epoch=2, device="cpu",
                               sample_batch=_batches(1)[0])
    mgr.restore(other)
    # the module-scoped state continues on a deep copy
    cont, m_cont = step(copy.deepcopy(state), batch)
    rest, m_rest = build_train_step(cfg)(other, batch)
    for k in m_cont:
        assert torch.equal(m_cont[k], m_rest[k]), k
    _assert_same(rest, cont)


def test_restored_tensors_keep_channels_last(trained, tmp_path):
    _, (cfg, state, _, _) = trained
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, epoch=1)
    fresh = create_train_state(cfg, 3, steps_per_epoch=2, device="cpu",
                               sample_batch=_batches(1)[0])
    mgr.restore(fresh)
    n4 = 0
    for name, t in _tensors(fresh).items():
        if isinstance(t, torch.Tensor) and t.dim() == 4 and \
                min(t.shape[1:]) > 1 and not name.endswith(".kernel"):
            assert t.is_contiguous(memory_format=torch.channels_last), name
            n4 += 1
    assert n4 > 10


def _flip_byte(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))


def test_a_corrupt_newest_step_falls_back_then_raises(tmp_path):
    cfg, state, step, batch = _trained("reference")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, epoch=1)
    state, _ = step(state, batch)
    mgr.save(state.step, state, epoch=2)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    _flip_byte(os.path.join(mgr.step_dir(3), "net_g.pt"))
    assert mgr.verify(3) and not mgr.verify(2)
    fresh = create_train_state(cfg, 1, steps_per_epoch=2, device="cpu")
    assert mgr.restore(fresh) == (2, 1)
    assert mgr.last_restored_step == 2 and fresh.step == 2
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(fresh, step=3)            # a named step: no fallback
    # a tensor whose bytes no longer match its recorded CRC, in a file
    # whose own CRC was rewritten to match
    d2 = mgr.step_dir(2)
    sd = torch.load(os.path.join(d2, "opt_d.pt"), weights_only=True)
    first = next(iter(sd["optimizer"]["state"].values()))
    first["exp_avg"].add_(1.0)
    torch.save(sd, os.path.join(d2, "opt_d.pt"))
    man = json.load(open(os.path.join(d2, "manifest.json")))
    man["files"]["opt_d.pt"]["crc32"] = zlib.crc32(
        open(os.path.join(d2, "opt_d.pt"), "rb").read())
    json.dump(man, open(os.path.join(d2, "manifest.json"), "w"))
    assert any("tensors" in p for p in mgr.verify(2))
    with pytest.raises(CheckpointCorrupt) as e:
        mgr.restore(fresh)
    assert e.value.tried == [3, 2]
    with pytest.raises(FileNotFoundError):
        mgr.restore(fresh, step=7)


def test_nets_restore_reads_no_d_or_optimizer_file(tmp_path):
    cfg, state, _, _ = _trained("reference")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, epoch=1)
    for name in ("net_d", "opt_g", "opt_d", "opt_c"):
        os.remove(os.path.join(mgr.step_dir(2), name + ".pt"))
    g = define_G(cfg.model, image_hw=cfg.image_hw)
    c = define_C(cfg.model)
    assert mgr.restore_nets(g, c) == 2
    for net, want in ((g, state.net_g), (c, state.net_c)):
        for k, v in want.state_dict().items():
            assert torch.equal(net.state_dict()[k], v), k
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(create_train_state(cfg, 1, device="cpu"))


def test_a_failed_save_leaves_nothing_and_max_to_keep_prunes(tmp_path):
    _, state, step, batch = _trained("reference")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    real_save = torch.save
    calls = []

    def failing(obj, f, *a, **kw):
        calls.append(1)
        if len(calls) >= 3:
            raise OSError("disk full")
        return real_save(obj, f, *a, **kw)

    # a write that keeps failing exhausts the save's retries (CKPT_POLICY:
    # 4 tries) and raises; no try leaves a step or a temporary directory
    with mock.patch.object(torch, "save", failing):
        with pytest.raises(OSError):
            mgr.save(state.step, state, epoch=1)
    assert len(calls) == 2 + 4
    assert mgr.all_steps() == [] and os.listdir(mgr.directory) == []
    # a transient failure is retried and the step lands whole
    calls.clear()

    def flaky(obj, f, *a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("blip")
        return real_save(obj, f, *a, **kw)

    with mock.patch.object(torch, "save", flaky):
        mgr.save(state.step, state, epoch=1)
    assert mgr.all_steps() == [state.step] and not mgr.verify(state.step)
    shutil.rmtree(mgr.step_dir(state.step))
    for epoch in (1, 2, 3):
        state, _ = step(state, batch)
        mgr.save(state.step, state, epoch=epoch)
    assert mgr.all_steps() == [4, 5]
