"""The port's mesh arithmetic (``p2p_tpu_torch/core/mesh.py``, the stride
sharding of ``data/pipeline.py``, the elastic transforms of
``resilience/reshape.py``) against the JAX package's pure functions, with
no process group and no spawn:

- ``parse_mesh_arg``, ``MeshSpec.resolve`` and ``classify_topology_delta``
  over the cases of ``tests/test_elastic.py:53-194``, parametrised;
- the refusal of the axes of later slices;
- ``shard_epoch_indices`` at several ``(n_proc, pid)`` against JAX's,
  with the gapless union law and the sample-granular skip;
- ``MOMENT_MIGRATION``, ``apply_batch_rebase``'s step arithmetic and
  ``rebase_step_counters`` on a real port state.

Tolerance: none; every comparison is exact.
"""

import dataclasses
import types

import numpy as np
import pytest

from p2p_tpu.core import mesh as jmesh
from p2p_tpu.data import pipeline as jpipe
from p2p_tpu.resilience import reshape as jreshape
from p2p_tpu_torch.core import mesh as tmesh
from p2p_tpu_torch.data import pipeline as tpipe
from p2p_tpu_torch.resilience import reshape as treshape


def _topo(**over):
    base = {
        "process_count": 1, "device_count": 4,
        "mesh": {"data": 4, "spatial": 1, "time": 1, "model": 1, "pipe": 1},
        "global_batch": 8, "mixed_precision": True,
        "moment_dtype": "float32", "int8_delayed": False,
    }
    base.update(over)
    return base


_MESH = {"data": 2, "spatial": 1, "time": 1, "model": 1, "pipe": 1}
CLASSIFY_CASES = [
    ({}, {}, False, False),
    ({}, {"process_count": 2}, False, False),
    ({}, {"device_count": 8}, False, False),
    ({}, {"mesh": _MESH}, False, False),
    ({}, {"mesh": {**_MESH, "spatial": 2}}, False, False),
    ({}, {"mesh": {**_MESH, "fsdp": 2}}, False, False),
    ({}, {"mixed_precision": False}, False, False),
    ({}, {"moment_dtype": "bfloat16"}, False, False),
    ({}, {"moment_dtype": "bfloat16"}, False, True),
    ({}, {"int8_delayed": True}, False, False),
    ({}, {"int8_delayed": True}, False, True),
    ({}, {"global_batch": 4}, False, False),
    ({}, {"mesh": {**_MESH, "pipe": 2}}, False, False),
    ({}, {"global_batch": 4, "moment_dtype": "bfloat16",
          "mesh": {**_MESH, "data": 1, "pipe": 2}}, False, True),
    ({}, {"mesh": {**_MESH, "model": 2}}, False, False),
    ({}, {"mesh": {**_MESH, "model": 2}}, True, False),
    ({"moment_dtype": None}, {"moment_dtype": "float32"}, False, False),
    ({"moment_dtype": "float32"}, {"moment_dtype": None}, False, False),
    (None, {}, False, False),
    ({"only": {"global_batch": 8}}, {}, False, False),
    ({"only": {"global_batch": 2}}, {}, False, False),
    ({"mesh": {}}, {"mesh": {"data": 1, "fsdp": 1, "spatial": 1}},
     False, False),
]


@pytest.mark.parametrize("saved_over,cur_over,quant,cast", CLASSIFY_CASES)
def test_classify_topology_delta_is_jax(saved_over, cur_over, quant, cast):
    if saved_over is None:
        saved = {}
    elif "only" in saved_over:
        saved = saved_over["only"]
    else:
        saved = _topo(**saved_over)
    current = _topo(**cur_over)
    want = jmesh.classify_topology_delta(saved, current, quant, cast)
    got = tmesh.classify_topology_delta(saved, current, quant, cast)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("text", [
    "data=2", "data=-1,fsdp=2", "fsdp=2", "data=4,fsdp=2,model=2",
    "2,1,1", "4,2,1", "2,1,1,2", "2,1,1,2,2", " data = 2 , spatial=2 ",
    "data=1,", "data=0", "spatial=-1", "foo=2", "data=2,data=2", "2,1",
    "1,1,1,1,1,1", "x,1,1"])
def test_parse_mesh_arg_is_jax(text):
    try:
        want = jmesh.parse_mesh_arg(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_arg(text)
        assert str(got.value) == str(e)
        return
    got = tmesh.parse_mesh_arg(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("spec,n,context", [
    (dict(data=-1), 8, ""), (dict(data=-1, spatial=2), 8, ""),
    (dict(data=-1, spatial=3), 8, ""), (dict(data=16), 8, ""),
    (dict(data=16), 8, "checkpoint was saved on 2 process(es)"),
    (dict(data=2, fsdp=2), 4, ""), (dict(data=-1, fsdp=2), 2, ""),
    (dict(data=1), 4, ""), (dict(data=-1, time=4), 1, "")])
def test_resolve_and_its_diagnostics_are_jax(spec, n, context):
    try:
        want = jmesh.MeshSpec(**spec).resolve(n, context)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec(**spec).resolve(n, context)
        assert str(got.value) == str(e)
        return
    assert tmesh.MeshSpec(**spec).resolve(n, context) == want


def test_topology_blocks_and_later_axes():
    topo = {**tmesh.mesh_topology(None), "global_batch": 8}
    assert topo == {"process_count": 1, "device_count": 1, "mesh": {},
                    "global_batch": 8}
    assert tmesh.describe_topology(topo) == jmesh.describe_topology(topo)
    tmesh.check_ported_axes(tmesh.MeshSpec(data=-1, fsdp=2))
    tmesh.check_ported_axes(tmesh.MeshSpec(data=-1, spatial=2))
    # every axis is ported (pipe with data, as JAX's gpipe_trunk shards
    # only data and pipe), and the combinations the port does not compose
    # are refused by name, pipe's with spatial, time, model and fsdp
    assert tmesh.LATER_AXES == {}
    tmesh.check_ported_axes(tmesh.MeshSpec(data=-1, time=4))
    tmesh.check_ported_axes(tmesh.MeshSpec(data=-1, model=2))
    tmesh.check_ported_axes(tmesh.MeshSpec(pipe=2))
    tmesh.check_ported_axes(tmesh.MeshSpec(data=2, pipe=4))
    assert {b for a, b in tmesh.UNCOMPOSED_AXES if a == "pipe"} == {
        "spatial", "time", "model", "fsdp"}
    for a, b in tmesh.UNCOMPOSED_AXES:
        with pytest.raises(NotImplementedError, match=f"{a}=2 and {b}=2"):
            tmesh.check_ported_axes(tmesh.MeshSpec(**{a: 2, b: 2}))
    assert tmesh.local_batch_size(8) == 8


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4])
def test_shard_epoch_indices_is_jax_and_gapless(n_proc):
    rng = np.random.default_rng(n_proc)
    for n in (12, 13, 25):
        perm = rng.permutation(n)
        for local_bs in (1, 2, 3):
            for kw in ({}, {"skip_batches": 1}, {"skip_samples": 5},
                       {"drop_remainder": False},
                       {"skip_samples": 4, "drop_remainder": False}):
                got = []
                for pid in range(n_proc):
                    want = jpipe.shard_epoch_indices(
                        perm, local_bs, n_proc=n_proc, pid=pid, **kw)
                    mine = tpipe.shard_epoch_indices(
                        perm, local_bs, n_proc=n_proc, pid=pid, **kw)
                    assert [int(i) for i in mine] == [int(i) for i in want]
                    got.append(mine)
                if kw.get("drop_remainder", True) is False:
                    continue
                # the union of local batch i is flat [S + iB, S + (i+1)B)
                b = local_bs * n_proc
                s = kw.get("skip_samples", kw.get("skip_batches", 0) * b)
                n_b = len(got[0]) // local_bs   # the loader's full batches
                assert all(len(g) // local_bs == n_b for g in got)
                for i in range(n_b):
                    union = sorted(int(v) for g in got
                                   for v in g[i * local_bs:(i + 1)
                                              * local_bs])
                    assert union == sorted(
                        int(v) for v in perm[s + i * b:s + (i + 1) * b])


def test_moment_migration_and_transform_names_are_jax():
    assert treshape.MOMENT_MIGRATION == jreshape.MOMENT_MIGRATION
    assert treshape.RESHAPE_TRANSFORMS == jreshape.RESHAPE_TRANSFORMS
    # every transform is ported: no chain is refused
    assert treshape.LATER_TRANSFORMS == {}
    for chain in (("pp_restructure",), ("batch_rebase",
                                        "tp_amax_recalibrate"),
                  ("batch_rebase", "dtype_cast")):
        treshape.check_ported_chain(chain)


class _Log:
    def log(self, *a, **k):
        pass


def _stand_in(b_new, es, ss, n_train=40):
    cfg = types.SimpleNamespace(data=types.SimpleNamespace(batch_size=b_new))
    return types.SimpleNamespace(
        cfg=cfg, steps_per_epoch=n_train // b_new, train_ds=[0] * n_train,
        _epoch_samples_done=es, _samples_seen=ss, logger=_Log(),
        state=types.SimpleNamespace(step=0))


@pytest.mark.parametrize("b_old,b_new,done,mid", [
    (8, 4, 1, 2), (4, 8, 2, 3), (6, 8, 0, 3), (8, 6, 3, 0), (2, 2, 1, 1)])
def test_apply_batch_rebase_arithmetic_is_jax(monkeypatch, b_old, b_new,
                                              done, mid):
    es, step = mid * b_old, done * (40 // b_old) + mid
    aux = {"samples_seen": step * b_old, "batches_done": mid}
    plan = treshape.ElasticPlan("migrate", ("batch_rebase",), "",
                                {"global_batch": b_old},
                                {"global_batch": b_new})
    jplan = jreshape.ElasticPlan("migrate", ("batch_rebase",), "",
                                 plan.saved, plan.current)
    seen = {}
    monkeypatch.setattr(jreshape, "rebase_step_counters",
                        lambda state, s: seen.setdefault("j", s) and state)
    jtr = _stand_in(b_new, es, step * b_old)
    want = jreshape.apply_batch_rebase(jtr, step, aux, jplan, done, mid)
    monkeypatch.setattr(treshape, "rebase_step_counters",
                        lambda state, s: seen.setdefault("t", s))
    ttr = _stand_in(b_new, es, step * b_old)
    got = treshape.apply_batch_rebase(ttr, step, aux, plan, done, mid)
    assert got == want and seen["t"] == seen["j"] == got[1]
    assert ttr._resume_skip_samples == jtr._resume_skip_samples == es


def test_rebase_step_counters_moves_every_count():
    import torch

    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    cfg = get_preset("facades")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, ngf=4, ndf=4),
                      data=dataclasses.replace(cfg.data, image_size=16),
                      optim=dataclasses.replace(cfg.optim, niter=1,
                                                niter_decay=4))
    state = create_train_state(cfg, 0, steps_per_epoch=3, device="cpu")
    for opt, sched in (state.opt_g, state.opt_d):
        for p in opt.param_groups[0]["params"]:
            p.grad = torch.zeros_like(p)
        opt.step()
        sched.step()
    treshape.rebase_step_counters(state, 7)
    assert state.step == 7
    for opt, sched in (state.opt_g, state.opt_d):
        assert {float(st["step"]) for st in opt.state.values()} == {7.0}
        assert sched.last_epoch == 7
        lr = cfg.optim.lr * sched.lr_lambdas[0](7)
        assert sched.get_last_lr() == [lr]
        assert opt.param_groups[0]["lr"] == lr


@pytest.mark.parametrize("mesh,later", [
    ("data=1,spatial=2", None),
    # the time and model axes are ported: they only need the processes
    # (the case ids are kept from when they named a later slice)
    pytest.param("data=1,time=2", None, id="data=1,time=2-13b-time"),
    pytest.param("1,1,1,2", None, id="1,1,1,2-13c"),
    # pipe is ported too: it only needs the processes
    pytest.param("data=1,pipe=2", None, id="data=1,pipe=2-13c"),
    ("data=2", None),
    ("data=x", None)])
def test_cli_refuses_meshes_it_cannot_run(mesh, later, capsys):
    """Exit 2 before any model is built: a mesh wider than this launch's
    one process (every axis is ported: it only needs the processes), or
    malformed, says so."""
    from p2p_tpu_torch.cli import train

    assert train.main(["--preset", "edges2shoes_dp", "--device", "cpu",
                       "--mesh", mesh]) == 2
    err = capsys.readouterr().err
    assert "--mesh" in err
    if later:
        assert f"slice {later}" in err
    elif mesh != "data=x":
        assert "wider than this launch" in err and "slice" not in err
