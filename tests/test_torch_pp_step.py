"""The pipelined GAN step (train/step.py ``build_pp_train_step``), the
pipe-width migration and the trainer on a pipe mesh, on the CPU in f32
with 4 gloo ranks on ``data=2, pipe=2`` (one spawn for the file,
tests/torch_pp_worker.py ``step_checks``).

- One step of ``tests/test_pp.py``'s ``_pp_gan_cfg`` (``reference`` at
  ngf 8, ndf 8, 4 instance-norm blocks, a 2-scale D, 32², global batch 4
  in 2 microbatches a data slot) from one JAX state carried across,
  against JAX's ``build_pp_train_step`` on 4 devices and JAX's
  unpipelined ``build_train_step`` (the losses), and against the port's
  one-rank step (the losses, and every updated tensor, the stage blocks
  merged back: their distance over their update); every rank ends with
  the same networks. The overlapped schedule's step is the serial one's
  bit for bit.
- The topology classification of pipe- and model-width deltas
  (``tests/test_elastic.py:87-128``), ``cli.train --mesh data=2,pipe=2``
  (the trainer runs flat, the pipe peers reading the same samples)
  preempted by ``elastic@3`` and relaunched on one process: a
  ``migrate`` through ``pp_restructure`` whose steps and samples continue
  the uninterrupted run's without a gap; and a state split at 2 stages,
  saved, then restored into a state split at 3 (and a flat one), bitwise
  the saved state after a merge, Adam moments included.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_tpu.core.config import get_preset as jax_preset
from p2p_tpu.core.mesh import MeshSpec as JMeshSpec, make_mesh
from p2p_tpu.parallel.dp import (replicate_state as jax_replicate,
                                 shard_batch as jax_shard)
from p2p_tpu.parallel.pp import pp_split_state as jax_pp_split
from p2p_tpu.train.step import (build_pp_train_step as jax_build_pp,
                                build_train_step as jax_build)
from p2p_tpu_torch.cli import train
from p2p_tpu_torch.core.config import get_preset
from p2p_tpu_torch.core.mesh import classify_topology_delta
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.parallel.pp import (pp_full, pp_merge_state,
                                       pp_split_state, pp_width_of)
from p2p_tpu_torch.train.checkpoint import CheckpointManager
from p2p_tpu_torch.train.state import create_train_state
from torch_dp_worker import spawn_start
from torch_spatial_worker import reading_train_split
from torch_step_parity import INIT_COMPILE, jax_start, run_port

SIZE, BATCH, N_MICRO = 32, 4, 2
KEYS = ("loss_g", "loss_d", "loss_c", "g_gan", "g_feat", "g_tv")
# bands, by ROADMAP's band rule from this file's runs: the losses from
# JAX's steps within the one-device steps' band (1e-4, tests/
# test_torch_train_step.py; measured 1.36e-6 from the unpipelined step),
# from the port's one-rank step 1.19e-7 relative; the updated tensors'
# distance from the one-rank step's over their update up to 7.13e-5 over
# runs (G's k9 stem: Adam's first step moves a weight by ±lr whatever
# its gradient's size)
JAX_RTOL = 1e-4
ONE_RANK_RTOL = 5e-7
DIST_BAND = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gan_cfg(get, overlap=False):
    cfg = get("reference")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, n_blocks=4,
                                  num_D=2, n_layers_D=2, norm="instance"),
        loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
        data=dataclasses.replace(cfg.data, batch_size=BATCH,
                                 image_size=SIZE),
        train=dataclasses.replace(cfg.train, mixed_precision=False),
        parallel=dataclasses.replace(cfg.parallel, pp_overlap=overlap))


def _batch():
    rng = np.random.default_rng(1)
    return {k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("input", "target")}


def cli_args(data, work):
    return ["--preset", "reference", "--data_root", data, "--workdir", work,
            "--device", "cpu", "--image_size", str(SIZE), "--ngf", "8",
            "--ndf", "8", "--n_blocks", "2", "--lambda_vgg", "0",
            "--batch_size", str(BATCH), "--test_batch_size", "2",
            "--nepoch", "2", "--epochsave", "1"]


def _cli(args, reads):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out), \
            reading_train_split(reads):
        rc = train.main(args)
    return rc, out.getvalue()


def _nets(state):
    return {f"{n}/{k}": v.detach().clone() for n in ("net_g", "net_d")
            for k, v in getattr(state, n).state_dict().items()}


def _distance(a, b, start):
    """The largest distance of two states' tensors over the update ``b``
    made from ``start``."""
    worst = 0.0
    for k, v in b.items():
        upd = float((v - start[k]).norm())
        if v.is_floating_point() and upd > 0:
            worst = max(worst, float((a[k] - v).norm()) / upd)
    return worst


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("pp_step")
    jcfg, tcfg = _gan_cfg(jax_preset), _gan_cfg(get_preset)
    batch = _batch()
    start = jax_start(jcfg, batch, vgg=False)
    _, _, t0 = run_port(tcfg, [], KEYS, start)
    data = make_synthetic_dataset(str(tmp / "data"), n_train=8, n_test=2,
                                  size=SIZE)
    torch.save({"cfgs": {"serial": tcfg,
                         "overlap": _gan_cfg(get_preset, True)},
                "net_g": t0.net_g.state_dict(),
                "net_d": t0.net_d.state_dict(),
                "net_c": t0.net_c.state_dict(), "batch": batch,
                "n_micro": N_MICRO,
                "cli": cli_args(data, str(tmp / "pre"))}, tmp / "step.pt")
    # the ranks run while this process computes the references
    join = spawn_start("step_checks", 4, str(tmp), str(tmp),
                       module="torch_pp_worker")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = jax.tree_util.tree_map(jnp.array, start[0])
    _, jm = jax.jit(jax_build(jcfg, None, 1, None, jit=False)).lower(
        js, jb).compile(compiler_options=INIT_COMPILE)(js, jb)
    mesh = make_mesh(JMeshSpec(data=2, pipe=2), devices=devices8[:4])
    ps = jax_pp_split(jax_replicate(jax.tree_util.tree_map(jnp.array,
                                                           start[0]), mesh),
                      jcfg, mesh)
    sb = jax_shard(jb, mesh)
    pstep = jax.jit(jax_build_pp(jcfg, mesh, N_MICRO, jit=False))
    _, jpm = pstep.lower(ps, sb).compile(compiler_options=INIT_COMPILE)(
        ps, sb)
    one, _, t1 = run_port(tcfg, [batch], KEYS, start)
    # the one-process relaunch of the preempted pipe-mesh run, and an
    # uninterrupted run
    ranks = join(600)
    resumed, whole = [], []
    rc_resume, log = _cli(cli_args(data, str(tmp / "pre")), resumed)
    rc_whole, _ = _cli(cli_args(data, str(tmp / "whole")), whole)
    records = [json.loads(line) for line in
               open(tmp / "pre" / "metrics_reference.jsonl")]
    return dict(ranks=ranks, jax={k: float(jm[k]) for k in KEYS},
                jax_pp={k: float(jpm[k]) for k in KEYS}, one=one[0],
                one_nets=_nets(t1), start=_nets(t0), rc=(rc_resume, rc_whole),
                log=log, reads=(resumed, whole), records=records)


def test_pp_step_matches_jax_and_the_one_rank_step(runs):
    got = runs["ranks"][0]["serial"]
    for k in KEYS:
        m = got["metrics"][k]
        for ref in (runs["jax_pp"], runs["jax"]):
            assert abs(m - ref[k]) <= JAX_RTOL * abs(ref[k]), k
        assert abs(m - runs["one"][k]) <= ONE_RANK_RTOL * abs(
            runs["one"][k]), k
    # every tensor, the stage blocks merged back in place
    assert _distance(got["nets"], runs["one_nets"], runs["start"]) \
        <= DIST_BAND
    for r in runs["ranks"][1:]:
        assert r["serial"]["metrics"] == got["metrics"]
        assert all(torch.equal(v, got["nets"][k])
                   for k, v in r["serial"]["nets"].items())


def test_pp_overlap_step_is_the_serial_step_bitwise(runs):
    for r in runs["ranks"]:
        assert r["overlap"]["metrics"] == r["serial"]["metrics"]
        assert all(torch.equal(v, r["serial"]["nets"][k])
                   for k, v in r["overlap"]["nets"].items())


_MESH = {"data": 2, "spatial": 1, "time": 1, "model": 1, "pipe": 1}


def _topo(**kw):
    base = {"process_count": 2, "device_count": 2, "mesh": dict(_MESH),
            "global_batch": 8, "mixed_precision": True,
            "moment_dtype": None, "int8_delayed": False, "pp_stages": 1}
    base.update(kw)
    return base


@pytest.mark.parametrize("new,quant,kind,chain", [
    (dict(mesh={**_MESH, "data": 1, "pipe": 2}), False, "migrate",
     ("pp_restructure",)),
    (dict(mesh={**_MESH, "model": 2, "data": 1}), True, "migrate",
     ("tp_amax_recalibrate",)),
    (dict(mesh={**_MESH, "model": 2, "data": 1}), False, "reshard", ()),
    (dict(global_batch=4, mesh={**_MESH, "data": 1, "pipe": 2}), False,
     "migrate", ("batch_rebase", "pp_restructure")),
])
def test_pipe_and_model_width_deltas_classify_as_jax(new, quant, kind,
                                                     chain):
    from p2p_tpu.core.mesh import classify_topology_delta as jax_classify

    mine = classify_topology_delta(_topo(), _topo(**new),
                                   has_quant_state=quant)
    theirs = jax_classify(_topo(), _topo(**new), has_quant_state=quant)
    assert (mine.kind, mine.chain) == (theirs.kind, theirs.chain) == (
        kind, chain)


def test_pipe_cli_run_migrates_to_one_process_without_gaps(runs):
    """``--mesh data=2,pipe=2`` at 4 ranks: the trainer warns and runs
    flat, pipe peers reading the same samples; ``elastic@3`` stops every
    rank with 75; one process resumes it through ``pp_restructure``
    (``pp_stages`` 1 on both sides: the trainer's state is flat), and the
    samples of the two launches are the uninterrupted run's."""
    ranks = runs["ranks"]
    assert [r["elastic_rc"] for r in ranks] == [75] * 4
    reads = [r["elastic_reads"] for r in ranks]
    assert reads[0] == reads[1] and reads[2] == reads[3]
    assert reads[0] != reads[2]
    rc_resume, rc_whole = runs["rc"]
    assert rc_resume == 0 and rc_whole == 0
    recs = runs["records"]
    el = [r for r in recs if r["kind"] == "elastic_resume"]
    assert len(el) == 1 and el[0]["decision"] == "migrate"
    assert "pp_restructure" in el[0]["chain"]
    assert el[0]["saved"]["mesh"]["pipe"] == 2
    assert el[0]["saved"]["pp_stages"] == 1
    pp = [r for r in recs if r["kind"] == "pp_restructure"]
    assert pp and (pp[0]["stages_saved"], pp[0]["stages_current"]) == (1, 1)
    # 2 steps an epoch: epoch 1 and the first of epoch 2 at 4 ranks
    resumed, whole = runs["reads"]
    per_slot = BATCH // 2
    before = reads[0] + reads[2]
    assert sorted(before) == sorted(whole[:12])
    assert sorted(resumed) == sorted(whole[12:16])
    assert sorted(v for v in reads[0][2 * per_slot:] + reads[2][
        2 * per_slot:] + resumed) == list(range(8))
    assert [r["epoch"] for r in recs if r["kind"] == "epoch"] == [1, 2]


def _filled(state):
    """Distinctive Adam state on every parameter of G."""
    opt = state.opt_g[0]
    for i, p in enumerate(state.net_g.parameters()):
        opt.state[p] = {"step": torch.tensor(5.0),
                        "exp_avg": torch.full_like(p, 0.5 + i),
                        "exp_avg_sq": torch.full_like(p, 1.5 + i)}
    return state


def _flat_tensors(state):
    out = {f"g/{k}": v.clone() for k, v in state.net_g.state_dict().items()}
    for k, p in state.net_g.named_parameters():
        for m, t in state.opt_g[0].state[p].items():
            out[f"opt/{k}/{m}"] = t.clone()
    return out


@pytest.mark.parametrize("width", [1, 3])
def test_split_state_saved_and_restored_at_another_width_bitwise(
        tmp_path, width):
    cfg = _gan_cfg(get_preset).replace(model=dataclasses.replace(
        get_preset("reference").model, ngf=8, ndf=8, n_blocks=6, num_D=2,
        n_layers_D=2, norm="instance"))
    saved = _filled(create_train_state(cfg, 0, device="cpu"))
    want = _flat_tensors(saved)
    pp_split_state(saved, cfg, None, n_stages=2, init_opt=False)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with pp_full(saved, cfg):
        mgr.save(7, saved, 1)
    assert pp_width_of(saved) == 2
    live = create_train_state(cfg, 1, device="cpu")
    if width > 1:
        pp_split_state(live, cfg, None, n_stages=width)
    with pp_full(live, cfg):
        CheckpointManager(str(tmp_path / "ckpt")).restore(live)
    assert pp_width_of(live) == width and live.step == 7
    pp_merge_state(live, cfg)
    got = _flat_tensors(live)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
