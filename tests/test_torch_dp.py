"""The port's data-parallel training (``p2p_tpu_torch/parallel/``, sync-
BatchNorm in ``ops/norm.py``, the data-parallel trainer and its elastic
relaunch) on 2 gloo ranks on the CPU, against the JAX package on one
device at the global batch and against the port's own one-rank runs.

One spawn of 2 ranks (tests/torch_dp_worker.py, one torch thread each,
no JAX) does every two-rank check; this process runs JAX (one
``create_train_state`` and one train-step compile, shared through
tests/torch_step_parity.py) and the one-rank runs. The configuration is
``edges2shoes_dp`` (the U-Net with dropout, 13 BatchNorms at full depth)
at ngf 8, ndf 8, 32² (5 levels: 7 BatchNorms), global batch 4, f32.

- sync-BatchNorm on 2 ranks (2 rows each of a (4, 8, 6, 5) input with a
  large-mean channel) against JAX's ``BatchNorm`` on the global batch:
  output, input and parameter gradients, running statistics, at
  tests/test_torch_batch_moments.py's tolerances (``BN_TOL``,
  ``AFFINE_TOL``); one #5 and one all-reduce of its sums per BatchNorm
  and step, one all-reduce of their cotangents in the backward;
- 2 steps at ``data=2`` (dropout off) from the JAX state converted by
  ``convert.py`` against 2 JAX steps on the global batch: the mean of the
  two ranks' losses within rtol 1e-4 at step 1 and 1e-3 at step 2 (f32
  sums in another order: tests/test_torch_facades_step.py's bands), the
  networks within 2·2·lr = 8e-4 absolute (Adam's first steps move a
  weight by about ±lr whatever its gradient, so a gradient near zero that
  changes sign moves 2·lr apart a step) and each tensor's distance within
  0.2 of its update's L2 norm;
- with dropout on, 2 ranks against the port's one rank at the global
  batch from the same start: the masks are the same, drawn for the global
  batch, and what differs is the order of f32 sums, so the losses agree
  within rtol 1e-5 (measured 9e-8) and each tensor's distance within 1e-3
  of its update's L2 norm; elementwise the 8e-4 bound above holds (one
  weight in 65,536 of the innermost encoder level, its gradient near
  zero, lands 2.7e-5 apart after 2 steps);
- ``fsdp=2`` (and with the parameters split) bitwise ``data=2``: metrics,
  networks and Adam's moments;
- ``cli.train`` with ``P2P_CHAOS=elastic@3`` at 2 ranks exits 75 on both;
  the relaunch on one process is a ``reshard`` whose restored state is
  bitwise the step as saved (the manifest's CRC32s), and the two runs
  read exactly the uninterrupted run's train samples, none twice, none
  missing; ``--no-elastic`` exits 2 naming the topology change;
- ``MetricsRegistry.aggregate`` over the 2 ranks equals JAX's combine of
  the two snapshots, and ``should_stop`` agrees: the rank that was not
  signalled stops at the same poll;
- without a spawn: remat "full" and "conv" on a small pix2pixHD G (the
  kernel-form norms' plain versions) give gradients and buffers bitwise
  the plain block's, with the recompute plan's #1 calls; a change of the
  Adam moment dtype on resume migrates through ``dtype_cast`` with
  ``cast_on_restore`` and exits with ``TopologyMismatch`` without it.
"""

import contextlib
import dataclasses
import io
import json
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dp_worker as W  # noqa: E402
from torch_step_parity import (FIELDS, jax_start, np_tree,  # noqa: E402
                               run_both)
from p2p_tpu.core.config import get_preset as jax_preset  # noqa: E402
from p2p_tpu.ops.norm import BatchNorm as JaxBatchNorm  # noqa: E402
from p2p_tpu_torch.cli import train  # noqa: E402
from p2p_tpu_torch.convert import (load_train_state,  # noqa: E402
                                   state_from_flax)
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from p2p_tpu_torch.train import loop  # noqa: E402
from p2p_tpu_torch.train.checkpoint import (state_fields,  # noqa: E402
                                            tensor_checksums)
from p2p_tpu_torch.train.state import create_train_state  # noqa: E402
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402

KEYS = ("loss_d", "loss_g", "g_gan", "g_l1")
STEP1_RTOL, LATER_RTOL = 1e-4, 1e-3
NET_ATOL, UPDATE_RTOL = 8e-4, 0.2
ONE_RANK_RTOL, ONE_RANK_UPDATE_RTOL = 1e-5, 1e-3
BN_TOL = dict(rtol=1e-4, atol=1e-5)
AFFINE_TOL = dict(rtol=1e-4, atol=5e-4)
BN_C, BN_HW = 8, (6, 5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn_inputs():
    """The global (x, g) of the sync-BatchNorm check (NHWC) and the flax
    variables: running mean away from 0, γ away from 1, channel 0 at mean
    40 with a spread of 1 (as tests/test_torch_batch_moments.py)."""
    rng = np.random.default_rng(11)
    shape = (W.BATCH,) + BN_HW + (BN_C,)
    mean, spread = rng.uniform(-2, 2, BN_C), rng.uniform(0.1, 3, BN_C)
    mean[0], spread[0] = 40.0, 1.0
    x = (rng.normal(size=shape) * spread + mean).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, JaxBatchNorm().init(
        jax.random.key(0), jnp.asarray(x)))
    running = np.linspace(-1, 1, BN_C).astype(np.float32)
    running[0] = 39.9
    v["batch_stats"]["BatchNorm_0"]["mean"] = running
    v["params"]["BatchNorm_0"]["scale"] = np.linspace(
        0.5, 1.5, BN_C).astype(np.float32)
    return x, g, v


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _jax_bn(x, g, v):
    def f(params, xx):
        y, upd = JaxBatchNorm().apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xx,
            mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), (dp, dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    stats = state_from_flax(jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])["BatchNorm_0"])
    grads = state_from_flax(jax.tree_util.tree_map(
        np.asarray, dp)["BatchNorm_0"])
    return np.asarray(y), np.asarray(dx), grads, stats


def _one_rank(tcfg, start_nets, batches):
    state = create_train_state(tcfg, 0, 1, None, "cpu")
    state.net_g.load_state_dict(start_nets["net_g"])
    state.net_d.load_state_dict(start_nets["net_d"])
    step = build_train_step(tcfg, None, None, 1)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, W.net_tensors(state)


@contextlib.contextmanager
def _checking_resume(seen):
    """``maybe_resume`` also records whether the restored live state is
    bitwise the step's files (their manifest's CRC32s)."""
    resume = loop.Trainer.maybe_resume

    def checked(self):
        ok = resume(self)
        step = self.ckpt.last_restored_step
        man = self.ckpt.manifest(step)
        fields = state_fields(self.state, step, self.epoch)
        seen.append(all(
            tensor_checksums(fields[n]) == man[f"{n}.pt"]["tensors"]
            for n in ("net_g", "net_d", "opt_g", "opt_d")))
        return ok

    with mock.patch.object(loop.Trainer, "maybe_resume", checked):
        yield


def _cli(args, reads=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out), \
            W.reading_train_split(reads if reads is not None else []):
        rc = train.main(args)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    jcfg = jax_preset("edges2shoes_dp")
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, ngf=8, ndf=8,
                                  use_dropout=False),
        data=dataclasses.replace(jcfg.data, image_size=W.SIZE,
                                 batch_size=W.BATCH),
        train=dataclasses.replace(jcfg.train, mixed_precision=False))
    batches = W.global_batches()
    start = jax_start(jcfg, batches[0], vgg=False)
    both = run_both(jcfg, W.small_cfg(False), batches, KEYS, start,
                    keep_states=True)
    ts = load_train_state(create_train_state(W.small_cfg(False),
                                             device="cpu"),
                          {f: np_tree(getattr(start[0], f)) for f in FIELDS})
    start_nets = {"net_g": ts.net_g.state_dict(),
                  "net_d": ts.net_d.state_dict()}
    torch.save(start_nets, os.path.join(tmp, "start.pt"))
    x, g, v = _bn_inputs()
    bn_state = state_from_flax(v["params"]["BatchNorm_0"],
                               v["batch_stats"]["BatchNorm_0"])
    torch.save({"x": _nchw(x), "g": _nchw(g), "bn": bn_state},
               os.path.join(tmp, "bn.pt"))
    data = make_synthetic_dataset(os.path.join(tmp, "data"), n_train=8,
                                  n_test=4, size=W.SIZE)
    ranks = W.spawn("dp_checks", 2, tmp, tmp)

    # the one-process runs: the relaunch of the preempted run, the same
    # relaunch with --no-elastic, and an uninterrupted run
    work = os.path.join(tmp, "work")
    strict = os.path.join(tmp, "strict")
    import shutil
    shutil.copytree(work, strict)
    resumed, seen = [], []
    with _checking_resume(seen):
        rc_resume, log = _cli(W.cli_args(data, work), resumed)
    rc_strict, strict_log = _cli(W.cli_args(data, strict) + ["--no-elastic"])
    whole = []
    rc_whole, _ = _cli(W.cli_args(data, os.path.join(tmp, "whole")), whole)
    records = [json.loads(line) for line in
               open(os.path.join(work, "metrics_edges2shoes_dp.jsonl"))]
    return dict(
        both=both, ranks=ranks, bn=_jax_bn(x, g, v), start=start_nets,
        one_rank_dropout=_one_rank(W.small_cfg(True), start_nets, batches),
        rc=(rc_resume, rc_strict, rc_whole), log=(log, strict_log),
        reads=(resumed, whole), restored_bitwise=seen, records=records)


def test_sync_batchnorm_forward_matches_jax_on_the_global_batch(runs):
    y, _, _, stats = runs["bn"]
    got = np.concatenate([r["bn"]["y"].numpy() for r in runs["ranks"]])
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), y, **AFFINE_TOL)
    for r in runs["ranks"]:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["bn"][k].numpy(),
                                       stats[k].numpy(), **BN_TOL)
        # ParallelConfig.sync_batchnorm off: each rank's own statistics
        assert r["bn"]["unsynced_is_local"]


def test_sync_batchnorm_backward_matches_jax_on_the_global_batch(runs):
    _, dx, grads, _ = runs["bn"]
    got = np.concatenate([r["bn"]["dx"].numpy() for r in runs["ranks"]])
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), dx, **BN_TOL)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["bn"]["dscale"].numpy(),
                                   grads["scale"].numpy(), **BN_TOL)
        np.testing.assert_allclose(r["bn"]["dbias"].numpy(),
                                   grads["bias"].numpy(), **BN_TOL)


def test_each_batchnorm_runs_one_moments_and_one_allreduce_a_step(runs):
    """The U-Net's training-mode BatchNorms (encoder levels 1 … nd − 2,
    decoder levels 1 … nd − 1: 7 at 32², 13 at the full 256²): one #5
    (its plain version here) each, one all-reduce of its sums each, one of
    their cotangents each in the backward."""
    from p2p_tpu_torch.models.unet import unet_levels

    nd = unet_levels(8, W.SIZE, W.SIZE)
    assert (nd, unet_levels(8, 256, 256)) == (5, 8)
    n_bn = (nd - 2) + (nd - 1)
    for r in runs["ranks"]:
        assert r["plain"]["counts"] == (n_bn, n_bn, n_bn)


def _assert_nets_close(got, want, start, atol, update_rtol):
    for k, w in want.items():
        w = w.float()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol,
                                   rtol=0, err_msg=k)
        if not k.endswith(("mean", "var")) and update_rtol is not None:
            update = float((w - start[k].float()).norm())
            assert float((got[k].float() - w).norm()) <= \
                update_rtol * update + 1e-12, k


def test_two_rank_step_matches_the_jax_step_on_the_global_batch(runs):
    jax_metrics = runs["both"]["jax"]
    ranks = [r["plain"]["metrics"] for r in runs["ranks"]]
    for i, want in enumerate(jax_metrics):
        rtol = STEP1_RTOL if i == 0 else LATER_RTOL
        for k in KEYS:
            got = np.mean([m[i][k] for m in ranks])
            assert np.isfinite(got) and got == pytest.approx(
                want[k], rel=rtol), (i, k, want[k], got)
    js, ts = runs["both"]["states"]
    got = runs["ranks"][0]["plain"]["nets"]
    for net, fields in (("net_g", ("params_g", "batch_stats_g")),
                        ("net_d", ("params_d",))):
        want = {}
        for f in fields:
            want.update(state_from_flax(np_tree(getattr(js, f)),
                                        module=getattr(ts, net)))
        _assert_nets_close({k[len(net) + 1:]: v for k, v in got.items()
                            if k.startswith(net + "/")}, want,
                           runs["start"][net], NET_ATOL, UPDATE_RTOL)


def test_two_rank_dropout_step_matches_one_rank_at_the_global_batch(runs):
    one_metrics, one_nets = runs["one_rank_dropout"]
    ranks = [r["dropout"] for r in runs["ranks"]]
    for i, want in enumerate(one_metrics):
        for k in KEYS:
            got = np.mean([r["metrics"][i][k] for r in ranks])
            assert got == pytest.approx(want[k], rel=ONE_RANK_RTOL), (i, k)
    for net in ("net_g", "net_d"):
        sel = {k[len(net) + 1:]: v for k, v in one_nets.items()
               if k.startswith(net + "/")}
        _assert_nets_close({k[len(net) + 1:]: v for k, v in
                            ranks[0]["nets"].items()
                            if k.startswith(net + "/")}, sel,
                           runs["start"][net], NET_ATOL,
                           ONE_RANK_UPDATE_RTOL)
    # the same networks on both ranks
    for k, w in ranks[0]["nets"].items():
        assert torch.equal(ranks[1]["nets"][k], w), k


@pytest.mark.parametrize("form", ["fsdp", "fsdp_params"])
def test_fsdp_is_bitwise_data_parallel(runs, form):
    for r in runs["ranks"]:
        rep, zero = r["dropout"], r[form]
        assert zero["metrics"] == rep["metrics"]
        for k, w in rep["nets"].items():
            assert torch.equal(zero["nets"][k], w), k
        for i, st in rep["opt_g"].items():
            for k, w in st.items():
                assert torch.equal(zero["opt_g"][i][k], w), (i, k)


def test_aggregate_and_preemption_poll_agree_across_ranks(runs):
    from p2p_tpu.obs.registry import combine_host_snapshots

    rows = [{"steps_total": {"value": 1.0}, "queue_depth": {"value": 10.0}},
            {"steps_total": {"value": 2.0}, "queue_depth": {"value": 20.0},
             "only_on_1": {"value": 1.0}}]
    kinds = {"steps_total": "counter", "queue_depth": "gauge",
             "only_on_1": "counter"}
    want = combine_host_snapshots(rows, kinds)
    for r in runs["ranks"]:
        assert r["aggregate"] == want
        # sync_every=2: only every second poll agrees (the JAX cadence);
        # the agreed one stops both ranks, the unsignalled one too
        assert r["polls"] == [False, True, False]


def test_remat_keeps_the_bits_and_recomputes_per_plan():
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.models.registry import define_G
    from p2p_tpu_torch.ops import instance_norm

    cfg = get_preset("pix2pixhd")
    m = dataclasses.replace(cfg.model, ngf=8, n_blocks=2)
    n_blocks = 2 + 3
    res = {}
    for mode in (False, "full", "conv"):
        torch.manual_seed(0)
        g = define_G(m, None, (64, 128), remat=mode).to(
            memory_format=torch.channels_last)
        x = torch.from_numpy(np.random.default_rng(1).normal(
            size=(2, 3, 64, 128)).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
        calls = []
        stats = instance_norm.instance_norm_stats
        with mock.patch.object(instance_norm, "instance_norm_stats",
                               lambda *a: calls.append(1) or stats(*a)):
            y = g(x)
            forward = len(calls)
            (y.float() ** 2).mean().backward()
        res[mode] = (forward, len(calls), y.detach(),
                     [p.grad for p in g.parameters()], list(g.buffers()))
    fwd = res[False][0]
    assert [res[k][1] for k in res] == [fwd, fwd + 2 * n_blocks, fwd]
    for mode in ("full", "conv"):
        assert torch.equal(res[mode][2], res[False][2])
        for a, b in zip(res[mode][3] + res[mode][4],
                        res[False][3] + res[False][4]):
            assert torch.equal(a, b)


def test_moment_dtype_change_migrates_only_with_cast_on_restore(tmp_path):
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.mesh import TopologyMismatch

    data = make_synthetic_dataset(str(tmp_path / "d"), n_train=2, n_test=1,
                                  size=32)
    cfg = get_preset("reference")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, ngf=8, ndf=8,
                                                n_blocks=1),
                      loss=dataclasses.replace(cfg.loss, lambda_vgg=0.0),
                      data=dataclasses.replace(cfg.data, image_size=32),
                      train=dataclasses.replace(cfg.train, nepoch=1,
                                                epoch_save=1))
    work = str(tmp_path / "w")
    with contextlib.redirect_stdout(io.StringIO()):
        loop.Trainer(cfg, data_root=data, workdir=work,
                     device="cpu").fit()
    bf16 = cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                 moment_dtype="bfloat16"))
    with pytest.raises(TopologyMismatch, match="--cast_on_restore"):
        loop.Trainer(bf16, data_root=data, workdir=work,
                     device="cpu").maybe_resume()
    cast = bf16.replace(train=dataclasses.replace(bf16.train,
                                                  cast_on_restore=True))
    tr = loop.Trainer(cast, data_root=data, workdir=work, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        assert tr.maybe_resume()
    moments = [st["exp_avg"] for st in tr.state.opt_g[0].state.values()]
    assert moments and {t.dtype for t in moments} == {torch.bfloat16}
    rec = [json.loads(line) for line in open(os.path.join(
        work, "metrics_reference.jsonl")) if "dtype_migration" in line]
    assert rec[-1]["moment_policy"] == "cast"
    assert rec[-1]["moment_dtype"] == [None, "bfloat16"]
    assert rec[-1]["cast_leaves"] > 0


def test_elastic_save_at_two_ranks_resumes_at_one_gapless_and_bitwise(runs):
    rc_resume, rc_strict, rc_whole = runs["rc"]
    assert [r["elastic_rc"] for r in runs["ranks"]] == [75, 75]
    assert rc_resume == 0 and rc_whole == 0
    assert runs["restored_bitwise"] == [True]
    elastic = [r for r in runs["records"] if r["kind"] == "elastic_resume"]
    assert len(elastic) == 1 and elastic[0]["decision"] == "reshard"
    assert elastic[0]["saved"]["process_count"] == 2
    assert elastic[0]["current"]["process_count"] == 1
    # epoch 1 (two steps) and epoch 2's first global batch at 2 ranks, the
    # rest of epoch 2 at one: the uninterrupted run's samples, in epochs
    resumed, whole = runs["reads"]
    before = [r["elastic_reads"] for r in runs["ranks"]]
    per_rank = W.BATCH // 2
    e1 = sorted(v for b in before for v in b[:2 * per_rank])
    e2 = sorted(v for b in before for v in b[2 * per_rank:])
    assert e1 == sorted(whole[:8]) == list(range(8))
    assert e2 == sorted(whole[8:12])
    assert sorted(resumed) == sorted(whole[12:16])
    assert sorted(e2 + resumed) == list(range(8))
    assert rc_strict == 2
    assert "elastic resume disabled" in runs["log"][1]
