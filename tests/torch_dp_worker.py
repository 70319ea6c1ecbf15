"""Ranks of the port's data-parallel CPU tests (tests/test_torch_dp.py):
spawned processes that form a gloo group over localhost, one torch thread
each, and import no JAX.

:func:`spawn` starts ``world`` ranks of one function of this module, each
of which writes what it returns to ``<out>/<rank>.pt``; the parent reads
them back. :func:`dp_checks` is every two-rank check of the test file in
one spawn: the sync-BatchNorm forward and backward on each rank's rows,
the registry's cross-process aggregate and the agreed preemption poll,
2 steps of ``edges2shoes_dp`` at ``data=2`` without and with dropout,
the same with ``fsdp=2`` (and the parameters split), the #5 launches and
sync all-reduces a step, and an ``elastic@3`` preemption of ``cli.train``
at two ranks.
"""

import contextlib
import dataclasses
import importlib
import os
import socket
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZE = 32
BATCH = 4
STEPS = 2
ELASTIC_STOP = 3


def small_cfg(dropout: bool):
    """``edges2shoes_dp`` at ngf 8, ndf 8, 32², global batch 4, f32."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("edges2shoes_dp")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8,
                                  use_dropout=dropout),
        data=dataclasses.replace(cfg.data, image_size=SIZE,
                                 batch_size=BATCH),
        train=dataclasses.replace(cfg.train, mixed_precision=False))


def global_batches(n: int = STEPS):
    """The global uint8 NHWC batches every run takes, made with numpy."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        out.append({k: rng.integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                    dtype=np.uint8)
                    for k in ("input", "target")})
    return out


def cli_args(data: str, work: str):
    return ["--preset", "edges2shoes_dp", "--data_root", data, "--workdir",
            work, "--device", "cpu", "--image_size", str(SIZE), "--ngf",
            "8", "--ndf", "8", "--batch_size", str(BATCH),
            "--test_batch_size", "2", "--nepoch", "2", "--epochsave", "1"]


@contextlib.contextmanager
def reading_train_split(reads):
    """For the duration, every train-split item read appends its index to
    ``reads``."""
    from p2p_tpu_torch.data.pipeline import PairedImageDataset

    getitem = PairedImageDataset.__getitem__

    def reading(self, idx):
        if os.path.basename(os.path.dirname(self.a_dir)) == "train":
            reads.append(int(idx))
        return getitem(self, idx)

    with mock.patch.object(PairedImageDataset, "__getitem__", reading):
        yield


def start_state(cfg, start_path: str):
    """A fresh port state with the networks of ``start_path`` (the JAX
    start converted by the parent)."""
    from p2p_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, 0, 1, None, "cpu")
    saved = torch.load(start_path, weights_only=True)
    state.net_g.load_state_dict(saved["net_g"])
    state.net_d.load_state_dict(saved["net_d"])
    return state


def net_tensors(state):
    return {f"{n}/{k}": v.detach().clone().contiguous()
            for n in ("net_g", "net_d")
            for k, v in getattr(state, n).state_dict().items()}


def run_steps(cfg, mesh, start_path: str, fsdp_params: bool = False):
    """``STEPS`` parallel steps from the start: each step's metrics (this
    rank's), the final networks and G's optimizer state (one-device form),
    and the #5 launches and sync all-reduces of the first step."""
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda import batch_moments
    from p2p_tpu_torch.parallel import (full_params, make_parallel_train_step,
                                        place_state, shard_batch)

    state = start_state(cfg, start_path)
    place_state(state, mesh, fsdp_params)
    step = make_parallel_train_step(cfg, mesh, None, None, 1)
    metrics, counts = [], None
    calls = {"moments": 0}
    plain = batch_moments.batch_moments_plain

    def counting(xc):
        calls["moments"] += 1
        return plain(xc)

    for i, b in enumerate(global_batches()):
        a0 = norm.sync_moments.allreduces
        b0 = norm.sync_moments.backward_allreduces
        with mock.patch.object(batch_moments, "batch_moments_plain",
                               counting):
            state, m = step(state, shard_batch(b, mesh))
        if counts is None:
            counts = (calls["moments"], norm.sync_moments.allreduces - a0,
                      norm.sync_moments.backward_allreduces - b0)
        metrics.append({k: float(v) for k, v in m.items()})
    with full_params(state):
        nets = net_tensors(state)
    opt_g = state.opt_g[0].state_dict()
    return {"metrics": metrics, "nets": nets, "counts": counts,
            "opt_g": {i: {k: v.clone() for k, v in st.items()
                          if torch.is_tensor(v)}
                      for i, st in opt_g["state"].items()}}


def sync_bn(bn_path: str, rank: int, world: int):
    """The sync-BatchNorm forward and backward on this rank's rows of the
    global (x, g) in ``bn_path``: y rows, dx rows, the all-reduced
    parameter gradients and the running statistics; and whether with
    ``sync_batchnorm`` off the forward is the rank's own BatchNorm."""
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec, mesh_context
    from p2p_tpu_torch.ops.norm import BatchNorm, sync_batchnorm

    saved = torch.load(bn_path, weights_only=True)
    x, g = saved["x"], saved["g"]
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(saved["bn"])
    xt = x[rows].contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    mesh = Mesh(MeshSpec(data=-1))
    with mesh_context(mesh):
        y = bn(xt)
        (y * g[rows]).sum().backward()
    grads = torch.stack([bn.scale.grad, bn.bias.grad])
    dist.all_reduce(grads)
    out = {"y": y.detach().clone(), "dx": xt.grad.clone(),
           "dscale": grads[0], "dbias": grads[1],
           "mean": bn.mean.clone(), "var": bn.var.clone()}
    local = []
    for synced in (False, None):
        bn.load_state_dict(saved["bn"])
        with torch.no_grad(), mesh_context(mesh if synced is False
                                           else None), \
                sync_batchnorm(bool(synced)):
            local.append(bn(x[rows].contiguous(
                memory_format=torch.channels_last)))
    out["unsynced_is_local"] = bool(torch.equal(*local))
    return out


def dp_checks(rank: int, world: int, tmp: str):
    """Every two-rank check of tests/test_torch_dp.py (module docstring)."""
    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec
    from p2p_tpu_torch.obs.registry import MetricsRegistry
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos
    from p2p_tpu_torch.resilience.preempt import PreemptionGuard

    start = os.path.join(tmp, "start.pt")
    out = {"bn": sync_bn(os.path.join(tmp, "bn.pt"), rank, world)}
    # the registry's cross-process combine and the agreed preemption poll
    reg = MetricsRegistry()
    reg.counter("steps_total").inc(rank + 1)
    reg.gauge("queue_depth").set(10.0 * (rank + 1))
    if rank == 1:
        reg.counter("only_on_1").inc()
    out["aggregate"] = reg.aggregate()
    guard = PreemptionGuard(sync_every=2)
    if rank == 1:
        guard.request()
    out["polls"] = [guard.should_stop() for _ in range(3)]
    data2 = Mesh(MeshSpec(data=-1))
    fsdp2 = Mesh(MeshSpec(data=1, fsdp=2))
    out["plain"] = run_steps(small_cfg(False), data2, start)
    out["dropout"] = run_steps(small_cfg(True), data2, start)
    out["fsdp"] = run_steps(small_cfg(True), fsdp2, start)
    out["fsdp_params"] = run_steps(small_cfg(True), fsdp2, start,
                                   fsdp_params=True)
    reads = []
    install_chaos(ChaosMonkey.from_spec(f"elastic@{ELASTIC_STOP}"))
    try:
        with reading_train_split(reads), \
                contextlib.redirect_stdout(open(os.devnull, "w")):
            out["elastic_rc"] = train.main(
                cli_args(os.path.join(tmp, "data"),
                         os.path.join(tmp, "work")) + ["--mesh", "data=-1"])
    finally:
        install_chaos(None)
    out["elastic_reads"] = reads
    return out


def _entry(rank: int, world: int, port: int, fn_name: str, args, out: str,
           module: str = None):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        fns = (vars(importlib.import_module(module)) if module
               else globals())
        res = fns[fn_name](rank, world, *args)
        torch.save(res, os.path.join(out, f"{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn_name: str, world: int, out: str, *args, timeout: float = 240,
          module: str = None):
    """Run ``fn_name(rank, world, *args)`` (a function of this module, or
    of the test-directory module named ``module``) on ``world`` gloo
    ranks; their results in rank order."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, fn_name, args, out, module))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"ranks exited {codes} (alive: {len(alive)})")
    return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
            for r in range(world)]
