"""Ranks of the pipeline-parallel and TP × int8 CPU tests
(tests/test_torch_pp.py, tests/test_torch_pp_step.py,
tests/test_torch_tp_int8.py), spawned by ``tests/torch_dp_worker.spawn(...,
module="torch_pp_worker")``: gloo over localhost, one torch thread a rank,
no JAX.

- :func:`pp_checks` (3 ranks, ``data=1, pipe=3``): the pipelined generator
  forward of the parent's cases, serial and overlapped, with the trunk
  input's and every parameter's gradient of ``sum(y²)`` where asked and
  the int8 trunk's amax proposals; ``DataParallel.sync_grads`` of a split
  state with each rank's gradients set to its index + 1; a merge that
  gathers the stages.
- :func:`step_checks` (4 ranks, ``data=2, pipe=2``): one f32 PP GAN step
  from the parent's start, serial and overlapped (metrics, the updated
  networks merged back flat), and ``cli.train --mesh data=2,pipe=2`` (the
  trainer runs flat, the pipe ranks as replicas) preempted by
  ``elastic@3``.
- :func:`tp_int8_checks` (2 ranks, ``data=1, model=2``): an ``out`` and an
  ``in`` int8 conv of each form, forward and backward; one f32 step of the
  parent's int8 ``pix2pixhd``; ``cli.train --mesh 1,1,1,2`` of it under
  delayed int8, preempted by ``elastic@3``.
"""

import contextlib
import os
import types

import torch

ELASTIC_STOP = 3


def _mesh(**spec):
    from p2p_tpu_torch.core.mesh import Mesh, MeshSpec

    return Mesh(MeshSpec(**spec))


def split_generator(cfg, state_dict, mesh):
    """A generator of ``cfg`` with ``state_dict``, split over ``mesh``'s
    pipe axis: ``(net_g, stage stack)``."""
    from p2p_tpu_torch.models.registry import define_G
    from p2p_tpu_torch.parallel.pp import pp_split_state

    g = define_G(cfg.model, image_hw=cfg.image_hw)
    g.load_state_dict(state_dict)
    g = g.to(memory_format=torch.channels_last)
    st = types.SimpleNamespace(net_g=g, opt_g=None, pp_stages=None,
                               opt_s=None)
    pp_split_state(st, cfg, mesh)
    return st


def stage_names(stack):
    """Every parameter of ``stack`` under its name in the flat generator,
    and every stored int8 scale's module name, in module order."""
    from p2p_tpu_torch.ops.int8 import QuantScale

    params, quants = {}, []
    for name, block in zip(stack.held(), stack.blocks):
        for k, p in block.named_parameters():
            params[f"{name}.{k}"] = p
        for k, m in block.named_modules():
            if isinstance(m, QuantScale) and m.delayed:
                quants.append(f"{name}.{k}.amax_x" if k else
                              f"{name}.amax_x")
    return params, quants


def forward_case(case, mesh):
    """The pipelined forward of ``case`` on ``mesh``, serial and
    overlapped: the output, the int8 proposals, the gradients."""
    from p2p_tpu_torch.parallel.pp import (pp_generator_forward, pp_stats,
                                           reset_pp_stats, start_proposals,
                                           take_proposals)

    out = {}
    for overlap in (False, True):
        st = split_generator(case["cfg"], case["net_g"], mesh)
        st.net_g.eval()
        st.pp_stages.eval()
        params, quants = stage_names(st.pp_stages)
        x = case["x_mb"].clone().requires_grad_(case["grad"])
        if quants:
            start_proposals(st.pp_stages)
        reset_pp_stats()
        y = pp_generator_forward(st.net_g, st.pp_stages, x, mesh, overlap)
        res = {"y": y.detach().clone()}
        if quants:
            res["quant"] = dict(zip(quants,
                                    take_proposals(st.pp_stages, mesh)))
        if case["grad"]:
            (y.float() ** 2).sum().backward()
            res["grads"] = {k: p.grad.clone()
                            for k, p in st.net_g.named_parameters()}
            res["grads"].update({k: p.grad.clone()
                                 for k, p in params.items()})
            res["gx"] = x.grad.clone()
        res["stats"] = {k: dict(v) for k, v in pp_stats.items()}
        out[overlap] = res
    return out


def sync_check(cfg, state_dict, mesh):
    """``DataParallel.sync_grads`` of a split generator's ``opt_g`` and
    ``opt_s`` with every gradient set to this rank's index + 1: each
    parameter's values after."""
    from p2p_tpu_torch.parallel.dp import DataParallel
    from p2p_tpu_torch.train.state import make_optimizers

    st = split_generator(cfg, state_dict, mesh)
    opt_g, opt_s = make_optimizers(cfg, [st.net_g, st.pp_stages], 1)
    dp = DataParallel(mesh)
    params, _ = stage_names(st.pp_stages)
    named = {**dict(st.net_g.named_parameters()), **params}
    for p in named.values():
        p.grad = torch.full_like(p, float(mesh.pipe_rank + 1))
    dp.sync_grads(opt_g)
    dp.sync_grads(opt_s)
    return {k: sorted(set(p.grad.flatten().tolist()))
            for k, p in named.items()}


def named_flat(cfg):
    """The parameter names of the flat generator of ``cfg``."""
    from p2p_tpu_torch.models.registry import define_G

    return [k for k, _ in define_G(cfg.model, image_hw=cfg.image_hw)
            .named_parameters()]


def merge_check(cfg, state_dict, mesh):
    """Split over ``mesh`` with live Adam moments, then merge (gathering
    the other stages): the flat generator and its moments by name."""
    from p2p_tpu_torch.parallel.pp import pp_merge_state
    from p2p_tpu_torch.train.state import make_optimizers

    st = split_generator(cfg, state_dict, mesh)
    st.opt_g, st.opt_s = make_optimizers(cfg, [st.net_g, st.pp_stages], 1)
    params, _ = stage_names(st.pp_stages)
    named = {**dict(st.net_g.named_parameters()), **params}
    flat = sorted(named_flat(cfg))
    for k, p in named.items():
        i = flat.index(k)
        opt = st.opt_s[0] if k in params else st.opt_g[0]
        opt.state[p] = {"step": torch.tensor(3.0),
                        "exp_avg": torch.full_like(p, i + 0.25),
                        "exp_avg_sq": torch.full_like(p, i + 0.5)}
    pp_merge_state(st, cfg, mesh=mesh)
    opt = st.opt_g[0]
    return {"net_g": {k: v.clone() for k, v in st.net_g.state_dict().items()},
            "moments": {k: (float(opt.state[p]["exp_avg"].flatten()[0]),
                            float(opt.state[p]["exp_avg_sq"].flatten()[0]))
                        for k, p in st.net_g.named_parameters()}}


def pp_checks(rank: int, world: int, tmp: str):
    """Every 3-rank check of tests/test_torch_pp.py (module docstring)."""
    saved = torch.load(os.path.join(tmp, "pp.pt"), weights_only=False)
    mesh = _mesh(data=1, pipe=3)
    out = {"fwd": {name: forward_case(case, mesh)
                   for name, case in saved["cases"].items()}}
    sync = saved["cases"]["instance"]
    out["sync"] = sync_check(sync["cfg"], sync["net_g"], mesh)
    out["merge"] = merge_check(sync["cfg"], sync["net_g"], mesh)
    out["shift"] = shift_check(mesh)
    return out


def shift_check(mesh):
    """A ring shift of a channels_last activation by each route: what this
    rank received (rank i − 1's) and whether it kept the layout the
    kernels take."""
    from p2p_tpu_torch.parallel.halo import ring_of, shift_start

    ring = ring_of(mesh.group("pipe"))
    x = torch.arange(2 * 6 * 4 * 5, dtype=torch.float32).reshape(
        2, 6, 4, 5).add(1000.0 * mesh.pipe_rank).contiguous(
            memory_format=torch.channels_last)
    out = {}
    for route in ("p2p", "slot"):
        y = shift_start(x, ring, 1, route)()
        out[route] = (y.clone(), y.is_contiguous(
            memory_format=torch.channels_last))
    return out


def _nets(state):
    return {f"{n}/{k}": v.detach().clone() for n in ("net_g", "net_d")
            for k, v in getattr(state, n).state_dict().items()}


def step_checks(rank: int, world: int, tmp: str):
    """Every 4-rank check of tests/test_torch_pp_step.py (module
    docstring)."""
    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.parallel import place_state, shard_batch
    from p2p_tpu_torch.parallel.pp import pp_merge_state, pp_split_state
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_pp_train_step
    from torch_spatial_worker import reading_train_split

    saved = torch.load(os.path.join(tmp, "step.pt"), weights_only=False)
    mesh = _mesh(data=2, pipe=2)
    out = {}
    for name, cfg in saved["cfgs"].items():
        state = create_train_state(cfg, 0, device="cpu")
        state.net_g.load_state_dict(saved["net_g"])
        state.net_d.load_state_dict(saved["net_d"])
        if state.net_c is not None:
            state.net_c.load_state_dict(saved["net_c"])
        place_state(state, mesh)
        pp_split_state(state, cfg, mesh)
        step = build_pp_train_step(cfg, mesh, saved["n_micro"])
        state, m = step(state, shard_batch(saved["batch"], mesh))
        pp_merge_state(state, cfg, mesh=mesh)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "nets": _nets(state)}
    reads = []
    install_chaos(ChaosMonkey.from_spec(f"elastic@{ELASTIC_STOP}"))
    try:
        with reading_train_split(reads), \
                contextlib.redirect_stdout(open(os.devnull, "w")):
            out["elastic_rc"] = train.main(
                saved["cli"] + ["--mesh", "data=2,pipe=2"])
    finally:
        install_chaos(None)
    out["elastic_reads"] = reads
    return out


def conv_case(role: str, delayed: bool, seed: int = 3):
    """An int8 conv (16 → 8 channels for ``in``, 8 → 16 for ``out``), its
    input and the cotangent of its output, whole."""
    import numpy as np

    from p2p_tpu_torch.ops.int8 import QuantConv

    rng = np.random.default_rng(seed)
    c_in, c_out = (16, 8) if role == "in" else (8, 16)
    conv = QuantConv(c_in, c_out, 3, padding=1, delayed=delayed)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal(
            conv.weight.shape).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(c_out).astype(
            np.float32)))
        if delayed:
            conv.amax_x.fill_(2.5)
    x = torch.from_numpy(rng.standard_normal((2, c_in, 10, 10)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    g = torch.from_numpy(rng.standard_normal((2, c_out, 10, 10)).astype(
        np.float32))
    return conv, x, g


def conv_check(mesh, role: str, delayed: bool):
    """One rank's share of a sharded int8 conv: forward (training mode),
    the backward of ``sum(y·g)``, the stored scale after."""
    from p2p_tpu_torch.parallel.tp import TPConv, _cut, tp_stats

    conv, x, g = conv_case(role, delayed)
    tp = TPConv(role, mesh.group("model"), mesh.model_rank, mesh.model,
                keep=role == "out")
    conv.p2p_tp, conv.p2p_tp_io = tp, (conv.in_channels, conv.out_channels)
    with torch.no_grad():
        conv.weight.data = _cut(conv.weight.data, 0 if role == "out" else 1,
                                tp)
        if role == "out":
            conv.bias.data = _cut(conv.bias.data, 0, tp)
    if role == "in":
        x = _cut(x, 1, tp)
    else:
        g = _cut(g, 1, tp)
    x = x.clone().requires_grad_()
    before = {k: v["calls"] for k, v in tp_stats.items()}
    y = conv.train()(x)
    (y * g).sum().backward()
    return {"y": y.detach().clone(), "dx": x.grad.clone(),
            "dw": conv.weight.grad.clone(), "db": conv.bias.grad.clone(),
            "amax": conv.amax_x.clone() if delayed else None,
            "calls": {k: v["calls"] - before[k] for k, v in tp_stats.items()}}


def tp_int8_checks(rank: int, world: int, tmp: str):
    """Every 2-rank check of tests/test_torch_tp_int8.py (module
    docstring)."""
    from p2p_tpu_torch.cli import train
    from p2p_tpu_torch.parallel import make_parallel_train_step, place_state
    from p2p_tpu_torch.parallel.tp import tp_full
    from p2p_tpu_torch.resilience import ChaosMonkey, install_chaos
    from p2p_tpu_torch.train.state import create_train_state
    from torch_tp_worker import replicated_bits

    mesh = _mesh(data=1, model=2)
    out = {"convs": {(role, delayed): conv_check(mesh, role, delayed)
                     for role in ("out", "in") for delayed in (False, True)}}
    saved = torch.load(os.path.join(tmp, "hd8.pt"), weights_only=False)
    cfg = saved["cfg"]
    state = create_train_state(cfg, 0, device="cpu",
                               sample_batch=saved["batch"])
    for net in ("net_g", "net_d"):
        getattr(state, net).load_state_dict(saved[net])
    place_state(state, mesh, tp_min_ch=cfg.parallel.tp_min_ch)
    out["kinds"] = sorted({(s.net, type(s.module).__name__)
                           for s in state.tp_shards})
    state, m = make_parallel_train_step(cfg, mesh)(state, saved["batch"])
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["replicated"] = replicated_bits(state)
    with tp_full(state):
        out["nets"] = _nets(state)
    install_chaos(ChaosMonkey.from_spec(f"elastic@{ELASTIC_STOP}"))
    try:
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            out["elastic_rc"] = train.main(saved["cli"]
                                           + ["--mesh", "1,1,1,2"])
    finally:
        install_chaos(None)
    return out
