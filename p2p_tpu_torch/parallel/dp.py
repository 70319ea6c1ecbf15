"""Data-parallel training over the mesh's batch axes (counterpart of
``p2p_tpu/parallel/dp.py:37-146``).

The JAX step is one jitted program over the mesh: the state replicated,
the batch split along N over (data, fsdp), and GSPMD inserts the gradient
and BatchNorm all-reduces. Here each rank runs the one-device step
(train/step.py ``build_train_step``) on its rows of the global batch, and
the collectives are written out:

- :func:`replicate_state` broadcasts every tensor of the state from rank
  0: parameters, buffers (BatchNorm running statistics, spectral-norm
  ``u``, stored int8 scales), optimizer moments, the EMA and the pool;
- :func:`shard_batch` keeps rank ``r``'s rows ``[r·n, (r+1)·n)`` of a
  global host batch (the loader of a trainer hands each rank its own
  rows already, data/pipeline.py);
- :class:`DataParallel` is what the step calls: :meth:`DataParallel.
  sync_grads` all-reduces one network's gradients as ONE coalesced
  buffer, divided by the world size, after that network's backward and
  before its optimizer step (G, then D, then net_c: the same order on
  every rank; the step's G backward reaches G's parameters only, so D's
  reduction never sees a gradient from the G loss), :meth:`agree`
  makes the skip guard's verdict one for all ranks, and
  :meth:`mean_metrics` turns the step's metrics into the global batch's;
- BatchNorm sums its moments over the batch group (ops/norm.py,
  sync-BatchNorm through kernel #5), and the U-Net draws its dropout mask
  for the global batch and keeps the rank's rows (models/unet.py), both
  through the mesh this module makes visible (``core/mesh.mesh_context``).

The loss of the JAX step is a mean over the GLOBAL batch, so its
gradients equal a one-device step on the same global batch
(``dp.py:15-17``); here each rank's loss is the mean over its rows, and
the gradient average over the ranks is that same mean.

With ``fsdp`` > 1 the optimizers and the EMA are sharded (parallel/
rules.py): the gradient is still all-reduced whole, so the update of a
range is bitwise the replicated update of it.

With ``spatial`` > 1 (slice 13b, parallel/spatial.py) each batch slot's
images are split along H over its spatial group: :func:`shard_batch`
keeps this rank's rows of its slot's samples, every windowed op exchanges
the rows it needs, and each rank's loss is its exact share of the global
batch's loss (its sums over the global counts, losses/). So the gradients
are SUMMED over the spatial group and averaged over the batch slots: one
coalesced all-reduce a network over the whole world, divided by the
number of batch slots; :meth:`DataParallel.mean_metrics` adds the
spatial peers' loss shares and averages the rest, and :meth:`agree`
spans the world.

With ``time`` > 1 (parallel/temporal.py, the video step's
``make_parallel_video_step``) each batch slot's clips are split along T
over its time group (:func:`shard_batch` keeps this rank's frames), and
each rank's loss is its share of the global batch's (its sums over the
global counts); the gradients are summed over the time group and averaged
over the batch slots, as over the spatial group.

With ``model`` > 1 (parallel/tp.py) each rank of a model group holds its
channel shard of every Megatron pair, and the losses are equal on the
model peers. A shard's gradient is averaged over the data line through
the rank (``Mesh.reduce_group``). A replicated parameter's gradient is
whole on every model peer, but only equal up to the order in which the
card's atomics add (a reflect pad's backward, a non-deterministic cuDNN
algorithm), so it is averaged over the world: the model peers take one
update and their copies stay the same bits. The metrics and the guard's
verdict span the world too.

With ``pipe`` > 1 (parallel/pp.py, train/step.py ``build_pp_train_step``)
each pipe rank holds one stage of the generator's trunk; everything else
(the encoder and decoder, the shared PReLU, D, net_c) is replicated over
``pipe`` and computed alike on the pipe peers, which read the same
samples. A stage block's gradient is averaged over its data line (the
ranks with its pipe index, ``Mesh.reduce_group``); a replicated
parameter's is averaged over the world, pipe peers included, so their
copies take one update.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.mesh import (Mesh, frame_block, mesh_context,
                                     row_block)
from p2p_tpu_torch.ops.norm import sync_batchnorm
from p2p_tpu_torch.parallel.rules import (ShardedOptimizer, gather_params,
                                          in_layout_of, mem_flat,
                                          release_params, shard_state)


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a train state, in one order on every rank."""
    out: List[torch.Tensor] = []
    for name in ("net_g", "net_d", "net_c", "net_dt"):
        net = getattr(state, name, None)
        if net is not None:
            out += [t.data for t in net.parameters()]
            out += list(net.buffers())
    for name in ("opt_g", "opt_d", "opt_c", "opt_dt"):
        opt = getattr(state, name, None)
        if opt is None:
            continue
        for group in opt[0].param_groups:
            for p in group["params"]:
                st = opt[0].state.get(p, {})
                out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])
                        and st[k].device == p.device]
    ema = getattr(state, "ema_g", None)
    if ema is not None:
        out += list(ema.values())
    for name in ("pool", "pool_n"):
        t = getattr(state, name, None)
        if t is not None:
            out.append(t)
    return out


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Broadcast every tensor of ``state`` from rank 0 (in place)."""
    for t in state_tensors(state):
        dist.broadcast(t, src=0)
    return state


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, np.ndarray]:
    """This rank's part of a global NHWC (or NTHWC clip) host batch: N
    split over the batch slots (in slot order), with ``spatial`` > 1 H
    over the spatial group (:func:`shard_rows`), with ``time`` > 1 a
    clip's T over the time group (``core/mesh.frame_block``)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.batch_shards:
            raise ValueError(f"batch of {n} does not split over "
                             f"{mesh.batch_shards} ranks")
        m = n // mesh.batch_shards
        out[k] = v[mesh.batch_rank * m:(mesh.batch_rank + 1) * m]
        if mesh.time > 1:
            if v.ndim != 5:
                raise ValueError(f"{k}: a time mesh takes NTHWC clips, got "
                                 f"shape {v.shape}")
            a, b = frame_block(v.shape[1], mesh.time, mesh.time_rank)
            out[k] = out[k][:, a:b]
    return shard_rows(out, mesh)


def shard_rows(batch: Dict[str, np.ndarray], mesh: Mesh
               ) -> Dict[str, np.ndarray]:
    """This rank's block of rows (``core/mesh.row_block`` along H, dim 1 of
    NHWC) of every image of a batch slot's samples; the batch as it is
    when ``spatial`` is 1."""
    if mesh.spatial == 1:
        return batch
    out = {}
    for k, v in batch.items():
        a, b = row_block(v.shape[1], mesh.spatial, mesh.spatial_rank)
        out[k] = v[:, a:b]
    return out


def _reduce_grads(params: List[nn.Parameter], group, n: int
                  ) -> torch.Tensor:
    """All-reduce (SUM over ``group``) the gradients of ``params`` as one
    buffer laid out as the parameters, divide it by ``n`` and make each
    ``.grad`` a view of it; returns the buffer."""
    flat = torch.cat([mem_flat(in_layout_of(p.grad, p)) for p in params])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    off = 0
    for p in params:
        p.grad = flat.as_strided(p.shape, p.stride(), off)
        off += p.numel()
    return flat


def _local(p: torch.Tensor) -> bool:
    """Whether ``p`` is this rank's own part (a Megatron shard, a pipe
    stage's block) rather than a replica."""
    return bool(getattr(p, "p2p_tp_role", None)
                or getattr(p, "p2p_pp_stage", False))


class DataParallel:
    """The collectives of one data-parallel train step on ``mesh``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        # a shard's (or a pipe stage's) gradients span data x fsdp x
        # spatial x time (the world unless a model or pipe axis splits
        # it); everything else spans the world
        self.grad_group = mesh.reduce_group
        self.n_world = mesh.batch_shards * mesh.model * mesh.pipe

    @torch.no_grad()
    def sync_grads(self, opt) -> None:
        """All-reduce (SUM) the gradients of ``opt``'s parameters as one
        buffer laid out as the parameters, divide it by the number of
        batch slots, and make each ``.grad`` a view of it (a sharded
        optimizer steps on its range). With ``model`` > 1 the replicated
        parameters' buffer spans the world and is divided by the batch
        slots times ``model``, and the shards' buffer spans the rank's
        data line. Every parameter must have a gradient."""
        optimizer = opt[0]
        params = [p for g in optimizer.param_groups for p in g["params"]]
        missing = [i for i, p in enumerate(params) if p.grad is None]
        if missing:
            raise RuntimeError(f"data parallel: {len(missing)} parameters "
                               "got no gradient (every rank must reduce "
                               "the same buffer)")
        if self.mesh.model == 1 and self.mesh.pipe == 1:
            flat = _reduce_grads(params, self.grad_group,
                                 self.mesh.batch_shards)
            if isinstance(optimizer, ShardedOptimizer):
                optimizer.grad_flat = flat
            return
        shards = [p for p in params if _local(p)]
        whole = [p for p in params if not _local(p)]
        if whole:
            _reduce_grads(whole, None, self.n_world)
        if shards:
            _reduce_grads(shards, self.grad_group, self.mesh.batch_shards)

    def mean_metrics(self, metrics: Dict[str, torch.Tensor],
                     shares: Sequence[str] = ()
                     ) -> Dict[str, torch.Tensor]:
        """The step's 0-d metrics as the global batch's (one all-reduce of
        their stack), as the JAX step reports them, so every rank's
        sentinel, ladder and records see the same values: the mean over
        the batch slots (and the model and pipe peers), where the
        ``shares`` (the losses: each rank's share of its slot's loss under
        a spatial or time split) are first summed over the spatial and
        time group and the rest (equal on those peers) averaged."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k].detach().reshape(()).float()
                               for k in keys])
        s = self.mesh.spatial * self.mesh.time
        if s > 1:
            weight = torch.tensor([1.0 if k in shares else 1.0 / s
                                   for k in keys], device=stacked.device)
            stacked = stacked * weight
        dist.all_reduce(stacked)
        stacked.div_(self.n_world)
        return dict(zip(keys, stacked.unbind()))

    def agree(self, *losses: torch.Tensor) -> bool:
        """Whether every rank's losses are finite (one all-reduce MIN over
        the world)."""
        ok = torch.isfinite(torch.stack([x.detach().float()
                                         for x in losses])).all().float()
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return bool(ok)

    def before_step(self, state) -> None:
        gather_params(state)

    def after_step(self, state) -> None:
        release_params(state)


def place_state(state, mesh: Mesh, fsdp_params: bool = False,
                tp_min_ch: int = 512):
    """The parallel layout of a freshly created state: replicated from
    rank 0, then (``fsdp`` > 1) ZeRO-sharded, or (``model`` > 1) each
    Megatron pair's parameters cut to this rank's shard (parallel/tp.py
    ``place_state_tp``, pairs of at least ``tp_min_ch`` channels)."""
    from p2p_tpu_torch.parallel.tp import place_state_tp

    replicate_state(state, mesh)
    shard_state(state, mesh, fsdp_params=fsdp_params)
    return place_state_tp(state, mesh, tp_min_ch)


def make_parallel_train_step(cfg: Config, mesh: Mesh,
                             vgg: Optional[nn.Module] = None,
                             train_dtype: Optional[torch.dtype] = None,
                             steps_per_epoch: int = 1):
    """``step(state, batch) -> (state, metrics)``: the one-device step on
    this rank's rows with the data-parallel collectives, inside the mesh's
    context (sync-BatchNorm per ``cfg.parallel.sync_batchnorm``, the
    global dropout draw). ``state`` is in the layout of
    :func:`place_state`; ``metrics`` are the means over the ranks."""
    from p2p_tpu_torch.parallel.tp import check_tp_config
    from p2p_tpu_torch.train.step import build_train_step

    check_tp_config(cfg, mesh)
    dp = DataParallel(mesh)
    step = build_train_step(cfg, vgg, train_dtype, steps_per_epoch, dp=dp)

    def parallel_step(state, batch):
        with mesh_context(mesh), sync_batchnorm(cfg.parallel.sync_batchnorm):
            return step(state, batch)

    return parallel_step


def make_parallel_eval_step(cfg: Config, mesh: Mesh,
                            train_dtype: Optional[torch.dtype] = None):
    """The eval step on this rank's rows, inside the mesh's context
    (eval mode reads the running statistics: no collective)."""
    from p2p_tpu_torch.train.step import build_eval_step

    step = build_eval_step(cfg, train_dtype)

    def parallel_eval(state, batch):
        with mesh_context(mesh):
            return step(state, batch)

    return parallel_eval


SPATIAL_GENERATORS = ("resnet", "pix2pixhd", "pix2pixhd_global")


def check_spatial_config(cfg: Config, mesh: Mesh) -> None:
    """Raise ``NotImplementedError`` for what the spatial step does not
    cover (every op on its path has a sharded form; nothing else may run
    on a block of rows): the ResNet-family generators, no compression net,
    no int8, no fake pool, no style, Sobel or angular term, no remat; and
    the image height must split into blocks of at least 2 rows at the
    generator's deepest level (the halo+1 rule of its k3 convs)."""
    if mesh.spatial == 1:
        return
    m, L = cfg.model, cfg.loss
    refused = []
    if m.generator not in SPATIAL_GENERATORS:
        refused.append(f"generator {m.generator!r}")
    if m.use_compression_net:
        refused.append("the compression net")
    if m.int8:
        refused.append("int8")
    if cfg.train.pool_size > 0:
        refused.append("pool_size > 0")
    for name in ("lambda_style", "lambda_sobel", "lambda_angular"):
        if getattr(L, name) > 0:
            refused.append(name)
    if cfg.parallel.remat:
        refused.append("remat")
    if refused:
        raise NotImplementedError(
            f"spatial={mesh.spatial} is ported for {SPATIAL_GENERATORS} "
            "with the plain losses; not for " + ", ".join(refused))
    downs = (5 if m.generator == "pix2pixhd" else
             4 if m.generator == "pix2pixhd_global" else 2)
    deepest = cfg.data.image_size >> downs
    if deepest < 2 * mesh.spatial:
        raise ValueError(
            f"image height {cfg.data.image_size} → deepest feature height "
            f"{deepest} gives a spatial rank fewer than 2 rows "
            f"(spatial={mesh.spatial}; a k3 conv's halo needs halo+1)")


def check_time_config(cfg: Config, mesh: Mesh) -> None:
    """Raise ``NotImplementedError`` for what the time-sharded video step
    does not cover, by name: the delayed int8 video state (as the one-rank
    video step), remat, a BatchNorm generator (its moments would span the
    batch slots only), ZeRO over ``fsdp``; and a clip whose frames do not
    split into blocks of at least 2 frames a rank (the halo + 1 rule of
    the temporal D's k_t = 3 convs)."""
    if mesh.time == 1:
        return
    m = cfg.model
    refused = []
    if m.int8_delayed:
        refused.append("int8_delayed")
    if cfg.parallel.remat:
        refused.append("remat")
    if m.norm == "batch":
        refused.append("norm 'batch'")
    if mesh.shape["fsdp"] > 1:
        refused.append("fsdp > 1")
    if refused:
        raise NotImplementedError(
            f"time={mesh.time} is ported for the video step with "
            "frame-local generators; not for " + ", ".join(refused))
    t = cfg.data.n_frames
    if t % mesh.time or t // mesh.time < 2:
        raise ValueError(
            f"a clip of {t} frames gives each of time={mesh.time} ranks "
            "fewer than 2 frames or an uneven block (the temporal D's k_t=3 "
            "halo needs halo+1 frames a rank)")
