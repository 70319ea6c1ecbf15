"""The trainer: epochs of train steps, per-epoch eval and checkpoints,
preemption with exact-step resume, the recovery ladder and the training
telemetry (counterpart of the single-device core of
``p2p_tpu/train/loop.py``: ``Trainer`` with ``maybe_resume``,
``train_epoch``, ``evaluate`` and ``fit``, and the helpers both JAX
trainers share).

Each epoch shuffles the train split with ``default_rng(seed + epoch +
jitter)`` (and crops with ``aug_seed`` = the same sum; the jitter moves
only after a rollback), runs one train step per batch with the batches
sent to the card one ahead (data/pipeline.py), and keeps the metrics as
device-side running sums fetched once at the epoch's end. The eval
scores every test image (per-image PSNR/SSIM in eval mode, no moments
kernel) and writes the first batch's
``e{epoch}_{input,target,pred,comp}.png`` under
``<workdir>/<result_dir>/<dataset>/``; with ``train.save_masks`` also
``e{epoch}_mask.png``, the bitwise AND of the uint8 prediction and
input; with ``train.eval_fid`` it adds ``vfid``, the Fréchet distance of
the test split's targets and predictions in mean-pooled VGG19 features
(losses/fid.py; ``vfid_feature_source`` "random" beside it when the VGG
weights are the seeded draw, not an ``.npz``), once more than one image
was scored. ``train.eval_every_epoch`` False skips the per-epoch eval
(and so ``mark_good``). A split that is not memoized and has more than
64 items is read by ``data.threads`` loader worker processes, started
once for the run (``fit`` stops them at its end). A
checkpoint is saved every ``epoch_save`` epochs and at the last one,
with its iterator sidecar, and marked good when its eval's PSNR is
finite. ``metrics_<name>.jsonl`` in the workdir receives the JAX
trainer's records under the same keys (``manifest``, ``train``,
``epoch``, ``eval``, ``memory``, ``preempt``, ``resume``, ``health``,
``rollback``, ``health_summary``, ...), through the registry's sinks
(obs/sinks.py).

Host syncs of a step: the skip guard's two (train/step.py), one per
``log_every`` steps for the ``train`` record, and the divergence
sentinel's read of the previous step's metrics, which were copied to a
pinned host buffer behind a CUDA event and are complete by then (the
guard synchronized past them), so it waits on nothing.

Preemption: ``fit`` installs a :class:`~p2p_tpu_torch.resilience.
PreemptionGuard` (SIGTERM/SIGINT → flag) unless the caller injected one;
each step boundary polls it, behind the ``elastic`` chaos seam
(``P2P_CHAOS=elastic@N`` preempts at step N). A preemption saves the
exact step and its sidecar (epoch, batches done, samples seen, aug seed,
seed jitter, the base LR scale, the topology) and raises
:class:`~p2p_tpu_torch.resilience.Preempted`, which ``cli/train.py``
turns into exit code 75; ``maybe_resume`` re-enters the epoch at the next
unconsumed sample (``make_loader(skip_samples=)``), so the resumed run
ends bitwise where an uninterrupted one ends on the same device
(tests/test_torch_resume.py).

Self-healing (``cfg.health``, resilience/health.py): the sentinel reads
each step's metrics one step late; the ladder skips, cools the learning
rate (``state.lr_scale``, a host float, times ``cooldown_factor``) and
rolls back to the newest ``mark_good`` step on a perturbed shuffle; past
``max_rollbacks`` it raises ``DivergenceError`` (exit code 76).

Telemetry: a run manifest (``manifest_<name>.json`` and a ``manifest``
record), host spans exported as ``trace_<name>.json`` (Perfetto) at the
end of ``fit``, the kernel-build watchdog armed after the first epoch, a
``memory`` record per epoch on the card, the ``img_dispatch_rate`` EWMA
and, with ``debug.nan_sentinel``, sentinel events as records.

With ``lr_policy="plateau"`` a :class:`~p2p_tpu_torch.train.schedules.
PlateauController` is fed each epoch's ``loss_g`` after the epoch record
and before the checkpoint; its scale times the ladder's cooldown factor
is the state's ``lr_scale``, which multiplies every update, is saved
with the checkpoint and seeds the controller on resume. The logged ``lr``
includes it. With an EMA generator (``ema_decay``) the eval scores the
EMA weights (bitwise G's at decay 0).

The video trainer (train/video_loop.py ``VideoTrainer``) is this trainer
on clips: it overrides the factories and the eval batch, and shares every
path above.

Data parallel (slice 13): under ``torchrun`` (a default process group,
``core/mesh.distributed_init``) the trainer builds the mesh of
``cfg.parallel.mesh`` (:func:`build_trainer_mesh`), replicates the state
from rank 0 and ZeRO-shards it over ``fsdp`` (parallel/dp.py
``place_state``), and trains through ``make_parallel_train_step``: each
rank reads its stride of every epoch's permutation (``data/pipeline.
shard_epoch_indices``; ``cfg.data.batch_size`` is the global batch), each
step's metrics are all-reduced into the global batch's (so the epoch sums,
the records and every rank's sentinel and ladder see the same values),
each rank scores its stride of the test split
and the (sum, max, count) statistics are gathered (:func:`combine_process_
metric_stats`; VFID is off on more than one process, as in JAX). Rank 0
writes the checkpoints in the one-device format and the run's manifest,
trace and sample PNGs, every rank waits at a barrier after a save, and
rank ``p`` > 0 writes its records to ``metrics_<name>.p<p>.jsonl``
(:func:`metrics_path`). The preemption poll agrees over the ranks
(``resilience/preempt.py``), so every rank saves and exits 75 at one
step. A plain run (no ``torchrun``) has no group and no mesh.

Elastic relaunch (``cfg.train.elastic``): ``maybe_resume`` reconciles the
step's recorded topology (:func:`trainer_topology`) with this launch's
before it restores (:func:`plan_elastic_restore`): a process-count or
data/fsdp-width change is a plain load onto the new world
(``reshard``), a global-batch change re-bases the position from samples
(``batch_rebase``), a dtype change casts with ``cast_on_restore``
(``dtype_cast``); what cannot be reconciled raises ``TopologyMismatch``
(exit 2 in ``cli/train.py``). A spatial mesh (slice 13b) splits each
batch slot's images along H: the loader shards by batch slot (spatial
peers read the same samples), the step keeps the rank's rows, the eval
gathers whole predictions and one spatial peer enters the metric combine;
a relaunch across spatial widths is a ``reshard``. A model mesh (tensor
parallelism, parallel/tp.py) cuts each Megatron pair's parameters, Adam
moments and EMA to the rank's channel shard after the replication
(``place_state(..., tp_min_ch)``); model peers read the same samples,
the saves and restores gather the whole tensors (``parallel.tp.tp_full``:
one-device checkpoints on rank 0, a relaunch across model widths a
``reshard``), and one model peer enters the metric combine. On a
``pipe`` axis wider than one the trainer prints JAX's warning and runs
flat (``p2p_tpu/train/loop.py:893-903``): the pipe ranks are replicas
that read the same samples, their gradients averaged over the world, and
one pipe peer enters the metric combine; the sidecar records the
stacking the state carries (``pp_stages``, parallel/pp.py
``pp_width_of``: 1 for the trainer), so a relaunch at another pipe width
migrates through ``pp_restructure``. A relaunch across model widths under
delayed int8 migrates through ``tp_amax_recalibrate``, and with
``recalibrate_steps`` the scales are held frozen for that many steps
after it (or after a restore that initialized scales the checkpoint
lacked): resilience/reshape.py ``hold_frozen_quant`` runs after each
step of the window. The video trainer's time axis: train/video_loop.py.
Not ported yet: scan steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from p2p_tpu_torch.core.cache import enable_compilation_cache
from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.mesh import (ONE_DEVICE_AXES, Mesh,
                                     TopologyMismatch,
                                     classify_topology_delta,
                                     describe_topology, local_batch_size,
                                     mesh_topology,
                                     process_allgather, process_count,
                                     process_index, rank_device)
from p2p_tpu_torch.core.debug import check_finite, enable_nan_debugging
from p2p_tpu_torch.core.device import resolve_device
from p2p_tpu_torch.core.dtypes import train_dtype
from p2p_tpu_torch.data.pipeline import (LoaderWorkers, PairedImageDataset,
                                         device_prefetch, make_loader)
from p2p_tpu_torch.losses.fid import FIDEvaluator, make_vgg_feature_fn
from p2p_tpu_torch.models.vgg import vgg19_npz_path
from p2p_tpu_torch.obs import (MemoryWatchdog, MetricsLogger,
                               RetraceWatchdog, SpanRecorder,
                               add_sentinel_handler, read_sentinels,
                               remove_sentinel_handler, timed_annotation,
                               write_manifest)
from p2p_tpu_torch.obs.taps import host_copy
from p2p_tpu_torch.resilience.chaos import FaultInjected, chaos_point
from p2p_tpu_torch.resilience.health import (DivergenceError, TrainingHealth,
                                             poison_nan_observation)
from p2p_tpu_torch.resilience.preempt import Preempted, PreemptionGuard
from p2p_tpu_torch.parallel import (full_params, make_parallel_eval_step,
                                    make_parallel_train_step, place_state,
                                    shard_rows)
from p2p_tpu_torch.parallel.pp import pp_full, pp_width_of
from p2p_tpu_torch.parallel.tp import tp_full
from p2p_tpu_torch.resilience.reshape import (ElasticPlan,
                                              apply_batch_rebase,
                                              arm_quant_init_warmup,
                                              check_ported_chain,
                                              elastic_restore,
                                              hold_frozen_quant)
from p2p_tpu_torch.train.checkpoint import (OPTS, CheckpointCorrupt,
                                            CheckpointManager,
                                            SidecarCorrupt, peek_topology,
                                            state_fields)
from p2p_tpu_torch.train.schedules import PlateauController, make_schedule
from p2p_tpu_torch.train.state import (TrainState, create_train_state,
                                       load_vgg19)
from p2p_tpu_torch.train.step import (build_eval_step, build_train_step,
                                      compressed_input, to_device_image)
from p2p_tpu_torch.utils.images import ingest, save_img, to_uint8_img


# ----------------------------------------------------------- telemetry
def init_trainer_obs(tr) -> None:
    """The trainer's telemetry: the run manifest and its record, the span
    recorder and trace path, the memory watchdog, the dispatch-rate EWMA,
    then the health wiring. The process-wide hooks (the build watchdog's
    listener, the sentinel handler) are :func:`install_trainer_hooks`'s,
    for the duration of ``fit``."""
    cfg = tr.cfg
    tr.spans = SpanRecorder()
    tr._trace_path = os.path.join(tr.workdir, f"trace_{cfg.name}.json")
    extra = None
    if tr.mesh is not None:
        extra = {"n_devices": tr.mesh.size, "process_index": tr.rank,
                 "process_count": process_count(),
                 "mesh_shape": dict(tr.mesh.shape)}
    path = os.path.join(tr.workdir, f"manifest_{cfg.name}.json")
    if tr.rank:
        # rank 0 keeps the run's manifest file; each rank records it
        from p2p_tpu_torch.obs.manifest import build_manifest

        man = build_manifest(cfg, device=tr.device, extra=extra)
    else:
        man = write_manifest(path, cfg, device=tr.device, extra=extra)
    tr.logger.log({"kind": "manifest", "config_hash": man["config_hash"],
                   "git_sha": man["git_sha"], "backend": man["backend"]},
                  force=True)
    tr.retrace = None
    tr.memwatch = MemoryWatchdog(registry=tr.obs, devices=[tr.device])
    tr._img_rate = tr.obs.ewma("img_dispatch_rate")
    tr._sentinel_handler = None
    init_trainer_health(tr)


def install_trainer_hooks(tr) -> None:
    """The build watchdog (a new one each ``fit``: armed after the first
    epoch) and, with ``nan_sentinel``, sentinel events routed into the
    run's records. Both are process-wide: :func:`close_trainer_obs`
    removes them when ``fit`` returns or raises."""
    tr.retrace = RetraceWatchdog(registry=tr.obs, logger=tr.logger)
    if tr.cfg.debug.nan_sentinel:
        # the handler captures the logger and registry, not the trainer
        logger, reg = tr.logger, tr.obs

        def _handler(ev):
            reg.counter("nonfinite_events", tag=ev.get("tag", "")).inc()
            logger.log(ev, force=True)

        tr._sentinel_handler = _handler
        add_sentinel_handler(_handler)


def close_trainer_obs(tr) -> None:
    """Remove the hooks :func:`install_trainer_hooks` installed, so a
    second trainer in the process does not report into this one's
    stream. Idempotent."""
    if tr.retrace is not None:
        tr.retrace.close()
    if tr._sentinel_handler is not None:
        remove_sentinel_handler(tr._sentinel_handler)
        tr._sentinel_handler = None


# ----------------------------------------------- checkpoints and resume
def trainer_topology(tr) -> Dict:
    """The sidecar's topology block, recorded with every step and
    reconciled on relaunch: the mesh's (:func:`~p2p_tpu_torch.core.mesh.
    mesh_topology`: the real process and device counts and the axis
    sizes, none without a mesh) and the global batch, the dtype policy,
    the loader (the port's is always the stride-sharded fallback) and the
    pipeline stages the state carries (1: flat)."""
    cfg = tr.cfg
    topo = mesh_topology(tr.mesh)
    topo.update({"global_batch": int(cfg.data.batch_size),
                 "mixed_precision": bool(cfg.train.mixed_precision),
                 "moment_dtype": cfg.optim.moment_dtype,
                 "int8_delayed": bool(cfg.model.int8_delayed),
                 "loader": "fallback", "pp_stages": pp_width_of(tr.state)})
    return topo


def save_trainer_ckpt(tr) -> int:
    """Checkpoint the state and its iterator sidecar: together they name
    an exact point of the sample stream, so any checkpoint (an epoch's end
    or a preemption mid-epoch) resumes without replaying or skipping a
    sample. On a mesh every rank gathers the ZeRO ranges, rank 0 writes
    the one-device format and every rank waits for it. Returns the
    step."""
    step = int(tr.state.step)
    with full_params(tr.state), tp_full(tr.state), \
            pp_full(tr.state, tr.cfg, tr.mesh, tr.steps_per_epoch):
        fields = state_fields(tr.state, step, tr.epoch)
    if tr.rank == 0:
        tr.ckpt.save(step, tr.state, tr.epoch, fields=fields)
        tr.ckpt.save_aux(step, {
            "step": step,
            "epoch": tr.epoch,
            "batches_done": step % tr.steps_per_epoch,
            "steps_per_epoch": tr.steps_per_epoch,
            "samples_seen": int(tr._samples_seen),
            "epoch_samples_done": int(tr._epoch_samples_done),
            "aug_seed": tr.cfg.train.seed + tr.epoch + tr._seed_jitter,
            # a rollback's shuffle perturbation (the resumed epoch must skip
            # against the perturbed permutation) and the base LR scale (the
            # state's may carry a cooldown that must not outlive a resume)
            "seed_jitter": int(tr._seed_jitter),
            "lr_base": float(tr._base_lr_scale),
            "topology": trainer_topology(tr),
        })
    if tr.mesh is not None:
        dist.barrier()
    return step


def finish_preempted(tr) -> None:
    """The preemption epilogue: the exact-step save, the ``preempt``
    record, the span export and a flush, then :class:`Preempted` (exit
    code 75 in ``cli/train.py``)."""
    with tr.spans.span("preempt_save", epoch=tr.epoch):
        step = save_trainer_ckpt(tr)
    signum = getattr(tr.preempt, "signum", None)
    tr.logger.log({"kind": "preempt", "epoch": tr.epoch, "step": step,
                   "signum": signum or 0}, force=True)
    if tr.rank == 0:
        tr.spans.export_perfetto(tr._trace_path)
    tr.logger.registry.flush()
    raise Preempted(step, signum)


_AUX_UNREAD = object()


def derive_sample_position(tr, step: int, aux, mid: int) -> int:
    """Set the trainer's sample accounting (``_samples_seen``,
    ``_epoch_samples_done``, ``_resume_skip_samples``) from a restored
    step's sidecar. A sidecar without the sample fields (or none) falls
    back to step × batch, counted on ``aux_compat_total`` with a
    ``kind="aux_compat"`` record. Returns the epoch's consumed samples."""
    topo = (aux or {}).get("topology") or {}
    b_saved = int(topo.get("global_batch") or tr.cfg.data.batch_size)
    ss = (aux or {}).get("samples_seen")
    es = (aux or {}).get("epoch_samples_done")
    if ss is None or es is None:
        tr.obs.counter("aux_compat_total").inc()
        tr.logger.log(
            {"kind": "aux_compat", "step": int(step),
             "missing": [k for k, v in (("samples_seen", ss),
                                        ("epoch_samples_done", es))
                         if v is None],
             "derived_batch": b_saved},
            force=True)
        if ss is None:
            ss = int(step) * b_saved
        if es is None:
            es = int(mid) * b_saved
    tr._samples_seen = int(ss)
    tr._epoch_samples_done = int(es)
    tr._resume_skip_samples = int(es)
    return int(es)


def derive_resume_position(tr, step: int, aux=_AUX_UNREAD):
    """``(done_full_epochs, mid_batches)`` of a restored step: from
    ``step % steps_per_epoch``, overridden by the sidecar where there is
    one (a different ``steps_per_epoch`` there means the dataset or the
    batch changed under the checkpoint: warned). Restores the seed jitter,
    sets the sample position and logs a ``kind="resume"`` record for a
    mid-epoch step. ``aux`` is the sidecar the caller already read (None:
    read but missing or corrupt), else it is read here."""
    done, mid = divmod(int(step), tr.steps_per_epoch)
    if aux is _AUX_UNREAD:
        aux = tr.ckpt.restore_aux(int(step))
    if aux is not None and aux.get("seed_jitter") is not None:
        tr._seed_jitter = int(aux["seed_jitter"])
    if aux is not None and aux.get("batches_done") is not None:
        plan = getattr(tr, "_elastic_plan", None)
        rebasing = plan is not None and "batch_rebase" in plan.chain
        if int(aux.get("steps_per_epoch", tr.steps_per_epoch)) \
                != tr.steps_per_epoch and not rebasing:
            # a planned batch migration re-bases from samples
            # (resilience/reshape.apply_batch_rebase)
            print(
                f"WARNING: checkpoint step {step} was saved with "
                f"steps_per_epoch={aux.get('steps_per_epoch')} but this "
                f"run has {tr.steps_per_epoch} — exact-step resume "
                "alignment is not guaranteed (did the dataset or batch "
                "size change?)", flush=True)
        mid = int(aux["batches_done"])
        done = (int(step) - mid) // int(
            aux.get("steps_per_epoch") or tr.steps_per_epoch)
        want_aug = tr.cfg.train.seed + done + 1 + tr._seed_jitter
        if mid and int(aux.get("aug_seed", want_aug)) != want_aug:
            print(
                f"WARNING: mid-epoch resume with a different --seed "
                f"(checkpoint aug_seed={aux.get('aug_seed')}, this run "
                f"would use {want_aug}): the interrupted epoch's sample "
                "order cannot be reproduced — expect replayed/skipped "
                "samples. Relaunch with the original --seed for exact "
                "resume.", flush=True)
    derive_sample_position(tr, step, aux, mid)
    if mid:
        tr.logger.log({"kind": "resume", "step": int(step),
                       "epoch": done + 1, "batches_done": mid}, force=True)
    return done, mid


def poll_preempt(tr) -> bool:
    """The step-boundary preemption poll, behind the ``elastic`` chaos
    seam: armed (``P2P_CHAOS=elastic@N``), it turns host step N into a
    preemption request, with no signal-timing race."""
    if tr.preempt is None:
        return False
    try:
        chaos_point("elastic", step=tr._host_step)
    except FaultInjected:
        tr.preempt.request(signal.SIGTERM)
        return True
    return tr.preempt.should_stop()


def acquire_preempt_guard(tr):
    """Install a :class:`PreemptionGuard` for ``fit`` unless the caller
    injected one. Returns the guard this call owns (for
    :func:`release_preempt_guard`), or None: an injected guard, or no
    signal handlers off the main thread (the run goes unguarded)."""
    if tr.preempt is not None:
        return None
    try:
        guard = PreemptionGuard(registry=tr.obs).install()
    except ValueError:
        return None
    # buffered records reach disk even if the grace window ends first
    guard.add_flush_hook(tr.logger.registry.flush)
    tr.preempt = guard
    return guard


def release_preempt_guard(tr, owned_guard) -> None:
    if owned_guard is not None:
        owned_guard.uninstall()
        tr.preempt = None


# ---------------------------------------------------------- self-healing
# The sentinel reads each step's metrics ONE STEP LATE, from a pinned host
# buffer the step's metrics were copied into behind a CUDA event: by then
# the copy has landed, so the happy path waits on nothing.


def init_trainer_health(tr) -> None:
    """Sentinel and ladder wiring, and the host mirrors the health path
    and the sidecar read (``_host_step`` mirrors ``state.step``)."""
    tr.health = None
    tr._pending_health = None
    tr._seed_jitter = 0
    tr._base_lr_scale = 1.0
    tr._applied_lr_scale = 1.0
    tr._host_step = 0
    tr._samples_seen = 0
    tr._epoch_samples_done = 0
    tr._resume_skip_samples = 0
    # the --recalibrate_steps window (resilience/reshape.py)
    tr._quant_freeze_remaining = 0
    tr._quant_frozen = None
    if tr.cfg.health.enabled:
        tr.health = TrainingHealth(tr.cfg.health, registry=tr.obs,
                                   logger=tr.logger)


def apply_health_lr(tr) -> None:
    """The state's ``lr_scale`` = plateau scale × cooldown multiplier,
    written only when the product changed."""
    mult = tr.health.lr_multiplier if tr.health is not None else 1.0
    want = float(tr._base_lr_scale) * float(mult)
    if want != tr._applied_lr_scale:
        tr.state.lr_scale = want
        tr._applied_lr_scale = want


def stage_metrics(metrics: Dict[str, torch.Tensor]):
    """``(keys, values, event)``: a step's 0-d metrics stacked on their
    device and, on the card, copied to a pinned host buffer behind an
    event (obs/taps.host_copy: no host sync)."""
    keys = list(metrics)
    values, event = host_copy(torch.stack(
        [metrics[k].detach().reshape(()).float() for k in keys]))
    return keys, values, event


def queue_health_observation(tr, metrics: Dict[str, torch.Tensor]) -> None:
    """Count the step's samples, queue its metrics for the delayed read
    and consume the previous step's."""
    tr._samples_seen += tr.cfg.data.batch_size
    tr._epoch_samples_done += tr.cfg.data.batch_size
    if tr.health is None:
        tr._host_step += 1
        return
    prev, tr._pending_health = (
        tr._pending_health, (tr._host_step + 1, stage_metrics(metrics)))
    tr._host_step += 1
    if prev is not None:
        consume_health_observation(tr, prev)


def flush_health_observations(tr) -> None:
    """Drain the delayed slot (the epoch's last step must not escape the
    sentinel)."""
    if tr.health is None:
        return
    pend, tr._pending_health = tr._pending_health, None
    if pend is not None:
        consume_health_observation(tr, pend)


def consume_health_observation(tr, pend) -> None:
    """Read one queued step's metrics (after its event) and walk them
    through the sentinel and the ladder. The ``nan`` chaos seam poisons
    the observed losses here (``P2P_CHAOS=nan@50x3``: steps 50..52)."""
    step, (keys, values, event) = pend
    if event is not None:
        event.synchronize()
    host = dict(zip(keys, values.tolist()))
    tr.health.observe(step, poison_nan_observation(step, host))
    apply_health_lr(tr)


def perform_rollback(tr) -> None:
    """Ladder rung 3: restore the newest ``mark_good`` checkpoint (the
    newest intact one when none is marked; an older intact one when it is
    corrupt), re-enter its epoch on a perturbed shuffle and re-arm the
    post-rollback cooldown."""
    cur_step = tr._host_step
    target = tr.ckpt.last_good_step()
    if target is None:
        target = tr.ckpt.latest_step()
    if target is None:
        raise DivergenceError(cur_step, tr.health.ladder.rollbacks,
                              "no checkpoint to roll back to")
    with full_params(tr.state), tp_full(tr.state):
        tr.ckpt.restore(tr.state, step=int(target), fallback=True)
    if tr.ckpt.last_restored_step is not None:
        target = tr.ckpt.last_restored_step
    done, mid = divmod(int(target), tr.steps_per_epoch)
    aux = tr.ckpt.restore_aux(int(target))
    if aux is not None and aux.get("batches_done") is not None:
        mid = int(aux["batches_done"])
        done = (int(target) - mid) // int(
            aux.get("steps_per_epoch") or tr.steps_per_epoch)
    tr.epoch = done + 1
    derive_sample_position(tr, int(target), aux, mid)
    tr._seed_jitter += 1000003  # a new shuffle permutation from here on
    tr._pending_health = None
    tr._host_step = int(target)
    tr.health.after_rollback(cur_step, int(target))
    # the restore wrote the checkpoint's lr_scale into the state: NaN
    # compares unequal to any product, so the host-known scale is written
    tr._applied_lr_scale = float("nan")
    apply_health_lr(tr)
    tr.logger.log({"kind": "rollback", "step": int(cur_step),
                   "target_step": int(target), "epoch": tr.epoch,
                   "skip_batches": mid,
                   "rollbacks": tr.health.ladder.rollbacks}, force=True)


def log_health_summary(tr) -> None:
    if tr.health is not None:
        tr.logger.log({"kind": "health_summary", **tr.health.summary()},
                      force=True)


def metrics_path(workdir: str, name: str) -> str:
    """Per-process metrics JSONL path: rank 0 keeps
    ``metrics_<name>.jsonl``, rank ``p`` writes the ``.p<p>`` sibling (two
    processes appending to one file would tear records)."""
    idx = process_index()
    suffix = "" if idx == 0 else f".p{idx}"
    return os.path.join(workdir, f"metrics_{name}{suffix}.jsonl")


def combine_process_metric_stats(psnrs, ssims):
    """``(psnr_mean, psnr_max, ssim_mean, ssim_max, n_total)`` over every
    process's per-image lists: one all-gather of (sum, max, count) each
    (``p2p_tpu/train/loop.py:827``). A process that scored no image
    enters the collective with empty-safe statistics; none scored at all
    raises."""
    stats = np.array(
        [np.sum(psnrs), np.max(psnrs, initial=-np.inf), len(psnrs),
         np.sum(ssims), np.max(ssims, initial=-np.inf)], np.float64)
    g = process_allgather(stats)
    n_total = g[:, 2].sum()
    if n_total == 0:
        raise RuntimeError(
            "multi-process eval scored 0 images: the test split is "
            "smaller than process_count × test batch — shrink "
            "test_batch_size or add test data")
    return (float(g[:, 0].sum() / n_total), float(g[:, 1].max()),
            float(g[:, 3].sum() / n_total), float(g[:, 4].max()),
            int(n_total))


def build_trainer_mesh(cfg: Config, workdir: str) -> Optional[Mesh]:
    """The mesh of ``cfg.parallel.mesh`` over the default process group,
    or None without one (a plain run). At world size 1 a preset's spatial
    or time axis resolves as 1 (the one-card form of ``cityscapes_spatial``,
    ``pix2pixhd`` and ``vid2vid_temporal``), and so does a model axis; on
    wider worlds the spatial axis splits H (slice 13b), the time axis a
    clip's frames (``vid2vid_temporal`` resolves ``time=4`` at world size
    4) and the model axis each Megatron pair's channels. A mesh that does
    not fit the processes names the topology the run's checkpoint was
    saved on (``p2p_tpu/train/loop.py:458``)."""
    if not dist.is_initialized():
        return None
    spec = cfg.parallel.mesh
    if dist.get_world_size() == 1:
        spec = dataclasses.replace(spec, **{a: 1 for a in ONE_DEVICE_AXES})
    try:
        return Mesh(spec)
    except ValueError as e:
        ckpt_dir = os.path.join(workdir, cfg.train.checkpoint_dir,
                                cfg.data.dataset, cfg.name)
        try:
            saved = peek_topology(ckpt_dir)
        except SidecarCorrupt:
            saved = None
        if saved is not None:
            raise ValueError(
                f"{e} [relaunch context: the checkpoint under {ckpt_dir} "
                f"was saved on {describe_topology(saved)}; an elastic "
                "relaunch may change the topology, but the new mesh must "
                "fit the processes this launch actually has]") from e
        raise


def plan_elastic_restore(tr, step: int, aux) -> Optional[ElasticPlan]:
    """Reconcile the step's recorded topology with this launch's before the
    restore (``p2p_tpu/train/loop.py:332``), for both trainers: None for
    the same topology (or a run that recorded none), else the
    :class:`~p2p_tpu_torch.resilience.reshape.ElasticPlan` that
    ``elastic_restore`` executes. Raises ``TopologyMismatch`` (both
    topologies named) on an abort delta, on a transform of a later slice,
    and on any delta with ``train.elastic`` off. A torn sidecar for this
    step falls back to the newest intact one (``peek_topology``)."""
    tr._elastic_plan = None
    saved = (aux or {}).get("topology")
    if not saved:
        saved = peek_topology(tr.ckpt.directory)
    if not saved:
        return None
    current = trainer_topology(tr)
    delta = classify_topology_delta(
        saved, current, has_quant_state=bool(tr.cfg.model.int8_delayed),
        cast_on_restore=tr.cfg.train.cast_on_restore)
    if delta.kind == "same":
        return None
    detail = (f"saved: {describe_topology(saved)}; "
              f"current: {describe_topology(current)}")
    if delta.kind == "abort":
        raise TopologyMismatch(
            f"cannot resume across this topology change — {delta.reason} "
            f"({detail})")
    if not tr.cfg.train.elastic:
        raise TopologyMismatch(
            f"topology changed with elastic resume disabled — "
            f"{delta.reason} ({detail}); relaunch on the original "
            "topology, or drop --no-elastic to reshard")
    check_ported_chain(delta.chain, detail)
    tr.obs.counter("elastic_resume_total").inc()
    tr.logger.log({"kind": "elastic_resume", "step": int(step),
                   "decision": delta.kind, "reason": delta.reason,
                   "chain": list(delta.chain), "saved": saved,
                   "current": current}, force=True)
    verb = "migrating" if delta.kind == "migrate" else "resharding"
    chain_note = f" via {'+'.join(delta.chain)}" if delta.chain else ""
    print(f"elastic resume: {delta.reason} — {verb} the step-{step} "
          f"checkpoint onto the current topology{chain_note} ({detail})",
          flush=True)
    plan = ElasticPlan(kind=delta.kind, chain=delta.chain,
                       reason=delta.reason, saved=saved, current=current)
    tr._elastic_plan = plan
    return plan


def finish_elastic_restore(tr, step: int, plan) -> None:
    """One auditable record of a resharded or migrated restore."""
    if plan is None:
        return
    tr.obs.counter("resharded_restore_total").inc()
    tr.logger.log(
        {"kind": "resharded_restore", "step": int(step),
         "decision": plan.kind, "chain": list(plan.chain),
         "resharded_restore_total":
             tr.obs.counter("resharded_restore_total").value},
        force=True)


def epoch_metric_means(host_sums: Dict[str, float], count: int
                       ) -> Dict[str, float]:
    """Per-step means of the epoch sums: losses over the applied steps
    (the ``health_ok`` sum), ``health_ok`` over all steps."""
    n_ok = host_sums.get("health_ok")
    denom = max(float(n_ok) if n_ok is not None else count, 1.0)
    return {k: float(v) / (count if k == "health_ok" else denom)
            for k, v in host_sums.items()}


def mask_skipped(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """A step's metrics as the epoch sums take them: every loss of a step
    the guard skipped (``health_ok`` 0) zeroed (``where``: NaN·0 is NaN)."""
    ok = metrics.get("health_ok")
    if ok is None:
        return metrics
    keep = ok >= 0.5
    return {k: v if k == "health_ok" else torch.where(keep, v,
                                                      torch.zeros_like(v))
            for k, v in metrics.items()}


@contextlib.contextmanager
def eval_weights(state: TrainState) -> Iterator[None]:
    """G's parameters are the EMA's for the duration, when the state
    carries one (the JAX ``eval_state_of``; a ZeRO-sharded EMA is gathered
    once, collectively); its buffers stay G's."""
    if state.ema_g is None:
        yield
        return
    from p2p_tpu_torch.parallel.rules import ema_state

    ema = ema_state(state.ema_g)
    params = dict(state.net_g.named_parameters())
    raw = {k: p.data for k, p in params.items()}
    try:
        for k, p in params.items():
            p.data = ema[k]
        yield
    finally:
        for k, p in params.items():
            p.data = raw[k]


class Trainer:
    """Train ``cfg`` on ``<data_root>/{train,test}/{a,b}/`` (default
    ``<cfg.data.root>/<cfg.data.dataset>``) on one device (``cuda`` unless
    the caller asks for the CPU), writing under ``workdir``. ``preempt``
    may be set to a guard-like object (``should_stop()``, ``request()``,
    ``signum``) before :meth:`fit`; else ``fit`` installs the signal
    guard. ``fit`` installs the process-wide telemetry hooks and removes
    them when it returns or raises. Under a default process group the
    trainer is data parallel over the mesh ``build_trainer_mesh`` builds,
    on ``cuda:LOCAL_RANK`` by default. train/video_loop.py's
    ``VideoTrainer`` overrides the dataset, state and step factories, the
    eval batch and the samples, and the two keys below."""

    # the epoch record's throughput key and the eval record's count key;
    # whether eval_fid scores VFID (the JAX video trainer computes none)
    RATE_KEY = "img_per_sec"
    EVAL_COUNT_KEY = "n_images"
    SCORES_FID = True

    def __init__(self, cfg: Config, data_root: Optional[str] = None,
                 workdir: str = ".",
                 device: Union[str, torch.device, None] = None):
        self.workdir = workdir
        if dist.is_initialized():
            device = rank_device(device)
        self.device = resolve_device(device)
        self.mesh = build_trainer_mesh(cfg, workdir)
        self.rank = process_index() if self.mesh is not None else 0
        if self.mesh is not None and self.mesh.pipe > 1:
            # the pipe ranks train as replicas: correct, but duplicated
            print(f"WARNING: mesh axis 'pipe'={self.mesh.pipe}: the CLI "
                  "trainer does not pipeline — use train/step."
                  "build_pp_train_step + parallel/pp.pp_split_state "
                  "(docs/PARALLELISM.md) to actually exploit it",
                  flush=True)
        if cfg.train.eval_fid and process_count() > 1:
            # per-process VFID over a stride of the test split would be
            # another statistic (p2p_tpu/train/loop.py:931-944)
            print("WARNING: eval_fid disabled on multi-process runs "
                  "(host-side feature accumulation is per-process).",
                  flush=True)
            cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                        eval_fid=False))
        self.cfg = cfg
        # cfg.data.batch_size is the global batch; each process loads its
        # stride of it
        self.local_bs = local_batch_size(cfg.data.batch_size, self.mesh)
        self.local_test_bs = local_batch_size(cfg.data.test_batch_size,
                                              self.mesh)
        if cfg.train.debug_nans:
            enable_nan_debugging()
        if cfg.train.compilation_cache_dir:
            # before any kernel is built: the libraries land in (and are
            # reused from) this directory (core/cache.py)
            enable_compilation_cache(cfg.train.compilation_cache_dir)
        root = data_root or os.path.join(cfg.data.root, cfg.data.dataset)
        self.train_ds, self.test_ds = self._datasets(root)
        self.steps_per_epoch = max(1, len(self.train_ds)
                                   // cfg.data.batch_size)
        self.dtype = train_dtype(cfg.train.mixed_precision)
        self.vgg = (load_vgg19(device=self.device,
                               imagenet_norm=cfg.loss.vgg_imagenet_norm)
                    if self._needs_vgg() else None)
        self.fid_feature_fn = self.vgg_source = None
        if cfg.train.eval_fid and self.SCORES_FID:
            self.vgg_source = "pretrained" if vgg19_npz_path() else "random"
            if self.vgg_source != "pretrained":
                print("WARNING: VFID will use RANDOM VGG19 features (no "
                      "pretrained npz asset found) — distances are not "
                      "comparable to real VFID/FID numbers.", flush=True)
            self.fid_feature_fn = make_vgg_feature_fn(self.vgg)
        self.state = self._create_state()
        if self.mesh is not None:
            place_state(self.state, self.mesh, cfg.parallel.fsdp_params,
                        cfg.parallel.tp_min_ch)
        self.train_step, self.eval_step = self._build_steps()
        self.logger = MetricsLogger(metrics_path(workdir, cfg.name),
                                    cfg.train.log_every)
        self.obs = self.logger.registry
        # after the logger: retry, corruption and sidecar counters belong
        # to this run's registry
        self.ckpt = CheckpointManager(os.path.join(
            workdir, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name),
            registry=self.obs)
        self.plateau = (PlateauController()
                        if cfg.optim.lr_policy == "plateau" else None)
        self.epoch = cfg.train.epoch_count
        self.preempt: Optional[PreemptionGuard] = None
        self._preempted = False
        self._workers: Optional[LoaderWorkers] = None
        init_trainer_obs(self)

    def _needs_vgg(self) -> bool:
        """VGG19 is loaded for the perceptual or style loss or for VFID
        (``p2p_tpu/train/loop.py:946``)."""
        L = self.cfg.loss
        return (L.lambda_vgg > 0 or L.lambda_style > 0
                or (self.cfg.train.eval_fid and self.SCORES_FID))

    def _loader_workers(self) -> int:
        """Loader worker processes of the train split: ``data.threads``
        for a split of more than 64 items that is not memoized (workers
        would each start with an empty memo; ``p2p_tpu/train/loop.py:
        1237``), else none."""
        ds = self.train_ds
        if getattr(ds, "cache_enabled", False) or len(ds) <= 64:
            return 0
        return self.cfg.data.threads

    def _train_workers(self) -> Optional[LoaderWorkers]:
        """The train split's worker pool, started by the first epoch that
        wants one and kept for the run (``fit`` closes it)."""
        n = self._loader_workers()
        if n > 0 and self._workers is None:
            self._workers = LoaderWorkers(self.train_ds, n)
        return self._workers if n > 0 else None

    def close_workers(self) -> None:
        """Stop the train split's loader workers, if any were started."""
        if self._workers is not None:
            self._workers.close()
            self._workers = None

    def _datasets(self, root: str):
        """The train and test splits under ``root``."""
        cfg = self.cfg
        ds_dtype = "uint8" if cfg.data.uint8_pipeline else "float32"
        return (PairedImageDataset(
            root, "train", cfg.data.direction, cfg.data.image_size,
            cfg.data.image_width, augment=cfg.data.augment, dtype=ds_dtype),
            PairedImageDataset(
                root, "test", cfg.data.direction, cfg.data.image_size,
                cfg.data.image_width, dtype=ds_dtype))

    def _create_state(self):
        """The initial train state (under ``int8_delayed`` its stored
        scales set from the first train pair)."""
        cfg = self.cfg
        sample = None
        if cfg.model.int8_delayed:
            item = self.train_ds[0]
            sample = {k: np.broadcast_to(v, (cfg.data.batch_size,) + v.shape
                                         ).copy() for k, v in item.items()}
        return create_train_state(
            cfg, cfg.train.seed, self.steps_per_epoch, self.dtype,
            self.device, sample_batch=sample)

    def _build_steps(self):
        """``(train_step, eval_step)``: data parallel on a mesh; under a
        spatial split the train step takes this rank's rows of its batch
        slot's images (the eval step takes whole images)."""
        if self.mesh is not None:
            mesh = self.mesh
            step = make_parallel_train_step(self.cfg, mesh, self.vgg,
                                            self.dtype, self.steps_per_epoch)
            if mesh.spatial > 1:
                inner = step

                def step(state, batch):
                    return inner(state, shard_rows(batch, mesh))

            return step, make_parallel_eval_step(self.cfg, mesh, self.dtype)
        return (build_train_step(self.cfg, self.vgg, self.dtype,
                                 self.steps_per_epoch),
                build_eval_step(self.cfg, self.dtype))

    # ------------------------------------------------------------ resume
    def maybe_resume(self) -> bool:
        """Restore the newest intact checkpoint, if there is one, and
        re-enter the sample stream where it was saved: the restored step's
        epoch after its consumed samples (its sidecar's, or the step
        counter's). The step's recorded topology is reconciled with this
        launch's first (:func:`plan_elastic_restore`). Returns whether one
        was restored."""
        step = self.ckpt.latest_step()
        if step is None:
            return False
        # the step's sidecar, read once for every consumer below (a
        # corrupt one is counted once)
        aux = self.ckpt.restore_aux(int(step))
        plan = plan_elastic_restore(self, int(step), aux)
        try:
            with full_params(self.state), tp_full(self.state):
                restored = elastic_restore(self, int(step), plan)
        except CheckpointCorrupt as e:
            if self.cfg.health.ema_decay is not None:
                raise RuntimeError(
                    "restore failed with --ema_decay set: if these "
                    "checkpoints were saved WITHOUT the EMA generator, "
                    "resume without --ema_decay (EMA can only start on a "
                    f"fresh run); underlying: {e}") from e
            raise
        # the integrity fallback may have restored an older step than the
        # newest: the position follows the weights actually restored
        if restored != int(step):
            step = restored
            aux = self.ckpt.restore_aux(int(step))
        finish_elastic_restore(self, int(step), plan)
        arm_quant_init_warmup(self, int(step))
        done, mid = derive_resume_position(self, int(step), aux=aux)
        host_step = int(step)
        if plan is not None and "batch_rebase" in plan.chain:
            done, host_step = apply_batch_rebase(self, int(step), aux, plan,
                                                 done, mid)
        # a step inside an epoch re-enters that epoch (done + 1), the
        # loader skipping the samples it consumed
        self.epoch = max(self.cfg.train.epoch_count, 1 + done)
        # the restored schedulers count `done` epochs already: an epoch
        # label given with --epoch_count must not count them again
        eff = max(1, self.cfg.train.epoch_count - done)
        if eff != self.cfg.train.epoch_count:
            schedule = make_schedule(self.cfg.optim, self.steps_per_epoch,
                                     eff)
            for name in OPTS:
                opt = getattr(self.state, name, None)
                if opt is not None:
                    opt[1].lr_lambdas = [schedule]
        # the restored lr_scale may carry a cooldown (preempted during
        # one); the sidecar's lr_base is the plateau scale
        base = (aux or {}).get("lr_base")
        if base is not None and self.state.lr_scale != float(base):
            self.state.lr_scale = float(base)
        if self.plateau is not None:
            # the scale only ever falls: a resume keeps the reductions
            self.plateau.scale = self.state.lr_scale
        self._base_lr_scale = self._applied_lr_scale = self.state.lr_scale
        self._host_step = host_step
        return True

    # ------------------------------------------------------------- train
    def current_lr(self) -> float:
        """G's effective learning rate of the last applied step: the
        schedule's value (the JAX state's ``inject_hyperparams``) times
        ``lr_scale`` (plateau scale × cooldown)."""
        _, scheduler = self.state.opt_g
        return (scheduler.base_lrs[0]
                * scheduler.lr_lambdas[0](max(scheduler.last_epoch - 1, 0))
                * self.state.lr_scale)

    def train_epoch(self, seed: Optional[int] = None,
                    skip_samples: int = 0) -> Dict[str, float]:
        """One pass over the train split (after its first
        ``skip_samples`` samples); returns the epoch's metric means and
        ``RATE_KEY`` (images, or clip frames, a second) over the steps
        after the first. Stops early when the ladder asks for a rollback or a
        preemption is requested (``fit`` acts on both)."""
        cfg = self.cfg
        seed = (self.epoch if seed is None else seed) + self._seed_jitter
        self.train_ds.aug_seed = cfg.train.seed + seed
        loader = make_loader(self.train_ds, self.local_bs,
                             shuffle=True, seed=cfg.train.seed + seed,
                             skip_samples=skip_samples,
                             workers=self._train_workers(),
                             **self._shard())
        sums: Optional[Dict[str, torch.Tensor]] = None
        count = last_logged = 0
        disp_hist = self.obs.histogram("dispatch_secs")
        t0 = time.perf_counter()
        for batch in device_prefetch(loader, self.device):
            # each epoch's first 4 steps land in the span ring, the rest
            # only in the histogram and the profiler's timeline
            cm = (self.spans.span("train_dispatch", steps=1,
                                  histogram=disp_hist) if count < 4
                  else timed_annotation("train_dispatch", disp_hist))
            with cm:
                self.state, metrics = self.train_step(self.state, batch)
            self._img_rate.mark(cfg.data.batch_size * cfg.data.n_frames)
            queue_health_observation(self, metrics)
            if self._quant_freeze_remaining:
                hold_frozen_quant(self)
            if cfg.debug.check_finite:
                # a fence: the nonfinite record lands before the raise
                check_finite(metrics, "step_metrics", registry=self.obs)
            masked = mask_skipped(metrics)
            sums = (dict(masked) if sums is None
                    else {k: sums[k] + v for k, v in masked.items()})
            count += 1
            if count == 1:
                t0 = time.perf_counter()
            if count - last_logged >= cfg.train.log_every:
                last_logged = count
                self.logger.log({"kind": "train", "epoch": self.epoch,
                                 "step": self.state.step,
                                 "samples": self._samples_seen,
                                 **{k: float(v) for k, v in metrics.items()}},
                                force=True)
            if self.health is not None and self.health.rollback_pending:
                break
            if poll_preempt(self):
                self._preempted = True
                break
        flush_health_observations(self)
        if cfg.debug.nan_sentinel:
            read_sentinels()
        if sums is None:
            return {}
        keys = list(sums)
        host = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
        elapsed = time.perf_counter() - t0
        out = epoch_metric_means(dict(zip(keys, host)), count)
        if count > 1:
            out[self.RATE_KEY] = ((count - 1) * cfg.data.batch_size
                                  * cfg.data.n_frames / max(elapsed, 1e-9))
        return out

    # -------------------------------------------------------------- eval
    def evaluate(self, save_samples: bool = False) -> Dict[str, float]:
        """Score every test image; with ``save_samples`` write the first
        batch's first input, target, prediction and (with a compression
        net) G's quantized input as PNGs."""
        with self.spans.span("evaluate", epoch=self.epoch):
            return self._evaluate(save_samples)

    def _shard(self) -> Dict[str, int]:
        """The loader's sharding: by the mesh's batch slot (spatial peers
        read the same samples and keep their own rows), else one
        process."""
        if self.mesh is None:
            return {"n_proc": 1, "pid": 0}
        return {"n_proc": self.mesh.batch_shards,
                "pid": self.mesh.batch_rank}

    def _evaluate(self, save_samples: bool) -> Dict[str, float]:
        cfg = self.cfg
        n_proc = self._shard()["n_proc"]
        # every image on one process; on more, equal batch counts (the
        # stride shards drop the split's remainder, as JAX's multi-host
        # eval does)
        loader = make_loader(self.test_ds, self.local_test_bs,
                             shuffle=False, num_epochs=1,
                             drop_remainder=n_proc > 1, **self._shard())
        psnrs: List[torch.Tensor] = []
        ssims: List[torch.Tensor] = []
        fid = (FIDEvaluator(self.fid_feature_fn)
               if self.fid_feature_fn is not None else None)
        saved = False
        with full_params(self.state), self._eval_weights():
            for batch in device_prefetch(loader, self.device):
                pred, metrics = self._eval_batch(batch)
                psnrs.append(metrics["psnr"])
                ssims.append(metrics["ssim"])
                if fid is not None:
                    fid.update(to_device_image(batch["target"],
                                               self.device),
                               pred.permute(0, 3, 1, 2))
                if save_samples and not saved and self.rank == 0:
                    self._save_samples(batch, pred)
                    saved = True
        p = (torch.cat(psnrs).cpu().numpy() if psnrs
             else np.zeros(0, np.float32))
        s = (torch.cat(ssims).cpu().numpy() if ssims
             else np.zeros(0, np.float32))
        if self.mesh is not None and (self.mesh.spatial_rank > 0
                                      or self.mesh.model_rank > 0
                                      or self.mesh.pipe_rank > 0):
            # spatial and model peers scored the same whole images: one
            # of them enters the combine with them
            p, s = p[:0], s[:0]
        if process_count() > 1:
            pm, px, sm, sx, n_total = combine_process_metric_stats(p, s)
            result = {"psnr_mean": pm, "psnr_max": px, "ssim_mean": sm,
                      "ssim_max": sx, self.EVAL_COUNT_KEY: n_total}
        else:
            result = {"psnr_mean": float(np.mean(p)),
                      "psnr_max": float(np.max(p)),
                      "ssim_mean": float(np.mean(s)),
                      "ssim_max": float(np.max(s)),
                      self.EVAL_COUNT_KEY: len(p)}
        if fid is not None and fid.real.n > 1:
            result["vfid"] = fid.compute()
            if self.vgg_source != "pretrained":
                result["vfid_feature_source"] = self.vgg_source
        self.logger.log({"kind": "eval", "epoch": self.epoch, **result})
        return result

    def _eval_weights(self):
        """The weights the eval scores: G's, or the EMA's when the state
        carries one (for the whole eval)."""
        return eval_weights(self.state)

    def _eval_batch(self, batch):
        """``(pred, metrics)`` of one test batch."""
        return self.eval_step(self.state, batch)

    def _save_samples(self, batch, pred: torch.Tensor) -> None:
        out_dir = os.path.join(self.workdir, self.cfg.train.result_dir,
                               self.cfg.data.dataset)
        os.makedirs(out_dir, exist_ok=True)

        def first(x) -> np.ndarray:
            return ingest(torch.as_tensor(x[:1]))[0].float().cpu().numpy()

        images = {"input": first(batch["input"]),
                  "target": first(batch["target"]), "pred": first(pred)}
        net_c = self.state.net_c
        if net_c is not None:
            net_c.eval()
            try:
                with torch.inference_mode():
                    real_b = to_device_image(batch["target"][:1],
                                             self.device, self.dtype)
                    comp = compressed_input(net_c, real_b,
                                            self.cfg.model.quant_bits)
            finally:
                net_c.train()
            images["comp"] = first(comp.permute(0, 2, 3, 1))
        if self.cfg.train.save_masks:
            # the reference's commented masking experiment: the bitwise
            # AND of the uint8 prediction and input
            images["mask"] = np.bitwise_and(to_uint8_img(images["pred"]),
                                            to_uint8_img(images["input"]))
        for k, img in images.items():
            save_img(img, os.path.join(out_dir, f"e{self.epoch}_{k}.png"))

    # --------------------------------------------------------------- fit
    def fit(self, nepoch: Optional[int] = None) -> List[Dict[str, float]]:
        """Epochs ``self.epoch`` through ``nepoch`` (default
        ``cfg.train.nepoch``): train, eval, log, checkpoint. Raises
        :class:`Preempted` after a preemption's save and
        :class:`DivergenceError` when the ladder is exhausted; the
        epilogue (span export, health summary, flush) runs on every
        exit."""
        cfg = self.cfg
        nepoch = nepoch or cfg.train.nepoch
        history = []
        armed_builds = False
        self._preempted = False
        owned_guard = acquire_preempt_guard(self)
        try:
            install_trainer_hooks(self)
            while self.epoch <= nepoch:
                t0 = time.time()
                skip_s = self._resume_skip_samples
                self._resume_skip_samples = 0
                rollback = False
                with self.spans.span("epoch", epoch=self.epoch):
                    train_metrics = self.train_epoch(seed=self.epoch,
                                                     skip_samples=skip_s)
                    record = {"epoch": self.epoch, "sec": time.time() - t0,
                              **train_metrics, "lr": self.current_lr()}
                    rollback = (self.health is not None
                                and self.health.rollback_pending)
                    if cfg.train.eval_every_epoch and not self._preempted \
                            and not rollback:
                        record.update(self.evaluate(save_samples=True))
                if self._preempted:
                    # a partial epoch writes no epoch record
                    finish_preempted(self)
                if rollback:
                    # the diverged partial epoch writes no epoch record
                    perform_rollback(self)
                    continue
                self._epoch_samples_done = 0
                history.append(record)
                self.logger.log({"kind": "epoch", **record}, force=True)
                self.memwatch.sample(self.logger)
                if self.plateau is not None and "loss_g" in record:
                    self._base_lr_scale = self.plateau.update(
                        record["loss_g"])
                    apply_health_lr(self)
                if self.epoch % cfg.train.epoch_save == 0 \
                        or self.epoch == nepoch:
                    with self.spans.span("checkpoint_save",
                                         epoch=self.epoch):
                        saved = save_trainer_ckpt(self)
                    # the rollback target: a step whose eval came back
                    psnr = record.get("psnr_mean")
                    if psnr is not None and np.isfinite(psnr) \
                            and self.rank == 0:
                        self.ckpt.mark_good(saved)
                if not armed_builds:
                    # the first completed epoch loaded every library: a
                    # build from here on is unexpected
                    self.retrace.arm()
                    armed_builds = True
                self.epoch += 1
        finally:
            self.close_workers()
            release_preempt_guard(self, owned_guard)
            close_trainer_obs(self)
            if self.rank == 0:
                self.spans.export_perfetto(self._trace_path)
            log_health_summary(self)
            self.logger.registry.flush()
        return history
