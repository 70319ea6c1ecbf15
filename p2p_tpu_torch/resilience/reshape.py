"""Restore-time state migration (counterpart of
``p2p_tpu/resilience/reshape.py``: ``:92 ElasticPlan``, ``:108
pp_width_of``, ``:120 _pp_template_at_width``, ``:140 elastic_restore``,
``:190 _pp_restructure``, ``:214 _tp_amax_recalibrate``, ``:262
_moment_roots``, ``:275 _dtype_cast``, ``:344 rebase_step_counters``,
``:367 apply_batch_rebase``, ``:423 arm_quant_init_warmup``, ``:459
hold_frozen_quant`` and ``:62 MOMENT_MIGRATION``).

``train/loop.plan_elastic_restore`` classifies the delta between a
checkpoint's recorded topology and the relaunch's (``core/mesh.
classify_topology_delta``) and returns an :class:`ElasticPlan`;
:func:`elastic_restore` executes it:

- ``reshard`` (process count, data, fsdp, spatial, time or model width
  (without delayed-int8 state), device count; the JAX classification's,
  ``p2p_tpu/core/mesh.py:216-219``): every
  checkpoint is in the one-device format (rank 0 writes it with the ZeRO
  ranges gathered, train/loop.py ``save_trainer_ckpt``), so a reshard is a
  plain load onto the new world, each sharded optimizer cutting its range
  (parallel/rules.py);
- ``migrate`` through ``dtype_cast`` (``--cast_on_restore``): the load
  casts the moments into the current optimizer's storage dtype, the cast
  is logged (leaf count and examples against the step's manifest) and the
  Adam moments follow :data:`MOMENT_MIGRATION` (``"reinit"`` zeroes them);
- ``migrate`` through ``batch_rebase`` (a global-batch change) runs after
  the resume position is derived (:func:`apply_batch_rebase`): the epoch
  position, the step and optimizer counters and the loader's skip are
  re-derived from the sidecar's cumulative ``samples_seen``.

- ``migrate`` through ``pp_restructure`` (a pipe-width change): every
  checkpoint is flat (a split state is saved through parallel/pp.py
  ``pp_full``), so the restore merges a split live state, loads, and
  re-splits at the run's width (:func:`_pp_template_at_width`); the
  record names ``stages_saved`` (the sidecar's ``pp_stages``) and
  ``stages_current``. The CLI trainer runs flat on a pipe mesh, so its
  runs record 1 on both sides, as JAX's do;
- ``migrate`` through ``tp_amax_recalibrate`` (a model-width change under
  delayed-int8 state): every stored amax, a split trunk's included, is
  remapped by ``ops/int8.reshard_amax`` (the port's are per-tensor, so
  they keep their bits), the record logged, and with
  ``--recalibrate_steps`` N the scales are held frozen for N steps
  (:func:`hold_frozen_quant`, then a ``recalibrate_done`` record).

A plain model-width change is a ``reshard``: every checkpoint holds the
whole tensors (parallel/tp.py ``tp_full``), which a restore cuts to the
shards. A restore that initialized int8 scales the checkpoint lacked
(wider int8 coverage: ``CheckpointManager.last_restore_initialized_
quant``) logs a ``quant_init`` record and arms the same frozen window
(:func:`arm_quant_init_warmup`). The manifest of the step on disk names
the bytes on disk, which a cast on load does not change, so it is not
rewritten.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from p2p_tpu_torch.core.mesh import MODEL_AXIS, TopologyMismatch

RESHAPE_TRANSFORMS = ("batch_rebase", "pp_restructure",
                      "tp_amax_recalibrate", "dtype_cast")
#: the transforms of a later slice (none: every transform is ported)
LATER_TRANSFORMS: dict = {}
#: the state fields whose networks hold stored int8 scales
QUANT_NETS = ("net_g", "net_d", "net_c", "pp_stages")

#: Adam-moment migration policy of a ``dtype_cast`` restore, keyed by
#: (saved moment dtype, current moment dtype), None meaning the f32
#: default: ``"cast"`` keeps the cast moments; a pair not in the table
#: re-initializes them (``"reinit"``)
MOMENT_MIGRATION = {
    (None, "bfloat16"): "cast",
    ("float32", "bfloat16"): "cast",
    ("bfloat16", None): "cast",
    ("bfloat16", "float32"): "cast",
    ("float16", "float32"): "cast",
    ("float32", "float16"): "cast",
    (None, "float16"): "cast",
    ("float16", None): "cast",
    (None, "float32"): "cast",
    ("float32", None): "cast",
}

OPT_FIELDS = ("opt_g", "opt_d", "opt_c", "opt_dt")


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """One reconciled restore decision; ``chain`` is empty for a plain
    reshard."""

    kind: str          # "reshard" | "migrate"
    chain: Tuple[str, ...]
    reason: str
    saved: dict
    current: dict


def check_ported_chain(chain, detail: str = "") -> None:
    """Raise ``TopologyMismatch`` for a transform of a later slice."""
    later = [t for t in chain if t in LATER_TRANSFORMS]
    if later:
        raise TopologyMismatch(
            f"cannot resume through {'+'.join(later)}: not ported yet "
            f"(slice {', '.join(LATER_TRANSFORMS[t] for t in later)}; "
            f"{detail})")


def _optimizer_states(optimizer) -> List[dict]:
    """The per-parameter state dicts an optimizer steps with (a sharded
    optimizer's inner one)."""
    inner = getattr(optimizer, "inner", optimizer)
    return [st for st in inner.state.values() if st]


def _moment_roots(opt) -> List[dict]:
    """The Adam moment holders of ``opt`` = (optimizer, scheduler): every
    per-parameter state with ``exp_avg`` and ``exp_avg_sq`` (Adam and
    ``AdamLP`` alike)."""
    return [st for st in _optimizer_states(opt[0])
            if "exp_avg" in st and "exp_avg_sq" in st]


def _pp_template_at_width(state, cfg, n_stages: int, steps_per_epoch: int,
                          mesh=None):
    """Re-express ``state`` (in place) at ``n_stages`` pipe stages (1 =
    flat): merge a split state, then split at the width; the live
    moments ride through both (``init_opt=False``). Collective over the
    pipe group when a stack holds one stage."""
    from p2p_tpu_torch.parallel.pp import (pp_merge_state, pp_split_state,
                                           pp_width_of)

    if pp_width_of(state) == n_stages:
        return state
    if getattr(state, "pp_stages", None) is not None:
        pp_merge_state(state, cfg, steps_per_epoch, mesh)
    if n_stages > 1:
        pp_split_state(state, cfg, mesh, steps_per_epoch, n_stages,
                       init_opt=False, place=mesh is not None)
    return state


def elastic_restore(tr, step: int, plan: Optional[ElasticPlan]):
    """Restore trainer ``tr``'s state in place at ``step`` per ``plan``
    (None: same topology; a reshard is the same plain load), then run
    the plan's restore-time transforms (``batch_rebase`` runs later, from
    ``maybe_resume``). A state split over a pipe mesh is restored flat
    (every checkpoint is) and split again at the run's width. Returns the
    step restored (an older intact one when the newest fails its
    checksums)."""
    from p2p_tpu_torch.parallel.pp import pp_full

    if plan is not None:
        check_ported_chain(plan.chain)
    with pp_full(tr.state, tr.cfg, tr.mesh, tr.steps_per_epoch):
        tr.ckpt.restore(tr.state)
    if tr.ckpt.last_restored_step is not None:
        step = int(tr.ckpt.last_restored_step)
    chain = plan.chain if plan is not None else ()
    if "pp_restructure" in chain:
        _pp_restructure(tr, int(step), plan)
    if "tp_amax_recalibrate" in chain:
        _tp_amax_recalibrate(tr, int(step), plan)
    if "dtype_cast" in chain:
        _dtype_cast(tr, int(step), plan)
    return int(step)


def _saved_axis(plan: ElasticPlan, axis: str, block: str = "saved") -> int:
    mesh = (getattr(plan, block).get("mesh") or {})
    return int(mesh.get(axis, 1) or 1)


def _pp_restructure(tr, step: int, plan: ElasticPlan) -> None:
    """The pipe-width migration's record: the checkpoint's stacking (the
    sidecar's ``pp_stages``; the restore above merged and re-split the
    live state at the run's width)."""
    from p2p_tpu_torch.parallel.pp import pp_width_of

    tr.logger.log(
        {"kind": "pp_restructure", "step": int(step),
         "stages_saved": int(plan.saved.get("pp_stages") or 1),
         "stages_current": pp_width_of(tr.state)},
        force=True)


def _amax_buffers(state) -> Dict[str, torch.Tensor]:
    """Every stored int8 scale of ``state`` by ``<field>.<buffer name>``."""
    out = {}
    for field in QUANT_NETS:
        net = getattr(state, field, None)
        if net is None:
            continue
        for name, b in net.named_buffers():
            if name.endswith("amax_x"):
                out[f"{field}.{name}"] = b
    return out


def _freeze_quant(tr, freeze: int) -> None:
    """Open the frozen-scale window: the current stored scales are held
    for ``freeze`` steps (:func:`hold_frozen_quant`)."""
    tr._quant_freeze_remaining = freeze
    tr._quant_frozen = ({k: b.detach().clone()
                         for k, b in _amax_buffers(tr.state).items()}
                        if freeze > 0 else None)


def _tp_amax_recalibrate(tr, step: int, plan: ElasticPlan) -> None:
    """Remap every stored amax by the closed-form width law, log it, and
    (``--recalibrate_steps``) open the frozen-scale window."""
    from p2p_tpu_torch.ops.int8 import reshard_amax

    w_old = _saved_axis(plan, MODEL_AXIS, "saved")
    w_new = _saved_axis(plan, MODEL_AXIS, "current")
    bufs = _amax_buffers(tr.state)
    with torch.no_grad():
        for b in bufs.values():
            b.copy_(reshard_amax(b, w_old, w_new))
    freeze = int(tr.cfg.train.recalibrate_steps or 0)
    _freeze_quant(tr, freeze)
    tr.logger.log(
        {"kind": "tp_amax_recalibrate", "step": int(step),
         "width_saved": w_old, "width_current": w_new,
         "amax_leaves": len(bufs), "recalibrate_steps": freeze},
        force=True)


def arm_quant_init_warmup(tr, step: int) -> None:
    """A restore that initialized stored scales the checkpoint lacked
    (``CheckpointManager.last_restore_initialized_quant``: wider int8
    coverage than the run that saved it): log a ``quant_init`` record and
    (``--recalibrate_steps``) hold the scales frozen over the window, the
    initialized ones at their init-batch values."""
    initialized = list(getattr(tr.ckpt, "last_restore_initialized_quant",
                               []) or [])
    if not initialized:
        return
    freeze = int(tr.cfg.train.recalibrate_steps or 0)
    tr.logger.log(
        {"kind": "quant_init", "step": int(step),
         "initialized_leaves": len(initialized), "paths": initialized[:16],
         "recalibrate_steps": freeze},
        force=True)
    if freeze > 0:
        _freeze_quant(tr, freeze)


def hold_frozen_quant(tr) -> None:
    """The ``--recalibrate_steps`` window: after each step while it is
    open, put the frozen stored scales back, so every step of the window
    quantizes with them while the rest of the state trains; the last one
    logs ``recalibrate_done``."""
    n = int(getattr(tr, "_quant_freeze_remaining", 0) or 0)
    if n <= 0:
        return
    frozen = getattr(tr, "_quant_frozen", None)
    if not frozen:
        tr._quant_freeze_remaining = 0
        return
    live = _amax_buffers(tr.state)
    with torch.no_grad():
        for k, v in frozen.items():
            live[k].copy_(v)
    tr._quant_freeze_remaining = n - 1
    if tr._quant_freeze_remaining == 0:
        tr._quant_frozen = None
        tr.logger.log({"kind": "recalibrate_done",
                       "step": int(tr._host_step)}, force=True)


def _dtype_cast(tr, step: int, plan: ElasticPlan) -> None:
    """Log the cast of a ``dtype_cast`` restore (the state's tensors whose
    dtype differs from the step's manifest) and apply the moment
    migration policy."""
    from p2p_tpu_torch.train.checkpoint import state_fields, tensor_paths

    manifest = tr.ckpt.manifest(int(step))
    live = {}
    for name, obj in state_fields(tr.state, int(step), tr.epoch).items():
        for path, t in tensor_paths(obj):
            live[f"{name}.pt/{path}"] = str(t.dtype)
    cast_paths = []
    for fname, frec in manifest.items():
        for path, rec in frec["tensors"].items():
            key = f"{fname}/{path}"
            if key in live and live[key] != rec["dtype"]:
                cast_paths.append(key)
    saved_mdt = plan.saved.get("moment_dtype")
    cur_mdt = plan.current.get("moment_dtype")
    policy = "cast"
    if saved_mdt != cur_mdt:
        policy = MOMENT_MIGRATION.get((saved_mdt, cur_mdt), "reinit")
        if policy == "reinit":
            for f in OPT_FIELDS:
                opt = getattr(tr.state, f, None)
                if opt is None:
                    continue
                for st in _moment_roots(opt):
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].zero_()
    tr.logger.log(
        {"kind": "dtype_migration", "step": int(step),
         "mixed_precision": [plan.saved.get("mixed_precision"),
                             plan.current.get("mixed_precision")],
         "moment_dtype": [saved_mdt, cur_mdt],
         "moment_policy": policy,
         "cast_leaves": len(cast_paths),
         "examples": cast_paths[:5]},
        force=True)
    print(f"dtype migration (--cast_on_restore): {len(cast_paths)} "
          f"leaf(s) cast on restore of step {step}; moment policy "
          f"'{policy}'", flush=True)


def rebase_step_counters(state, new_step: int):
    """Set ``state.step``, every optimizer's per-parameter ``step`` (Adam's
    bias correction) and its scheduler's count (the LR schedule's, with
    the learning rate of the next update re-derived) to ``new_step``."""
    state.step = int(new_step)
    for f in OPT_FIELDS:
        opt = getattr(state, f, None)
        if opt is None:
            continue
        optimizer, scheduler = opt
        for st in _optimizer_states(optimizer):
            if "step" in st:
                st["step"] = (torch.full_like(st["step"], float(new_step))
                              if torch.is_tensor(st["step"])
                              else int(new_step))
        scheduler.last_epoch = int(new_step)
        lrs = [base * fn(int(new_step)) for base, fn in
               zip(scheduler.base_lrs, scheduler.lr_lambdas)]
        scheduler._last_lr = list(lrs)
        for group, lr in zip(optimizer.param_groups, lrs):
            group["lr"] = lr
    return state


def apply_batch_rebase(tr, step: int, aux, plan: ElasticPlan,
                       done: int, mid: int) -> Tuple[int, int]:
    """Re-derive the resume position from SAMPLES for a global-batch
    change; returns ``(done_epochs, rebased_step)``. The relaunch skips
    the flat prefix of ``epoch_samples_done`` samples (sample-granular,
    so an old-batch prefix the new batch does not divide still tiles
    gaplessly), and the counters rebase to ``done·spe_new +
    ceil(epoch_samples / B_new)``, which keeps every later epoch boundary
    on ``step % spe_new == 0``. Runs after ``derive_resume_position``."""
    b_old = int(plan.saved.get("global_batch") or tr.cfg.data.batch_size)
    b_new = int(tr.cfg.data.batch_size)
    spe_new = tr.steps_per_epoch
    if aux is None or (aux.get("samples_seen") is None
                       and aux.get("batches_done") is None):
        spe_old = max(1, len(tr.train_ds) // b_old)
        done, mid = divmod(int(step), spe_old)
        tr._samples_seen = int(step) * b_old
        tr._epoch_samples_done = mid * b_old
    es = int(tr._epoch_samples_done)
    new_step = done * spe_new + -(-es // b_new)
    rebase_step_counters(tr.state, new_step)
    tr._resume_skip_samples = es
    tr.logger.log(
        {"kind": "batch_rebase", "step": int(step),
         "rebased_step": int(new_step),
         "batch_saved": b_old, "batch_current": b_new,
         "samples_seen": int(tr._samples_seen),
         "epoch_samples_done": es,
         "steps_per_epoch": spe_new},
        force=True)
    print(f"batch re-base: global batch {b_old} -> {b_new}; step "
          f"{step} -> {new_step} (samples_seen={tr._samples_seen}, "
          f"epoch prefix {es} samples re-skipped sample-exact)",
          flush=True)
    return done, int(new_step)
