"""Restore-time state migration, the data-axis part (counterpart of
``p2p_tpu/resilience/reshape.py``: ``:92 ElasticPlan``, ``:140
elastic_restore``, ``:262 _moment_roots``, ``:275 _dtype_cast``, ``:344
rebase_step_counters``, ``:367 apply_batch_rebase`` and ``:62
MOMENT_MIGRATION``).

``train/loop.plan_elastic_restore`` classifies the delta between a
checkpoint's recorded topology and the relaunch's (``core/mesh.
classify_topology_delta``) and returns an :class:`ElasticPlan`;
:func:`elastic_restore` executes it:

- ``reshard`` (process count, data, fsdp or spatial width, device
  count; the JAX classification's, ``p2p_tpu/core/mesh.py:216-219``): every
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

``pp_restructure`` and ``tp_amax_recalibrate`` need the pipe and model
axes: a chain that names them raises ``TopologyMismatch`` (slice 13c).
The manifest of the step on disk names the bytes on disk, which a cast on
load does not change, so it is not rewritten.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from p2p_tpu_torch.core.mesh import TopologyMismatch

RESHAPE_TRANSFORMS = ("batch_rebase", "pp_restructure",
                      "tp_amax_recalibrate", "dtype_cast")
#: the transforms of a later slice
LATER_TRANSFORMS = {"pp_restructure": "13c", "tp_amax_recalibrate": "13c"}

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
            f"cannot resume through {'+'.join(later)}: the pipe and model "
            f"axes come with slice 13c ({detail}); relaunch on the "
            "original pipe and model widths")


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


def elastic_restore(tr, step: int, plan: Optional[ElasticPlan]):
    """Restore trainer ``tr``'s state in place at ``step`` per ``plan``
    (None: same topology; a reshard is the same plain load), then run
    the plan's restore-time transforms (``batch_rebase`` runs later, from
    ``maybe_resume``). Returns the step restored (an older intact one
    when the newest fails its checksums)."""
    if plan is not None:
        check_ported_chain(plan.chain)
    tr.ckpt.restore(tr.state)
    if tr.ckpt.last_restored_step is not None:
        step = int(tr.ckpt.last_restored_step)
    if plan is not None and "dtype_cast" in plan.chain:
        _dtype_cast(tr, int(step), plan)
    return int(step)


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
