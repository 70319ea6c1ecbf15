"""Checkpoints of the port's train state (counterpart of the single-process
parts of ``p2p_tpu/train/checkpoint.py``: ``CheckpointManager.save``,
``restore``, ``latest_step``, ``max_to_keep``, ``CheckpointCorrupt``, the
per-array CRC32 manifest of ``:138 _leaf_checksums``, the iterator-state
sidecar, ``mark_good`` and the retry and chaos seams).

A step is a directory ``<directory>/<step>/`` with one ``torch.save``
file per top-level field of the state, so a reader loads only what it
needs (inference reads ``net_g`` and ``net_c``, as the JAX params-only
``restore_subtree`` does):

- ``net_g.pt``, ``net_d.pt``, ``net_c.pt`` and, for a video state
  (train/video_step.py), ``net_dt.pt``: each network's state_dict,
  parameters and buffers (BatchNorm running statistics, spectral-norm
  ``u`` of D and the temporal D, the delayed-int8 ``amax_x`` of G, D and
  net_c: the JAX ``quant_g``, ``quant_d`` and ``quant_c``, which
  ``restore_nets`` brings back with G and net_c for serving);
- ``opt_g.pt``, ``opt_d.pt``, ``opt_c.pt``, ``opt_dt.pt``: each
  optimizer's state_dict (Adam or ``AdamLP`` moments and counts) with its
  ``LambdaLR``'s;
- ``ema_g.pt``: the EMA generator's parameters, when the state carries
  one (``HealthConfig.ema_decay``);
- ``pool.pt``: the historical-fake ring ``pool`` and its count
  ``pool_n``, when the state carries them (``TrainConfig.pool_size``);
- ``progress.pt``: the step, the epoch label and ``lr_scale`` (the
  plateau policy's scale);
- ``manifest.json``: for every file its CRC32, and for every tensor in it
  its CRC32 over the logical-order bytes (``t.contiguous()``, whatever
  the memory format), shape and dtype.

A step is written into a temporary directory that is renamed into place,
so a torn save never becomes the newest step; the write is retried on
transient failures (``CKPT_POLICY``, seam ``ckpt_save``).
:meth:`CheckpointManager.restore` walks the steps from the newest down
and takes the first whose files and tensors match the manifest, counting
each step it passes over (``ckpt_corrupt_total``, a ``kind="ckpt_corrupt"``
record); when none does it raises :class:`CheckpointCorrupt`. An
explicitly named step falls back to no older one unless ``fallback=True``
(the rollback path). Loads use ``torch.load(..., weights_only=True)`` and
go through ``load_state_dict`` into the live modules and optimizers,
which keep their device and channels_last layout. The chaos seams
``ckpt_save``, ``ckpt_restore`` and ``ckpt_corrupt`` fail a save, a read
or a verification on demand (``P2P_CHAOS``).

Beside the steps, ``<directory>.aux/`` holds JSON sidecars, each written
to a temporary file that is renamed into place: ``<step>.json``, the
iterator state the trainer saves with every step (epoch, batches done,
samples seen, the shuffle's seed jitter, the base LR scale and the
topology: exact-step resume, train/loop.py ``save_trainer_ckpt``), and
``<step>.good.json``, the eval-validated mark the recovery ladder rolls
back to. A sidecar that does not parse reads as missing and is counted
(``aux_corrupt_total``, a ``kind="aux_corrupt"`` record);
:func:`peek_topology` reads the newest recorded topology block without a
manager, and raises :class:`SidecarCorrupt` when every sidecar is torn.
The quant-template reconciliation (``p2p_tpu/train/checkpoint.py:162
reconcile_quant_template``): a step saved under narrower int8 coverage
than the state it is restored into lacks some stored scales (``amax_x``);
they keep the state's initialized values, every other tensor is loaded,
and their paths are listed in ``last_restore_initialized_quant`` (empty
after a restore that needed none), which the trainer reports and may
hold frozen (resilience/reshape.py ``arm_quant_init_warmup``). Any other
missing or extra tensor still fails the load.

Data parallel: a step is always in the one-device format.
:func:`state_fields` gathers a ZeRO-sharded optimizer's moments and EMA
(parallel/rules.py; collective over the ``fsdp`` group, so every rank
calls it), rank 0 writes them (``save(..., fields=)``, train/loop.py
``save_trainer_ckpt``), and a restore cuts them to each rank's range.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from p2p_tpu_torch.resilience.chaos import FaultInjected, chaos_point
from p2p_tpu_torch.resilience.retry import CKPT_POLICY, retry_call
from p2p_tpu_torch.train.state import TrainState

# the fields a state may carry (an image state has no net_dt, a video state
# no net_c): each is saved and restored when the state has it
NETS = ("net_g", "net_d", "net_c", "net_dt")
OPTS = ("opt_g", "opt_d", "opt_c", "opt_dt")
EMA = "ema_g"
POOL = "pool"
PROGRESS = "progress"
MANIFEST = "manifest.json"


class SidecarCorrupt(RuntimeError):
    """Every iterator-state sidecar of a run failed to parse: its recorded
    topology cannot be reconciled (an error, not the None of a
    pre-elastic run)."""

    def __init__(self, directory: str, newest_step: int):
        self.directory = directory
        self.newest_step = newest_step
        super().__init__(
            f"every checkpoint sidecar under {directory}.aux is "
            f"torn/unreadable (newest attempted step: {newest_step}) — "
            "the run's recorded topology cannot be reconciled; inspect "
            "the .aux directory (restore a sidecar from backup, or "
            "delete the aux dir to resume with step-derived position "
            "AND pre-elastic topology semantics)")


def peek_topology(directory: str) -> Optional[Dict[str, Any]]:
    """The newest sidecar's recorded topology block under
    ``<directory>.aux`` (``p2p_tpu/train/checkpoint.py:101``), without a
    manager (which would create directories); None when no sidecar names
    one. Raises :class:`SidecarCorrupt` when sidecars exist and none
    parses."""
    aux_dir = os.path.abspath(directory) + ".aux"
    try:
        names = os.listdir(aux_dir)
    except OSError:
        return None
    steps = []
    for n in names:
        stem, dot, ext = n.partition(".")
        if dot and ext == "json" and stem.isdigit():
            steps.append(int(stem))
    torn = 0
    for s in sorted(steps, reverse=True):
        try:
            with open(os.path.join(aux_dir, f"{s}.json")) as f:
                topo = json.load(f).get("topology")
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            torn += 1
            continue
        if topo:
            return topo
    if steps and torn == len(steps):
        raise SidecarCorrupt(os.path.abspath(directory), max(steps))
    return None


class CheckpointCorrupt(RuntimeError):
    """No intact checkpoint could be restored: every step in scope failed
    its checksums or could not be read. Re-reading does not help."""

    def __init__(self, directory: str, tried: List[int],
                 last_error: Optional[str] = None):
        self.directory = directory
        self.tried = list(tried)
        cause = f"; last error: {last_error}" if last_error else ""
        super().__init__(f"no intact checkpoint under {directory} (tried "
                         f"steps {tried}){cause}")


def tensor_paths(obj: Any, prefix: str = ""
                 ) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a nested dict/list/tuple with its ``/`` path."""
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return []
    out = []
    for k, v in items:
        out.extend(tensor_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tensor_checksums(obj: Any) -> Dict[str, Dict[str, Any]]:
    """``{path: {crc32, shape, dtype}}`` over the tensors of ``obj``, each
    CRC taken over its bytes in logical (contiguous) order."""
    out = {}
    for path, t in tensor_paths(obj):
        flat = t.detach().cpu().contiguous().reshape(-1)
        out[path] = {"crc32": zlib.crc32(flat.view(torch.uint8).numpy()),
                     "shape": list(t.shape), "dtype": str(t.dtype)}
    return out


def _opt_state(opt) -> Dict[str, Any]:
    optimizer, scheduler = opt
    return {"optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict()}


def state_fields(state: TrainState, step: int, epoch: int
                 ) -> Dict[str, Any]:
    """The files of a step of ``state`` in the one-device format: each
    network's state_dict, each optimizer's with its scheduler's, the EMA,
    the pool and the progress. Collective when the state is ZeRO-sharded
    (every rank calls it, in one order)."""
    from p2p_tpu_torch.parallel.rules import ema_state

    fields: Dict[str, Any] = {PROGRESS: {
        "step": int(step), "epoch": int(epoch),
        "lr_scale": float(state.lr_scale)}}
    for name in NETS:
        net = getattr(state, name, None)
        if net is not None:
            fields[name] = net.state_dict()
    for name in OPTS:
        opt = getattr(state, name, None)
        if opt is not None:
            fields[name] = _opt_state(opt)
    if getattr(state, EMA, None) is not None:
        fields[EMA] = ema_state(state.ema_g)
    if getattr(state, POOL, None) is not None:
        fields[POOL] = {"pool": state.pool, "pool_n": state.pool_n}
    return fields


def _copy_exact(live: Dict[str, torch.Tensor],
                saved: Dict[str, torch.Tensor], what: str) -> None:
    """Copy ``saved`` into the tensors of ``live`` (same names, shapes and
    dtypes, else ``ValueError``)."""
    if set(live) != set(saved):
        raise ValueError(f"{what}: the checkpoint holds "
                         f"{sorted(set(saved) ^ set(live))[:3]} where the "
                         "state differs")
    for k, t in live.items():
        if saved[k].shape != t.shape or saved[k].dtype != t.dtype:
            raise ValueError(f"{what}/{k}: {tuple(saved[k].shape)} "
                             f"{saved[k].dtype} in the checkpoint, "
                             f"{tuple(t.shape)} {t.dtype} in the state")
        t.copy_(saved[k])


def _load_net(net: nn.Module, saved: Dict[str, torch.Tensor], name: str
              ) -> List[str]:
    """Load ``saved`` into ``net`` strictly, except that stored int8 scales
    (``amax_x``) the step lacks keep ``net``'s values; returns their
    paths (``<net>/<buffer>``)."""
    live = net.state_dict()
    grafted = sorted(k for k in set(live) - set(saved)
                     if k.endswith("amax_x"))
    if grafted:
        saved = {**saved, **{k: live[k] for k in grafted}}
    net.load_state_dict(saved, strict=True)
    return [f"{name}/{k}" for k in grafted]


class CheckpointManager:
    """Steps of one run under ``directory``; the newest ``max_to_keep``
    are kept (all with None). Retry, corruption and sidecar counters go
    to ``registry`` (the process default when None)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 registry=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._registry = registry
        self._aux_dir = self.directory + ".aux"
        # the step the last restore returned (older than the one asked for
        # when that one failed its checksums)
        self.last_restored_step: Optional[int] = None
        self.last_restore_initialized_quant: List[str] = []

    def _reg(self):
        if self._registry is None:
            from p2p_tpu_torch.obs import get_registry

            self._registry = get_registry()
        return self._registry

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: TrainState, epoch: int,
             fields: Optional[Dict[str, Any]] = None) -> bool:
        """Write ``state`` (and the epoch label) as step ``step``, or the
        ``fields`` :func:`state_fields` gathered from it. A step already
        on disk is left as it is (returns False)."""
        final = self.step_dir(step)
        if os.path.exists(final):
            return False
        if fields is None:
            fields = state_fields(state, step, epoch)
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")

        def _save():
            chaos_point("ckpt_save", step=int(step))
            self._write_step(tmp, final, int(step), fields)

        retry_call(_save, policy=CKPT_POLICY, seam="ckpt_save",
                   registry=self._reg())
        self._prune()
        return True

    @staticmethod
    def _write_step(tmp: str, final: str, step: int,
                    fields: Dict[str, Any]) -> None:
        """Write ``fields`` and their manifest into ``tmp``, then rename it
        to ``final``; a failure leaves no temporary directory behind."""
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "algo": "crc32", "files": {}}
        try:
            for name, obj in fields.items():
                buf = io.BytesIO()
                torch.save(obj, buf)
                data = buf.getvalue()
                with open(os.path.join(tmp, name + ".pt"), "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["files"][name + ".pt"] = {
                    "crc32": zlib.crc32(data),
                    "tensors": tensor_checksums(obj)}
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def read(self, step: int, names: Sequence[str]) -> Dict[str, Any]:
        """Load the fields ``names`` of step ``step``, each verified
        against the manifest (the file's CRC before it is unpickled, each
        tensor's after). Raises ``ValueError`` on any mismatch and
        ``FileNotFoundError`` on a missing file."""
        d = self.step_dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)["files"]
        out = {}
        for name in names:
            rec = manifest.get(name + ".pt")
            if rec is None:
                raise FileNotFoundError(f"step {step} has no {name}")
            with open(os.path.join(d, name + ".pt"), "rb") as f:
                data = f.read()
            if zlib.crc32(data) != rec["crc32"]:
                raise ValueError(f"{name}.pt fails its CRC32")
            obj = torch.load(io.BytesIO(data), map_location="cpu",
                             weights_only=True)
            if tensor_checksums(obj) != rec["tensors"]:
                raise ValueError(f"{name}.pt: tensors fail their CRC32")
            out[name] = obj
        return out

    def manifest(self, step: int) -> Dict[str, Any]:
        """The ``files`` record of step ``step``'s manifest."""
        with open(os.path.join(self.step_dir(step), MANIFEST)) as f:
            return json.load(f)["files"]

    def verify(self, step: int) -> List[str]:
        """The problems of step ``step`` (empty when every file and tensor
        matches its manifest)."""
        try:
            with open(os.path.join(self.step_dir(step), MANIFEST)) as f:
                files = json.load(f)["files"]
            self.read(step, [n[:-3] for n in files])
        except (OSError, ValueError, RuntimeError, KeyError) as e:
            return [f"{type(e).__name__}: {e}"]
        return []

    def _note_corrupt(self, step: int, reason: str) -> None:
        reg = self._reg()
        reg.counter("ckpt_corrupt_total").inc()
        reg.record({"kind": "ckpt_corrupt", "step": int(step),
                    "reason": reason[:500]}, force=True)
        print(f"WARNING: checkpoint step {step} failed integrity "
              f"({reason}) — falling back to the previous intact step",
              flush=True)

    def _restore(self, step: Optional[int], names: Sequence[str],
                 fallback: Optional[bool] = None
                 ) -> Tuple[int, Dict[str, Any]]:
        """The newest step at or below ``step`` (the newest of all with
        None) whose ``names`` verify, with those fields. ``fallback``
        (default: only when no step is named) lets a step that fails its
        checks give way to the next older one; each failure is counted."""
        if fallback is None:
            fallback = step is None
        steps = self.all_steps()
        if step is not None:
            if int(step) not in steps:
                raise FileNotFoundError(f"no checkpoint at step {step} "
                                        f"(have {steps})")
            steps = [s for s in steps if s <= int(step)]
        if not fallback:
            steps = steps[-1:]
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        tried, last = [], None

        def _read(s: int) -> Dict[str, Any]:
            chaos_point("ckpt_restore", step=s)
            return self.read(s, names)

        for s in reversed(steps):
            tried.append(s)
            try:
                fields = retry_call(_read, s, policy=CKPT_POLICY,
                                    seam="ckpt_restore",
                                    registry=self._reg())
                chaos_point("ckpt_corrupt", step=s)
            except FaultInjected as e:
                last = f"step {s}: {e}"
                self._note_corrupt(s, f"<chaos:{e.seam}>")
                continue
            except (OSError, ValueError, RuntimeError) as e:
                last = f"step {s}: {type(e).__name__}: {e}"
                self._note_corrupt(s, f"{type(e).__name__}: {e}")
                continue
            self.last_restored_step = s
            return s, fields
        raise CheckpointCorrupt(self.directory, tried, last)

    def restore(self, state: TrainState, step: Optional[int] = None,
                fallback: Optional[bool] = None) -> Tuple[int, int]:
        """Load the whole state in place from the newest intact step (or
        ``step``; with ``fallback=True`` the newest intact step at or
        below it); returns ``(step, epoch)`` and sets ``state.step``."""
        names = [n for n in NETS + OPTS + (EMA, POOL)
                 if getattr(state, n, None) is not None]
        s, fields = self._restore(step, names + [PROGRESS], fallback)
        self.last_restore_initialized_quant = []
        for name in NETS:
            if name in fields:
                self.last_restore_initialized_quant += _load_net(
                    getattr(state, name), fields[name], name)
        for name in OPTS:
            if name in fields:
                optimizer, scheduler = getattr(state, name)
                optimizer.load_state_dict(fields[name]["optimizer"])
                scheduler.load_state_dict(fields[name]["scheduler"])
        with torch.no_grad():
            if EMA in fields:
                if isinstance(state.ema_g, dict):
                    _copy_exact(state.ema_g, fields[EMA], EMA)
                else:
                    state.ema_g.load_state_dict(fields[EMA])
            if POOL in fields:
                _copy_exact({"pool": state.pool, "pool_n": state.pool_n},
                            fields[POOL], POOL)
        state.step = int(fields[PROGRESS]["step"])
        state.lr_scale = float(fields[PROGRESS].get("lr_scale", 1.0))
        return s, int(fields[PROGRESS]["epoch"])

    # -- last-good tracking (the recovery ladder's rollback target) -------
    def mark_good(self, step: int) -> None:
        """Mark ``step`` eval-validated: the recovery ladder rolls back to
        the newest marked step."""
        self._write_aux_json(f"{int(step)}.good.json", {"step": int(step)})

    def last_good_step(self) -> Optional[int]:
        """The newest ``mark_good`` step still on disk, else None."""
        steps = set(self.all_steps())
        try:
            names = os.listdir(self._aux_dir)
        except OSError:
            return None
        good = []
        for n in names:
            stem = n.split(".", 1)[0]
            if n.endswith(".good.json") and stem.isdigit() \
                    and int(stem) in steps:
                good.append(int(stem))
        return max(good) if good else None

    # -- iterator-state sidecar (exact-step resume) -----------------------
    def _write_aux_json(self, name: str, payload: Dict[str, Any]) -> None:
        """Write a JSON sidecar to a temporary file renamed into place (a
        kill mid-write leaves no torn sidecar), retried as a save."""
        os.makedirs(self._aux_dir, exist_ok=True)
        path = os.path.join(self._aux_dir, name)
        tmp = path + f".tmp.{os.getpid()}"

        def _write():
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)

        retry_call(_write, policy=CKPT_POLICY, seam="ckpt_save",
                   registry=self._reg())

    def _read_aux_json(self, name: str) -> Optional[Dict[str, Any]]:
        """A sidecar, or None when it is absent or does not parse; a
        corrupt one is counted (``aux_corrupt_total``, a
        ``kind="aux_corrupt"`` record) and the resume falls back to the
        position the step counter gives."""
        path = os.path.join(self._aux_dir, name)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            reg = self._reg()
            reg.counter("aux_corrupt_total").inc()
            reg.record({"kind": "aux_corrupt", "file": name,
                        "reason": repr(exc)[:200]}, force=True)
            print(f"WARNING: checkpoint sidecar {name} is corrupt "
                  f"({exc}) — treating as missing (resume falls back to "
                  "step-derived position)", flush=True)
            return None
        except OSError:
            return None

    def save_aux(self, step: int, payload: Dict[str, Any]) -> None:
        """Write the iterator-state sidecar of ``step``."""
        self._write_aux_json(f"{int(step)}.json", payload)

    def restore_aux(self, step: int) -> Optional[Dict[str, Any]]:
        """The sidecar saved with ``step``, or None."""
        return self._read_aux_json(f"{int(step)}.json")

    def restore_nets(self, net_g: nn.Module, net_c: Optional[nn.Module],
                     step: Optional[int] = None, ema: bool = False) -> int:
        """Load G (and net_c) only from the newest step whose ``net_g``
        (and ``net_c``) verify, or exactly ``step``; reads no optimizer or
        discriminator file. With ``ema`` G's parameters are the step's
        EMA generator (``ema_g``, which must be there) and its buffers
        its own. Returns the step."""
        names = (["net_g"] + (["net_c"] if net_c is not None else [])
                 + ([EMA] if ema else []))
        s, fields = self._restore(step, names)
        if ema:
            fields["net_g"] = {**fields["net_g"], **fields[EMA]}
        net_g.load_state_dict(fields["net_g"], strict=True)
        if net_c is not None:
            net_c.load_state_dict(fields["net_c"], strict=True)
        return s
