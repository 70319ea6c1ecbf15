"""Checkpoints of the port's train state (counterpart of the single-process
parts of ``p2p_tpu/train/checkpoint.py``: ``CheckpointManager.save``,
``restore``, ``latest_step``, ``max_to_keep``, ``CheckpointCorrupt`` and
the per-array CRC32 manifest of ``:138 _leaf_checksums``).

A step is a directory ``<directory>/<step>/`` with one ``torch.save``
file per top-level field of the state, so a reader loads only what it
needs (inference reads ``net_g`` and ``net_c``, as the JAX params-only
``restore_subtree`` does):

- ``net_g.pt``, ``net_d.pt``, ``net_c.pt``: each network's state_dict,
  parameters and buffers (BatchNorm running statistics, spectral-norm
  ``u``, the delayed-int8 ``amax_x`` of G, D and net_c: the JAX
  ``quant_g``, ``quant_d`` and ``quant_c``, which ``restore_nets`` brings
  back with G and net_c for serving);
- ``opt_g.pt``, ``opt_d.pt``, ``opt_c.pt``: each optimizer's state_dict
  (Adam or ``AdamLP`` moments and counts) with its ``LambdaLR``'s;
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
so a torn save never becomes the newest step. :meth:`CheckpointManager.
restore` walks the steps from the newest down and takes the first whose
files and tensors match the manifest; when none does it raises
:class:`CheckpointCorrupt`. Loads use ``torch.load(..., weights_only=True)``
and go through ``load_state_dict`` into the live modules and optimizers,
which keep their device and channels_last layout.

Not ported yet: the iterator-state sidecar, exact-step (mid-epoch)
resume, ``mark_good`` and rollback, the quant-template reconciliation and
the retry and chaos seams.
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

from p2p_tpu_torch.train.state import TrainState

NETS = ("net_g", "net_d", "net_c")
OPTS = ("opt_g", "opt_d", "opt_c")
EMA = "ema_g"
POOL = "pool"
PROGRESS = "progress"
MANIFEST = "manifest.json"


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


def _tensors(obj: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
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
        out.extend(_tensors(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tensor_checksums(obj: Any) -> Dict[str, Dict[str, Any]]:
    """``{path: {crc32, shape, dtype}}`` over the tensors of ``obj``, each
    CRC taken over its bytes in logical (contiguous) order."""
    out = {}
    for path, t in _tensors(obj):
        flat = t.detach().cpu().contiguous().reshape(-1)
        out[path] = {"crc32": zlib.crc32(flat.view(torch.uint8).numpy()),
                     "shape": list(t.shape), "dtype": str(t.dtype)}
    return out


def _opt_state(opt) -> Dict[str, Any]:
    optimizer, scheduler = opt
    return {"optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict()}


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


class CheckpointManager:
    """Steps of one run under ``directory``; the newest ``max_to_keep``
    are kept (all with None)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        # the step the last restore returned (older than the newest when
        # the newest failed its checksums)
        self.last_restored_step: Optional[int] = None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: TrainState, epoch: int) -> bool:
        """Write ``state`` (and the epoch label) as step ``step``. A step
        already on disk is left as it is (returns False)."""
        final = self.step_dir(step)
        if os.path.exists(final):
            return False
        fields: Dict[str, Any] = {PROGRESS: {
            "step": int(step), "epoch": int(epoch),
            "lr_scale": float(state.lr_scale)}}
        for name in NETS:
            net = getattr(state, name)
            if net is not None:
                fields[name] = net.state_dict()
        for name in OPTS:
            opt = getattr(state, name)
            if opt is not None:
                fields[name] = _opt_state(opt)
        if state.ema_g is not None:
            fields[EMA] = dict(state.ema_g)
        if state.pool is not None:
            fields[POOL] = {"pool": state.pool, "pool_n": state.pool_n}
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": int(step), "algo": "crc32", "files": {}}
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
        self._prune()
        return True

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

    def _restore(self, step: Optional[int], names: Sequence[str]
                 ) -> Tuple[int, Dict[str, Any]]:
        """The newest step at or below ``step`` (the newest of all with
        None) whose ``names`` verify, with those fields. A named step
        falls back to no older one."""
        steps = self.all_steps()
        if step is not None:
            if int(step) not in steps:
                raise FileNotFoundError(f"no checkpoint at step {step} "
                                        f"(have {steps})")
            steps = [int(step)]
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        tried, last = [], None
        for s in reversed(steps):
            tried.append(s)
            try:
                fields = self.read(s, names)
            except (OSError, ValueError, RuntimeError) as e:
                last = f"step {s}: {type(e).__name__}: {e}"
                continue
            self.last_restored_step = s
            return s, fields
        raise CheckpointCorrupt(self.directory, tried, last)

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[int, int]:
        """Load the whole state in place from the newest intact step (or
        exactly ``step``); returns ``(step, epoch)`` and sets
        ``state.step``."""
        names = [n for n in NETS + OPTS + (EMA, POOL)
                 if getattr(state, n) is not None]
        s, fields = self._restore(step, names + [PROGRESS])
        for name in NETS:
            if name in fields:
                getattr(state, name).load_state_dict(fields[name],
                                                     strict=True)
        for name in OPTS:
            if name in fields:
                optimizer, scheduler = getattr(state, name)
                optimizer.load_state_dict(fields[name]["optimizer"])
                scheduler.load_state_dict(fields[name]["scheduler"])
        with torch.no_grad():
            if EMA in fields:
                _copy_exact(state.ema_g, fields[EMA], EMA)
            if POOL in fields:
                _copy_exact({"pool": state.pool, "pool_n": state.pool_n},
                            fields[POOL], POOL)
        state.step = int(fields[PROGRESS]["step"])
        state.lr_scale = float(fields[PROGRESS].get("lr_scale", 1.0))
        return s, int(fields[PROGRESS]["epoch"])

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
