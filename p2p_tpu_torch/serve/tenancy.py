"""Several models resident in one serving process, each hot-swappable
under traffic (counterpart of ``p2p_tpu/serve/tenancy.py:46-220``).

A :class:`Tenant` is a config, a checkpoint directory, an engine and the
step it serves; :class:`ModelRegistry` is the alias → tenant map the HTTP
router reads.

:meth:`Tenant.reload` (``POST /admin/reload``):

1. restores only ``net_g`` (and ``net_c``) of the step, each file checked
   against the step's CRC32 manifest as it is read
   (``CheckpointManager.restore_nets``). It never verifies the whole step
   (``CheckpointManager.verify`` reads D and the Adam moments too,
   gigabytes for pix2pixHD, under live traffic). A missing checkpoint, a
   missing or unreadable manifest, a CRC mismatch or a shape mismatch
   raises :class:`HotSwapRejected`, and the old weights keep serving. A
   step that was named is never replaced by an older one. With
   ``ema_decay`` set in the tenant's config G's parameters are the step's
   EMA generator, as at construction;
2. ``InferenceEngine.swap_state``: the new copies on the device, one warm
   forward through a warmed bucket (no new warm-up), then one reference
   swap; forwards in flight finish on the old weights.

Counted per tenant: ``serve_hot_swaps_total`` and
``serve_hot_swap_rejected_total``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.serve.engine import (engine_from_checkpoint,
                                        serving_restore_template)


class HotSwapRejected(RuntimeError):
    """A reload was refused and the old weights keep serving."""

    def __init__(self, tenant: str, step: Optional[int], reason: str):
        self.tenant = tenant
        self.step = step
        super().__init__(
            f"hot-swap rejected for tenant {tenant!r} (step {step}): "
            f"{reason}; the previous weights keep serving")


def checkpoint_dir(cfg: Config, workdir: str) -> str:
    """Where ``train/loop.Trainer`` writes the checkpoints of ``cfg``:
    ``<workdir>/<checkpoint_dir>/<dataset>/<name>``."""
    return os.path.join(workdir, cfg.train.checkpoint_dir,
                        cfg.data.dataset, cfg.name)


class Tenant:
    """One resident model. Construction restores the newest intact step
    (or exactly ``step``); :meth:`warmup` runs every bucket once;
    :meth:`reload` swaps weights under traffic. ``engine_kw`` goes to the
    engine (buckets, dtype, device, io_workers)."""

    def __init__(self, alias: str, cfg: Config, ckpt_dir: str,
                 step: Optional[int] = None, registry=None, **engine_kw):
        if cfg.data.n_frames > 1:
            raise ValueError(
                f"tenant {alias!r}: serving covers image presets; video "
                "stays on cli/infer.py's clip path")
        self.alias = alias
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        if registry is None:
            from p2p_tpu_torch.obs import get_registry

            registry = get_registry()
        self.registry = registry
        self.engine, self.step = engine_from_checkpoint(
            cfg, ckpt_dir, step=step, **engine_kw)
        self._reload_lock = threading.Lock()
        self._swaps = registry.counter("serve_hot_swaps_total",
                                       tenant=alias)
        self._rejected = registry.counter("serve_hot_swap_rejected_total",
                                          tenant=alias)

    def warmup(self) -> "Tenant":
        self.engine.warmup()
        return self

    @property
    def swap_count(self) -> int:
        return int(self._swaps.value)

    def _reject(self, step: Optional[int], reason: str) -> HotSwapRejected:
        self._rejected.inc()
        return HotSwapRejected(self.alias, step, reason)

    def reload(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Hot-swap to ``step`` (default: the newest on disk). Returns a
        summary; raises :class:`HotSwapRejected` when the step is missing,
        corrupt or of another shape. Reloads are serialized; serving is
        never blocked."""
        from p2p_tpu_torch.train.checkpoint import CheckpointManager

        with self._reload_lock:
            mgr = CheckpointManager(self.ckpt_dir)
            target = mgr.latest_step() if step is None else int(step)
            if target is None:
                raise self._reject(None, f"no checkpoint under "
                                         f"{self.ckpt_dir}")
            net_g, net_c = serving_restore_template(self.cfg)
            try:
                mgr.restore_nets(net_g, net_c, step=target,
                                 ema=self.cfg.health.ema_decay is not None)
            except (OSError, ValueError, RuntimeError, KeyError) as e:
                raise self._reject(target, f"restore failed: {e!r}") from e
            try:
                self.engine.swap_state(net_g, net_c)
            except ValueError as e:
                raise self._reject(target, str(e)) from e
            prev, self.step = self.step, target
            self._swaps.inc()
            self.registry.record(
                {"kind": "hot_swap", "tenant": self.alias,
                 "from_step": int(prev), "to_step": int(target)},
                force=True)
            return {"tenant": self.alias, "from_step": int(prev),
                    "step": int(target), "swapped": True}

    def status(self) -> Dict[str, Any]:
        """The /healthz block of this tenant."""
        e = self.engine
        return {"step": int(self.step), "buckets": list(e.buckets),
                "n_warmups": int(e.n_warmups), "swaps": self.swap_count}


class ModelRegistry:
    """Alias → :class:`Tenant`, in insertion order. Tenants are added
    before serving starts; lookups are plain dict reads."""

    def __init__(self):
        self._tenants: Dict[str, Tenant] = {}

    def add(self, tenant: Tenant) -> Tenant:
        if tenant.alias in self._tenants:
            raise ValueError(f"duplicate tenant alias {tenant.alias!r}")
        self._tenants[tenant.alias] = tenant
        return tenant

    def get(self, alias: str) -> Tenant:
        return self._tenants[alias]

    def __contains__(self, alias: str) -> bool:
        return alias in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    def aliases(self) -> Tuple[str, ...]:
        return tuple(self._tenants)
