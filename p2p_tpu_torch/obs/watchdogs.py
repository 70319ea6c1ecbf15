"""Runtime watchdogs (counterpart of ``p2p_tpu/obs/watchdogs.py``): the
kernel-build watchdog and device-memory sampling.

RetraceWatchdog
    Eager PyTorch compiles no program per shape; what the port compiles is
    its CUDA kernel libraries (``ops/cuda/build.py``: one ``nvcc`` per
    source, reused from the build directory by a hash of the sources). The
    watchdog listens to those build events: a build counts as a compile
    (``xla_compiles``, ``xla_compile_secs``, and a cache miss,
    ``persistent_cache_misses``), the reuse of a built library as a cache
    hit (``persistent_cache_hits``); after :meth:`~RetraceWatchdog.arm`
    (once the first epoch has loaded every library) a build is unexpected
    (``unexpected_recompiles``, a ``kind="retrace"`` record and a
    warning). The counter names are the JAX watchdog's.

MemoryWatchdog
    Samples ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``
    into gauges and a ``kind="memory"`` record under the JAX record's keys.
    Quiet on the CPU: ``sample()`` returns {} when no card is in use.

``crosscheck_hbm_budget`` (the live fill against the static memory model)
waits for ``analysis/memory_audit`` (slice 12); :func:`budget_drift`, its
pure comparison, is here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch


class RetraceWatchdog:
    """Count kernel-library builds and reuses; warn on a build after
    :meth:`arm`."""

    def __init__(self, registry=None, logger=None):
        from p2p_tpu_torch.ops.cuda import build

        self.registry = registry
        self.logger = logger            # optional MetricsLogger for records
        self.compiles = 0               # builds since construction
        self.unexpected = 0             # builds seen while armed
        self.cache_hits = 0             # built libraries reused
        self.cache_misses = 0           # libraries that had to be built
        self.armed = False
        self._build = build
        build.add_build_listener(self._on_event)
        self._registered = True

    def _on_event(self, event: str, name: str, seconds: float) -> None:
        reg = self.registry
        if event == "cache_hit":
            self.cache_hits += 1
            if reg is not None:
                reg.counter("persistent_cache_hits").inc()
            return
        if event != "compile":
            return
        self.compiles += 1
        self.cache_misses += 1
        if reg is not None:
            reg.counter("xla_compiles").inc()
            reg.counter("persistent_cache_misses").inc()
            reg.histogram("xla_compile_secs").observe(seconds)
        if self.armed:
            self.unexpected += 1
            if reg is not None:
                reg.counter("unexpected_recompiles").inc()
            rec = {"kind": "retrace", "compile_secs": round(seconds, 3),
                   "n_unexpected": self.unexpected, "library": name}
            if self.logger is not None:
                try:
                    self.logger.log(rec, force=True)
                except Exception:
                    pass
            print(f"WARNING: unexpected kernel build #{self.unexpected} "
                  f"({name}, {seconds:.2f}s) after warm-up", flush=True)

    def arm(self) -> None:
        """Call once the expected builds are done; later ones are flagged
        as unexpected."""
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def close(self) -> None:
        if self._registered:
            self._build.remove_build_listener(self._on_event)
            self._registered = False


def device_memory(device: torch.device) -> Dict[str, int]:
    """The JAX ``Device.memory_stats`` keys for one card: bytes allocated
    now and at peak (the caching allocator's tensors), the card's total
    memory, and the largest live allocation (a block of the allocator's
    snapshot)."""
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != device.index:
            continue
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "active_allocated":
                largest = max(largest, int(blk.get("size", 0)))
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total), "largest_alloc_size": largest}


class MemoryWatchdog:
    """Per-card memory statistics into gauges and a ``kind="memory"``
    record. ``devices`` are the cards to sample (default: the current
    card, once CUDA is in use)."""

    def __init__(self, registry=None,
                 devices: Optional[Sequence[torch.device]] = None):
        self.registry = registry
        self.devices = devices

    def _devices(self):
        """The cards to sample, each with its index."""
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        devs = [torch.device(d) for d in (self.devices or ["cuda"])]
        return [torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
                for d in devs if d.type == "cuda"]

    def sample(self, logger=None) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for d in self._devices():
            keep = device_memory(d)
            out[str(d.index)] = keep
            if self.registry is not None:
                for k, v in keep.items():
                    self.registry.gauge(f"hbm_{k}", device=d.index).set(v)
        if out and logger is not None:
            worst = max(out.values(),
                        key=lambda s: s.get("bytes_in_use", 0))
            logger.log({"kind": "memory", "n_devices": len(out), **worst},
                       force=True)
        return out


#: tolerated |live − static| / static before a budget cross-check warns
HBM_BUDGET_DRIFT = 0.10


def budget_drift(live_bytes: int, static_bytes: int,
                 tolerance: float = HBM_BUDGET_DRIFT):
    """``(drift_fraction, out_of_band)`` for a live-vs-static byte pair."""
    if static_bytes <= 0:
        return 0.0, False
    drift = abs(int(live_bytes) - int(static_bytes)) / float(static_bytes)
    return drift, drift > tolerance
