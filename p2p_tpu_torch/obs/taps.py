"""Step telemetry taps (counterpart of ``p2p_tpu/obs/taps.py``, whole):
NaN/Inf sentinels and gradient-norm scalars.

- :func:`nan_sentinel` counts the non-finite entries of each float leaf
  of a tree (the step's metrics) on the device, copies the (L, 2) int32
  counts ``non_blocking`` into a pinned host buffer and records a CUDA
  event behind the copy: no fence. The counts are read one call later
  (or at :func:`read_sentinels`), after ``event.synchronize()``, which
  waits only for the work queued before that event, never for what was
  queued since; nothing calls ``.item()``. On the CPU the counts are
  exact at once and are read the same one call later.
- :func:`grad_norm_taps` adds the global norm of each gradient list to a
  metrics dict as ``grad_norm_<key>`` (a 0-d f32 tensor on the device,
  fetched with the metrics).

A non-zero count increments ``nonfinite_events{tag=...}`` on the process
registry, prints a warning and calls every handler registered with
:func:`add_sentinel_handler` with a ``kind="sentinel"`` event (the trainer
registers one that writes it into its metrics stream).
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from p2p_tpu_torch.core.debug import tree_leaves

_handlers: List[Callable[[Dict[str, Any]], None]] = []
_handlers_lock = threading.Lock()
# queued counts: (event or None, counts tensor, host rows, names, tag)
_pending: collections.deque = collections.deque()
_pending_lock = threading.Lock()


def add_sentinel_handler(fn: Callable[[Dict[str, Any]], None]) -> None:
    with _handlers_lock:
        if fn not in _handlers:
            _handlers.append(fn)


def remove_sentinel_handler(fn) -> None:
    with _handlers_lock:
        if fn in _handlers:
            _handlers.remove(fn)


def _on_counts(counts: np.ndarray, *, tag: str, names: Sequence[str]
               ) -> None:
    if counts.sum() == 0:
        return
    from p2p_tpu_torch.obs.registry import get_registry

    bad = {names[i]: {"nan": int(counts[i, 0]), "inf": int(counts[i, 1])}
           for i in range(len(names)) if counts[i].sum()}
    event = {"kind": "sentinel", "tag": tag,
             "nan": int(counts[:, 0].sum()), "inf": int(counts[:, 1].sum()),
             "leaves": bad}
    get_registry().counter("nonfinite_events", tag=tag).inc()
    print(f"WARNING: non-finite values in {tag}: {bad}", flush=True)
    with _handlers_lock:
        handlers = list(_handlers)
    for h in handlers:
        try:
            h(event)
        except Exception as e:  # a broken handler must not kill the run
            print(f"WARNING: sentinel handler failed: {e!r}", flush=True)


def host_copy(t: torch.Tensor):
    """``(host tensor, event)``: a card tensor copied ``non_blocking`` into
    a pinned host buffer, with a CUDA event recorded behind the copy (read
    the buffer after ``event.synchronize()``); a CPU tensor as it is, with
    no event. No host sync either way."""
    if not t.is_cuda:
        return t, None
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return buf, event


def queue_sentinel(tree: Any, tag: str = "tree") -> None:
    """Queue the (nan, inf) counts of ``tree``'s float leaves without a
    host sync: tensor leaves are counted where they lie (one ``isnan`` and
    one ``isinf`` sum each), a card's counts go to a pinned buffer behind
    a recorded event; Python numbers are counted on the host."""
    dev_rows, host = [], []
    for name, leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            dev_rows.append((name, torch.stack([
                torch.isnan(leaf).sum(dtype=torch.int32),
                torch.isinf(leaf).sum(dtype=torch.int32)])))
        elif isinstance(leaf, float):
            host.append((name, (int(math.isnan(leaf)),
                                int(math.isinf(leaf)))))
    names = [n for n, _ in dev_rows] + [n for n, _ in host]
    if not names:
        return
    counts, event = (host_copy(torch.stack([r for _, r in dev_rows]))
                     if dev_rows else (None, None))
    host_rows = np.asarray([r for _, r in host], np.int32).reshape(-1, 2)
    with _pending_lock:
        _pending.append((event, counts, host_rows, tuple(names), tag))


def read_sentinels() -> None:
    """Read every queued count (each after its event) and report the
    non-zero ones."""
    while True:
        with _pending_lock:
            if not _pending:
                return
            event, counts, host_rows, names, tag = _pending.popleft()
        if event is not None:
            event.synchronize()
        rows = (counts.numpy() if counts is not None
                else np.zeros((0, 2), np.int32))
        _on_counts(np.concatenate([rows, host_rows]), tag=tag, names=names)


def nan_sentinel(tree: Any, tag: str = "tree") -> None:
    """Read the counts queued by earlier calls, then queue ``tree``'s:
    each step's counts are read one step later."""
    read_sentinels()
    queue_sentinel(tree, tag)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (0-d f32; 0 for none)."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def grad_norm_taps(metrics: Dict[str, torch.Tensor],
                   **grads: Optional[Sequence[torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """Add ``grad_norm_<key>`` (the global norm of each gradient list) to
    ``metrics``: ``grad_norm_taps(metrics, g=grads_g, d=grads_d)``."""
    for key, tensors in grads.items():
        if tensors is not None:
            metrics[f"grad_norm_{key}"] = global_norm(tensors).to(
                torch.float32)
    return metrics
