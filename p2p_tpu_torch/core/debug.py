"""Numerical-debug guards (counterpart of ``p2p_tpu/core/debug.py``).

- :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``,
  so the backward op that first makes a NaN raises with the trace of the
  forward op behind it (a debugging tool, slow);
- :func:`check_finite`: a host-side guard over a tree of tensors and
  numbers, wired into the train loop behind ``cfg.debug.check_finite``:
  a ``kind="nonfinite"`` record into the telemetry stream (so the evidence
  survives the crash), then a raise. The fence-free variant is
  :func:`p2p_tpu_torch.obs.taps.nan_sentinel`.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def tree_leaves(tree: Any, prefix: str = ""):
    """``(path, leaf)`` of every non-None leaf of a nested dict, list or
    tuple, the path's keys joined by ``/`` as the JAX package names
    them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def find_nonfinite(tree: Any) -> List[Dict[str, int]]:
    """One ``{"leaf": path, "nan": n, "inf": n}`` entry per floating leaf
    of ``tree`` that holds a non-finite value. Fetches every leaf to the
    host (a fence): use it behind a debug flag or on host values."""
    out = []
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            arr = leaf.detach().float().cpu().numpy() \
                if leaf.is_floating_point() else leaf.cpu().numpy()
        else:
            arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) \
                and not np.all(np.isfinite(arr)):
            out.append({"leaf": path, "nan": int(np.isnan(arr).sum()),
                        "inf": int(np.isinf(arr).sum())})
    return out


def check_finite(tree: Any, name: str = "tree", registry=None,
                 raise_: bool = True) -> List[Dict[str, int]]:
    """Guard a tree: a ``kind="nonfinite"`` record for its non-finite
    leaves on ``registry`` (anything with ``.record``), then
    ``FloatingPointError`` naming the first (unless ``raise_`` is False).
    Returns the findings."""
    findings = find_nonfinite(tree)
    if not findings:
        return findings
    if registry is not None:
        registry.record({"kind": "nonfinite", "name": name,
                         "leaves": findings}, force=True)
    if raise_:
        f = findings[0]
        raise FloatingPointError(
            f"non-finite values in {name}:{f['leaf']} "
            f"(nan={f['nan']}, inf={f['inf']})")
    return findings
