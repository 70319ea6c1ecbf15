"""Run manifest (counterpart of ``p2p_tpu/obs/manifest.py``, whole): the
provenance record written once at a run's start: the whole config and its
hash (runs compare by one string), the git sha of the checkout, the dtype
policy and a backend block. On the card the block holds the card's name
and power limit (as ``nvidia-smi --query-gpu=name,power.limit`` reads
them) and the torch and CUDA versions; on the CPU its platform is
``cpu``. Written to a temporary file renamed into place.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Union

import torch


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def config_hash(cfg) -> str:
    """Stable short hash of a (nested, frozen) Config dataclass."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def card_name_and_power(index: int = 0) -> Dict[str, Optional[str]]:
    """``name`` and ``power_limit`` of card ``index`` from ``nvidia-smi``
    (None each where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
        name, _, power = out.stdout.strip().partition(", ")
        if out.returncode == 0 and name:
            return {"name": name, "power_limit": power or None}
    except Exception:
        pass
    return {"name": None, "power_limit": None}


def backend_block(device: Union[str, torch.device, None] = None
                  ) -> Dict[str, Any]:
    """What the run computes on: the card's name, power limit and the
    torch and CUDA versions for a CUDA ``device``; ``platform: cpu``
    otherwise."""
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    if device.type != "cuda":
        return {"platform": "cpu", "torch": torch.__version__}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    smi = card_name_and_power(index)
    return {"platform": "gpu",
            "device_kind": smi["name"] or torch.cuda.get_device_name(index),
            "power_limit": smi["power_limit"],
            "torch": torch.__version__, "cuda": torch.version.cuda}


def build_manifest(cfg, device: Union[str, torch.device, None] = None,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    backend = backend_block(device)
    man: Dict[str, Any] = {
        "kind": "manifest",
        "name": getattr(cfg, "name", None),
        "config_hash": config_hash(cfg),
        "config": dataclasses.asdict(cfg),
        "git_sha": _git_sha(),
        "argv": list(sys.argv),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "torch_version": torch.__version__,
        "backend": backend,
        "device_kind": backend.get("device_kind", "cpu"),
        "n_devices": 1,
        "process_index": 0,
        "process_count": 1,
        "mesh_shape": None,
        "dtype_policy": {
            "compute": ("bfloat16" if cfg.train.mixed_precision
                        else "float32"),
            "params": "float32",
            "adam_moments": cfg.optim.moment_dtype or "float32",
            "input_pipeline": ("uint8" if cfg.data.uint8_pipeline
                               else "float32"),
        },
    }
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str, cfg,
                   device: Union[str, torch.device, None] = None,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    man = build_manifest(cfg, device=device, extra=extra)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, default=str)
    os.replace(tmp, path)
    return man
