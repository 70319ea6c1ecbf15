"""Profiling and timing helpers (counterpart of
``p2p_tpu/utils/profiling.py``): the same names as the JAX module, which
live in :mod:`p2p_tpu_torch.obs`."""

from __future__ import annotations

from p2p_tpu_torch.obs.spans import annotate, trace
from p2p_tpu_torch.obs.timing import StepTimer, measure_rtt

__all__ = ["StepTimer", "annotate", "measure_rtt", "trace"]
