"""Inference serving (counterpart of ``p2p_tpu/serve``).

- :class:`.engine.InferenceEngine`: bucket-batched generator serving on
  the card, with zero-downtime weight swap
  (:meth:`.engine.InferenceEngine.swap_state`);
- :func:`.engine.engine_from_checkpoint`: G (and net_c) restored alone
  from the port's checkpoints, then an engine;
- :mod:`.frontend`: the dispatch / decode-retry / quarantine loop behind
  the directory and HTTP frontends, with bucket-occupancy accounting;
- :mod:`.batcher`: continuous cross-request batching;
- :mod:`.tenancy`: several checkpoints resident in one process, each
  hot-swappable under traffic;
- :mod:`.server`: the stdlib HTTP frontend (``POST /v1/{model}/translate``,
  ``/healthz``, ``/metrics``, ``POST /admin/reload``) with graceful drain;
- :mod:`.io`: bucket padding and chunking, the threaded image writer,
  PNG response bodies.
"""

from p2p_tpu_torch.serve.batcher import ContinuousBatcher
from p2p_tpu_torch.serve.engine import (
    InferenceEngine,
    ServeStats,
    engine_from_checkpoint,
)
from p2p_tpu_torch.serve.frontend import DispatchLoop, default_buckets
from p2p_tpu_torch.serve.io import (
    AsyncImageWriter,
    chunk_batch,
    encode_png,
    pad_batch,
    pick_bucket,
)
from p2p_tpu_torch.serve.tenancy import (
    HotSwapRejected,
    ModelRegistry,
    Tenant,
    checkpoint_dir,
)

__all__ = [
    "AsyncImageWriter",
    "ContinuousBatcher",
    "DispatchLoop",
    "HotSwapRejected",
    "InferenceEngine",
    "ModelRegistry",
    "ServeStats",
    "Tenant",
    "checkpoint_dir",
    "chunk_batch",
    "default_buckets",
    "encode_png",
    "engine_from_checkpoint",
    "pad_batch",
    "pick_bucket",
]
