"""Parallel training over the mesh (counterpart of ``p2p_tpu/parallel/``):
data parallelism (``dp``), ZeRO state sharding over ``fsdp`` (``rules``),
and the spatial axis (``halo``, ``spatial``: H split over ranks, slice
13b). Temporal parallelism (``temporal``) comes with slice 13b-time,
tensor and pipeline parallelism (``tp``, ``pp`` and the TP rules) with
slice 13c."""

from p2p_tpu_torch.parallel.dp import (DataParallel, make_parallel_eval_step,
                                       make_parallel_train_step,
                                       place_state, replicate_state,
                                       shard_batch, shard_rows)
from p2p_tpu_torch.parallel.rules import (FlatParams, ShardedEMA,
                                          ShardedOptimizer, full_params,
                                          shard_state)

__all__ = ["DataParallel", "FlatParams", "ShardedEMA", "ShardedOptimizer",
           "full_params", "make_parallel_eval_step",
           "make_parallel_train_step", "place_state", "replicate_state",
           "shard_batch", "shard_rows", "shard_state"]
