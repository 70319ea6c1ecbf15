"""Parallel training over the mesh (counterpart of ``p2p_tpu/parallel/``):
data parallelism (``dp``) and ZeRO state sharding over ``fsdp``
(``rules``). Spatial and temporal parallelism (``spatial``, ``halo``,
``temporal``) come with slice 13b, tensor and pipeline parallelism
(``tp``, ``pp`` and the TP rules) with slice 13c."""

from p2p_tpu_torch.parallel.dp import (DataParallel, make_parallel_eval_step,
                                       make_parallel_train_step,
                                       place_state, replicate_state,
                                       shard_batch)
from p2p_tpu_torch.parallel.rules import (FlatParams, ShardedEMA,
                                          ShardedOptimizer, full_params,
                                          shard_state)

__all__ = ["DataParallel", "FlatParams", "ShardedEMA", "ShardedOptimizer",
           "full_params", "make_parallel_eval_step",
           "make_parallel_train_step", "place_state", "replicate_state",
           "shard_batch", "shard_state"]
