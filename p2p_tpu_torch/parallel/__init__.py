"""Parallel training over the mesh (counterpart of ``p2p_tpu/parallel/``):
data parallelism (``dp``), ZeRO state sharding over ``fsdp`` and the TP
tables (``rules``), the spatial axis (``halo``, ``spatial``: H split over
ranks, slice 13b), the time axis (``temporal``: a clip's frames split over
ranks), tensor parallelism over ``model`` (``tp``: Megatron channel
shards) and pipeline parallelism over ``pipe`` (``pp``: GPipe over the
generator's residual trunk)."""

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
