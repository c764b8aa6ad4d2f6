"""Meshes and sharded training over ``torch.distributed`` (port of
``gpzoo_tpu/parallel``): data parallelism over the minibatch, factor
parallelism over the per-factor state, explicit collectives."""

from gpzoo_tpu_torch.parallel.mesh import (create_mesh, data_parallel_mesh,
                                           hybrid_mesh, initialize_distributed)
from gpzoo_tpu_torch.parallel.sharding import (factor_shardings,
                                               make_sharded_batched_train_step,
                                               put_sharded, replicate,
                                               shard_columns,
                                               shard_factor_params)

__all__ = [
    "create_mesh",
    "data_parallel_mesh",
    "hybrid_mesh",
    "initialize_distributed",
    "put_sharded",
    "replicate",
    "shard_columns",
    "factor_shardings",
    "shard_factor_params",
    "make_sharded_batched_train_step",
]
