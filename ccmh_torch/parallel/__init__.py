from ccmh_torch.parallel.mesh import (
    data_parallel_train_step, make_mesh, replicate, shard_batch, sharded_map_eval,
)

__all__ = [
    "make_mesh", "shard_batch", "replicate", "data_parallel_train_step",
    "sharded_map_eval",
]
