from .mesh import (DATA_AXIS, all_reduce_sum, batch_mean, batch_sharding,
                   global_batch, global_ranks, global_rows, launched_mesh,
                   make_mesh, mesh_device, replicate_sharding, shard_batch,
                   shard_rows, sum_over_ranks, world_size)
