"""``--num_devices`` N: ranks, shards and the collectives of the global
batch (JAX ``parallel/``)."""

from .collectives import (agree_max, all_reduce_grads, all_sum, barrier, broadcast_module,
                          broadcast_object, gather_rows, global_mean, global_value,
                          sync_batch_norm)
from .launch import check_devices, free_init_method, spawn_ranks
from .mesh import (World, active, data_rows, global_rows, leave, local_share, make_mesh,
                   rand_rows, row_index, shard_batch, split_sizes, world)
