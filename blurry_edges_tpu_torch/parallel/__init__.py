"""Data parallelism over processes (``mesh.py``)."""

from .mesh import (Mesh, active_mesh, all_gather, all_reduce, all_reduce_sum,  # noqa: F401
                   any_rank, barrier, data_sharding, gather_rows, in_rank, launch, make_mesh,
                   mean_gradients, replicate, shard_batch)
