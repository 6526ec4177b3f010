"""More than one process: a torch process group with one process per device.
Port of segland_tpu/dist (its 1-D 'data' mesh); no tensor or spatial
sharding, as the reference runs DDP + synchronised BatchNorm (engine.py)."""

from .process import (all_gather, all_reduce_max, all_reduce_sum, barrier, destroy,
                      init_from_env, is_initialized, is_main, rank, shard_rows, stats_group, world)

__all__ = ["all_gather", "all_reduce_max", "all_reduce_sum", "barrier", "destroy",
           "init_from_env", "is_initialized", "is_main", "rank", "shard_rows", "stats_group",
           "world"]
