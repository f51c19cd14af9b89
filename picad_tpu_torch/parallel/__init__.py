"""Data parallelism over ranks (counterpart of picad_tpu/parallel)."""

from picad_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    global_stats,
    global_sum,
    initialize_distributed,
    is_active,
    launch,
    local_rows,
    put_global_batch,
    rank,
    world_size,
)
