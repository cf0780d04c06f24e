from gigagan_tpu_torch.parallel.dist import (
    all_gather_cat,
    all_reduce_mean_,
    assert_replicated,
    barrier,
    checksum,
    init,
    init_from_env,
    is_initialized,
    is_main,
    local_rank,
    rank,
    world_size,
)

__all__ = ["all_gather_cat", "all_reduce_mean_", "assert_replicated",
           "barrier", "checksum", "init", "init_from_env",
           "is_initialized", "is_main", "local_rank", "rank", "world_size"]
