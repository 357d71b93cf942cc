from repro_torch.parallel.sharding import (batch_pspecs, cache_pspecs,
                                           distribute_tree, param_pspecs,
                                           placements, shard_ctx_for_mesh)

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "shard_ctx_for_mesh",
           "placements", "distribute_tree"]
