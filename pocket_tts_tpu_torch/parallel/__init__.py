from pocket_tts_tpu_torch.parallel.mesh import (
    gather_params,
    make_mesh,
    shard_batch_tree,
    shard_params,
    state_sharding_spec,
)

__all__ = ["make_mesh", "shard_params", "gather_params", "shard_batch_tree", "state_sharding_spec"]
