from stableanimator_tpu_torch.parallel.mesh import (
    make_mesh,
    replicated,
    batch_sharding,
    video_sharding,
    shard_params,
    shard_optimizer_state,
)
