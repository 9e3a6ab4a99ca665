from rfw_tpu_torch.parallel.distributed import (
    broadcast_scene, global_film_mesh, init_distributed,
)
from rfw_tpu_torch.parallel.mesh import film_mesh, render_sample_sharded, shard_rays
