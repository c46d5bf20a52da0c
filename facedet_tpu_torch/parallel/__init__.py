"""Multi-device execution on torch.distributed (counterpart of
facedet_tpu/parallel/): the (dp, tile) mesh, sharding plans, the
tile-sharded forward and the round-robin evaluation stream."""
from facedet_tpu_torch.parallel.mesh import create_mesh
from facedet_tpu_torch.parallel.sharding import (
    batch_sharding,
    fsdp_param_shardings,
    tile_sharding,
)

__all__ = ["create_mesh", "batch_sharding", "fsdp_param_shardings", "tile_sharding"]
