"""Dense mapping: the TSDF volume (integrate, raycast, surface extraction),
its x-slab layout over a device mesh, marching-tetrahedra meshes and the
submap atlas."""

from realsensetracker_tpu_torch.mapping.mesh import (  # noqa: F401
    TriangleMesh,
    extract_mesh,
)
from realsensetracker_tpu_torch.mapping.sharded import (  # noqa: F401
    init_volume_sharded,
    shard_volume,
    volume_sharding,
)
from realsensetracker_tpu_torch.mapping.tsdf import (  # noqa: F401
    TsdfConfig,
    TsdfVolume,
    extract_surface,
    extract_surface_oriented,
    init_volume,
    integrate,
    raycast,
    raycast_coarse_to_fine,
    render_model_depth,
)
