"""Batched registration and multi-stream tracking, on one device or over a
mesh of ranks."""

from realsensetracker_tpu_torch.parallel.mesh import balanced_mesh, make_mesh  # noqa: F401
from realsensetracker_tpu_torch.parallel.batched import (  # noqa: F401
    register_batch,
    register_batch_chunked,
    register_batch_sharded,
)
from realsensetracker_tpu_torch.parallel.sharded import register_batch_point_sharded  # noqa: F401
from realsensetracker_tpu_torch.parallel.streams import (  # noqa: F401
    MASKED_RGBD_STATS_WIDTH,
    MASKED_STATS_WIDTH,
    RgbdStreamState,
    StreamState,
    StreamStepResult,
    TsdfStreamState,
    blank_streams,
    blank_streams_rgbd,
    blank_tsdf_streams,
    init_streams,
    init_tsdf_streams,
    shard_streams,
    step_streams,
    step_streams_masked,
    step_streams_masked_rgbd,
    step_streams_masked_rgbd_window,
    step_streams_masked_window,
    step_streams_window,
    step_tsdf_streams,
    step_tsdf_streams_masked,
    step_tsdf_streams_masked_window,
    step_tsdf_streams_window,
)
