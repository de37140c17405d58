"""Public tracking facade: frames in -> poses out.

Port of realsensetracker_tpu/api/tracker.py for method="projective". The
other methods raise NotImplementedError naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import torch

from realsensetracker_tpu_torch.api.config import TrackerConfig
from realsensetracker_tpu_torch.data.depth_units import to_meters_np
from realsensetracker_tpu_torch.ops.pyramid import depth_to_meters
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory

# Methods of the JAX facade and the ROADMAP queue 1 item that ports each.
_NOT_PORTED = {
    "keyframe": "item 5 (tracking/keyframe)",
    "model": "item 6 (tracking/frame_to_model)",
    "icp": "items 6-7 (the _CloudTracker methods, align/icp)",
    "gicp": "items 6-7 (the _CloudTracker methods, align/gicp)",
    "rgbd": "item 8 (align/rgbd, tracking/rgbd)",
    "tsdf": "item 10 (mapping/tsdf, tracking/tsdf_tracker)",
}


class Tracker:
    """Streaming depth tracker with selectable registration backend."""

    def __init__(self, config: TrackerConfig | None = None):
        self.config = config or TrackerConfig()
        method = self.config.method
        if method in _NOT_PORTED:
            raise NotImplementedError(
                f"method={method!r} is not ported yet: ROADMAP queue 1 {_NOT_PORTED[method]}"
            )
        if method != "projective":
            raise ValueError(f"unknown tracking method: {method}")
        self._impl = FrameToFrameTracker(
            self.config.intrinsics,
            self.config.projective,
            min_inlier_fraction=self.config.min_inlier_fraction,
            map_capacity=self.config.map_capacity,
            device=self.config.device,
        )

    def _ingest(self, depth):
        """Integer (raw unit) frames -> f32 meters by config.depth_scale."""
        if isinstance(depth, torch.Tensor):
            return depth_to_meters(depth, self.config.depth_scale)
        return to_meters_np(depth, self.config.depth_scale)

    def process(self, depth, timestamp: float | None = None):
        """One (H, W) depth frame (float meters or integer raw units) in ->
        FrameResult out."""
        return self._impl.process(self._ingest(depth), timestamp)

    @property
    def pose(self):
        return self._impl.pose

    @property
    def trajectory(self) -> Trajectory:
        return self._impl.trajectory

    def save_trajectory(self, path: str) -> None:
        self.trajectory.save_tum(path)
