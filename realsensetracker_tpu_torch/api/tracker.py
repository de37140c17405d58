"""Public tracking facade: frames in -> poses out.

Port of realsensetracker_tpu/api/tracker.py for methods "projective" and
"keyframe". The other methods raise NotImplementedError naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import torch

from realsensetracker_tpu_torch.api.config import TrackerConfig
from realsensetracker_tpu_torch.data.depth_units import to_meters_np
from realsensetracker_tpu_torch.ops.pyramid import depth_to_meters
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory

# Methods of the JAX facade and the ROADMAP queue 1 item that ports each.
_NOT_PORTED = {
    "model": "item 6 (tracking/frame_to_model)",
    "icp": "items 6-7 (the _CloudTracker methods, align/icp)",
    "gicp": "items 6-7 (the _CloudTracker methods, align/gicp)",
    "rgbd": "item 8 (align/rgbd, tracking/rgbd)",
    "tsdf": "item 10 (mapping/tsdf, tracking/tsdf_tracker)",
}


class Tracker:
    """Streaming depth tracker with selectable registration backend."""

    # Integer (raw u16) depth frames are accepted by every method: scaled by
    # config.depth_scale on the device (keyframe) or on the host (_ingest).
    accepts_raw_depth = True

    def __init__(self, config: TrackerConfig | None = None):
        self.config = config or TrackerConfig()
        method = self.config.method
        if method in _NOT_PORTED:
            raise NotImplementedError(
                f"method={method!r} is not ported yet: ROADMAP queue 1 {_NOT_PORTED[method]}"
            )
        if method == "projective":
            self._impl = FrameToFrameTracker(
                self.config.intrinsics,
                self.config.projective,
                min_inlier_fraction=self.config.min_inlier_fraction,
                map_capacity=self.config.map_capacity,
                device=self.config.device,
            )
        elif method == "keyframe":
            self._impl = KeyframeTracker(
                self.config.intrinsics,
                self.config.projective,
                min_inlier_fraction=self.config.min_inlier_fraction,
                depth_scale=self.config.depth_scale,
                device=self.config.device,
            )
        else:
            raise ValueError(f"unknown tracking method: {method}")

    def _ingest(self, depth):
        """Integer (raw unit) frames -> f32 meters by config.depth_scale,
        unless the impl declares ``accepts_raw_depth`` (KeyframeTracker):
        then the raw frame passes through and converts on the device."""
        if getattr(self._impl, "accepts_raw_depth", False):
            return depth
        if isinstance(depth, torch.Tensor):
            return depth_to_meters(depth, self.config.depth_scale)
        return to_meters_np(depth, self.config.depth_scale)

    def process(self, depth, timestamp: float | None = None):
        """One (H, W) depth frame (float meters or integer raw units) in ->
        FrameResult (projective) or KeyframeResult (keyframe) out."""
        return self._impl.process(self._ingest(depth), timestamp)

    def process_window(self, depths, timestamps=None, window: int = 8):
        """Process a sequence of frames, up to ``window`` frames per host
        transfer (method='keyframe'). Identical results to per-frame
        process(); one result per frame."""
        if self.config.method != "keyframe":
            raise ValueError(
                f"process_window() requires method='keyframe' (got {self.config.method!r})"
            )
        if timestamps is None:
            timestamps = [None] * len(depths)
        results = []
        i = 0
        while i < len(depths):
            # Non-truncating: keyframe events promote in-loop, so a window
            # never re-submits its tail (the bootstrap call consumes only
            # the first frame).
            consumed = self._impl.process_window(
                depths[i : i + window], timestamps[i : i + window],
                pad_to=window, truncate_at_events=False,
            )
            results.extend(consumed)
            i += len(consumed)
        return results

    @property
    def pose(self):
        return self._impl.pose

    @property
    def trajectory(self) -> Trajectory:
        return self._impl.trajectory

    def save_trajectory(self, path: str) -> None:
        self.trajectory.save_tum(path)
