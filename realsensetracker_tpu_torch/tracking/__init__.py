"""Streaming trackers and trajectories."""

from realsensetracker_tpu_torch.tracking.trajectory import Trajectory  # noqa: F401
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker  # noqa: F401
