"""Streaming trackers, the SLAM tracker, checkpoints and trajectories."""

from realsensetracker_tpu_torch.tracking.trajectory import Trajectory  # noqa: F401
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker  # noqa: F401
from realsensetracker_tpu_torch.tracking.frame_to_model import FrameToModelTracker  # noqa: F401
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker  # noqa: F401
from realsensetracker_tpu_torch.tracking.rgbd import RgbdTracker  # noqa: F401
from realsensetracker_tpu_torch.tracking.keyframe_rgbd import RgbdKeyframeTracker  # noqa: F401
from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker  # noqa: F401
