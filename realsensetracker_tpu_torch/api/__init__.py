"""Public API: the Tracker facade and its configuration, the HTTP tracking
service and its cross-session batching executor."""

from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig, SessionDesyncError  # noqa: F401
from realsensetracker_tpu_torch.api.config import AlignConfig, GicpConfig, ReplayConfig, TrackerConfig  # noqa: F401
from realsensetracker_tpu_torch.api.service import TrackingService, get_json, post_frame, post_window  # noqa: F401
from realsensetracker_tpu_torch.api.tracker import Tracker  # noqa: F401
