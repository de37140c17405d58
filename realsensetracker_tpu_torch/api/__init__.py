"""Public API: the Tracker facade and its configuration."""

from realsensetracker_tpu_torch.api.config import AlignConfig, GicpConfig, TrackerConfig  # noqa: F401
from realsensetracker_tpu_torch.api.tracker import Tracker  # noqa: F401
