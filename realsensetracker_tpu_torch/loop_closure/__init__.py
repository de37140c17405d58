"""Place recognition and geometric verification of loop closures."""

from realsensetracker_tpu_torch.loop_closure.detector import (  # noqa: F401
    KeyframeDatabase,
    global_descriptor,
)
