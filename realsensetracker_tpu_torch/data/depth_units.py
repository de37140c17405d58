"""Host-side (NumPy) depth-unit policy.

Port of ``to_meters_np`` from realsensetracker_tpu/data/depth_units.py:
integer frames are raw sensor units scaled by ``scale``; float frames are
already meters.
"""

from __future__ import annotations

import numpy as np


def to_meters_np(depth, scale: float) -> np.ndarray:
    """f32 meters from a depth frame of either convention."""
    a = np.asarray(depth)
    if np.issubdtype(a.dtype, np.integer):
        return a.astype(np.float32) * np.float32(scale)
    return a.astype(np.float32, copy=False)
