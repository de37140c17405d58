"""Host-side (NumPy) depth-unit policy.

Port of ``to_meters_np`` and ``stage_depth_np`` from
realsensetracker_tpu/data/depth_units.py: integer frames are raw sensor
units scaled by ``scale``; float frames are already meters.
"""

from __future__ import annotations

import numpy as np


def to_meters_np(depth, scale: float) -> np.ndarray:
    """f32 meters from a depth frame of either convention."""
    a = np.asarray(depth)
    if np.issubdtype(a.dtype, np.integer):
        return a.astype(np.float32) * np.float32(scale)
    return a.astype(np.float32, copy=False)


def stage_depth_np(depth, scale: float) -> tuple[np.ndarray, bool]:
    """(staged array, is_raw) for the device upload path.

    Integer frames whose values fit uint16 stage RAW (half the f32 upload
    bytes, converted on the device); wider or negative integer frames
    convert to f32 meters here -- a bare ``astype(np.uint16)`` would wrap
    them (100000 -> 34464, -1 -> 65535). Floats stage as f32 meters."""
    a = np.asarray(depth)
    if np.issubdtype(a.dtype, np.integer):
        if a.dtype == np.uint16:
            return a, True
        if a.size and (int(a.min()) < 0 or int(a.max()) > 65535):
            return a.astype(np.float32) * np.float32(scale), False
        return a.astype(np.uint16), True
    return a.astype(np.float32, copy=False), False
