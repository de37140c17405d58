"""ctypes front-end for the native voxel-hash world model
(native/src/voxel_map.cpp): unbounded host-side CloudAccumulator.

A copy of realsensetracker_tpu/native/voxel_map.py on the port's own loader.
"""

from __future__ import annotations

import ctypes

import numpy as np

from realsensetracker_tpu_torch.native import load


class NativeVoxelMap:
    """Unbounded voxel-hash map (ref CloudAccumulator, rs_replay_app.cpp:
    76-129): truncation indexing, first-insert-wins."""

    def __init__(self, voxel_size: float = 0.05):
        self._lib = load()
        self._handle = ctypes.c_void_p(self._lib.voxel_map_create(
            ctypes.c_float(voxel_size)))

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.voxel_map_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    def add_cloud(self, transform, points, mask=None) -> None:
        """Insert points (world = transform @ points). mask (N,) bool keeps
        only valid rows -- the framework's clouds are capacity-padded, and
        feeding padded zero rows would permanently claim voxel (0,0,0)
        under first-insert-wins; non-finite rows are always dropped (the
        native int32 cast of a NaN coordinate is undefined behavior)."""
        T = np.ascontiguousarray(transform, np.float32)
        pts = np.asarray(points, np.float32)
        assert T.shape == (4, 4) and pts.ndim == 2 and pts.shape[1] == 3
        keep = np.isfinite(pts).all(axis=1)
        if mask is not None:
            keep &= np.asarray(mask, bool)
        pts = np.ascontiguousarray(pts[keep])
        if pts.shape[0] == 0:
            return
        self._lib.voxel_map_add(
            self._handle,
            T.ctypes.data_as(ctypes.c_void_p),
            pts.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(pts.shape[0]),
        )

    def __len__(self) -> int:
        return int(self._lib.voxel_map_size(self._handle))

    def extract(self, capacity: int | None = None) -> np.ndarray:
        cap = len(self) if capacity is None else capacity
        out = np.zeros((cap, 3), np.float32)
        n = self._lib.voxel_map_extract(
            self._handle, out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap)
        )
        return out[:n]
