"""ctypes front-end for the native RSC clip codec (native/src/clip_codec.cpp).

A copy of realsensetracker_tpu/native/clip_io.py on the port's own loader.
"""

from __future__ import annotations

import ctypes

import numpy as np

from realsensetracker_tpu_torch.native import load


def read_clip(path: str):
    from realsensetracker_tpu_torch.data.recorded import Clip
    from realsensetracker_tpu_torch.geometry import camera

    lib = load()
    dims = np.zeros(5, np.int32)
    intr4 = np.zeros(4, np.float32)
    rc = lib.rsc_read_header(
        path.encode(), dims.ctypes.data_as(ctypes.c_void_p),
        intr4.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError(f"{path}: native header read failed ({rc})")
    f_count, h, w, _, has_color = (int(x) for x in dims)
    stamps = np.zeros(f_count, np.float64)
    depths = np.zeros((f_count, h, w), np.float32)
    rc = lib.rsc_read_frames(
        path.encode(), stamps.ctypes.data_as(ctypes.c_void_p),
        depths.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(0),
    )
    if rc != 0:
        raise ValueError(f"{path}: native frame read failed ({rc})")
    colors = None
    if has_color:
        colors = np.zeros((f_count, h, w, 3), np.uint8)
        rc = lib.rsc_read_colors(
            path.encode(), colors.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise ValueError(f"{path}: native color read failed ({rc})")
    intr = camera.Intrinsics(
        fx=float(intr4[0]), fy=float(intr4[1]), cx=float(intr4[2]), cy=float(intr4[3]),
        width=w, height=h,
    )
    return Clip(depths=depths, timestamps=stamps, intrinsics=intr, colors=colors)


def write_clip(path: str, depths, timestamps, intr, colors=None) -> None:
    lib = load()
    depths = np.ascontiguousarray(depths, np.float32)
    stamps = np.ascontiguousarray(timestamps, np.float64)
    f_count, h, w = depths.shape
    intr4 = np.asarray([intr.fx, intr.fy, intr.cx, intr.cy], np.float32)
    if colors is None:
        colors_ptr = ctypes.c_void_p(0)
    else:
        # Same color contract as the Python writer (recorded._as_u8_colors):
        # float [0, 1] scales by 255. A plain uint8 cast would truncate
        # float colors to 0/1 and silently flatten the photometric plane.
        from realsensetracker_tpu_torch.data.recorded import _as_u8_colors

        colors = _as_u8_colors(colors)
        assert colors.shape == (f_count, h, w, 3), colors.shape
        colors_ptr = colors.ctypes.data_as(ctypes.c_void_p)
    rc = lib.rsc_write_clip(
        path.encode(), stamps.ctypes.data_as(ctypes.c_void_p),
        depths.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(f_count), ctypes.c_int32(h), ctypes.c_int32(w),
        intr4.ctypes.data_as(ctypes.c_void_p), colors_ptr,
    )
    if rc != 0:
        raise ValueError(f"{path}: native clip write failed ({rc})")
