"""ctypes front-end for the native PNG16 decoder (native/src/png16.cpp).

A copy of realsensetracker_tpu/native/png_io.py on the port's own loader.
"""

from __future__ import annotations

import ctypes

import numpy as np

from realsensetracker_tpu_torch.native import load


def read_png16(path: str) -> np.ndarray:
    """Decode an 8/16-bit grayscale PNG to a uint16 (H, W) array."""
    lib = load()
    dims = np.zeros(4, np.int32)
    rc = lib.png16_read_header(path.encode(), dims.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: PNG header read failed ({rc})")
    w, h = int(dims[0]), int(dims[1])
    out = np.zeros((h, w), np.uint16)
    rc = lib.png16_decode(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: PNG decode failed ({rc})")
    return out


def read_png16_batch(
    paths: list[str], height: int, width: int, scale: float | None = None
) -> np.ndarray:
    """Decode many same-sized 16-bit PNGs with the native thread pool
    (png16_decode_batch, one worker per hardware thread).

    Returns (N, H, W) uint16, or float32 (= u16 / scale, e.g. 5000 for TUM
    meters) when `scale` is given. The data-loader hot path for TUM replay:
    Python never touches pixel bytes.
    """
    lib = load()
    n = len(paths)
    joined = "\n".join(paths).encode()
    if scale is None:
        out = np.zeros((n, height, width), np.uint16)
        rc = lib.png16_decode_batch(
            joined, ctypes.c_int32(n), ctypes.c_int32(height),
            ctypes.c_int32(width), out.ctypes.data_as(ctypes.c_void_p),
            None, ctypes.c_float(0.0),
        )
    else:
        out = np.zeros((n, height, width), np.float32)
        rc = lib.png16_decode_batch(
            joined, ctypes.c_int32(n), ctypes.c_int32(height),
            ctypes.c_int32(width), None,
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_float(scale),
        )
    if rc != 0:
        # INT32_MIN = path-list parse failure (distinct from per-file codes).
        bad = paths[-rc - 1] if 0 < -rc <= n else "<path list parse failure>"
        raise ValueError(f"batch PNG decode failed (rc={rc}, file={bad})")
    return out
